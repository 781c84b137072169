#!/usr/bin/env python3
"""Device time of the attention backward's two kernels, form by form, on one CUDA card.

    python3 scripts/profile_attn_bwd.py [--tag NAME] [--iters 10]

Builds ``csrc/deform_attn_bwd.cu`` and prints, for each bf16 kernel (``*_tc``)
of the build, its registers and spill stores from the ptxas log; then, for
each form at the main path's shapes (BG=64, bf16: the bias form without and
with dropout at S2500 / S4096, the bias-less Nystrom chains 1 and 3), the
largest gradient error against the plain version relative to that tensor's
max, and the device time per launch of the rows and keys kernels under
``torch.profiler`` (mean of ``--iters`` launches).  One line per item,
prefixed with ``--tag``, so that runs of two trees can be told apart.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sml_tpu_torch.ops.kernels import (_build, deform_attention_bwd,  # noqa: E402
                                       deform_attention_bwd_plain, philox_keep_mask)

BG, DH, SEED = 64, 64, 7
# name: (N, J, bias, keep_prob)
CASES = {"bias_s2500": (2500, 144, True, 1.0), "bias_drop_s2500": (2500, 144, True, 0.9),
         "bias_s4096": (4096, 256, True, 1.0), "bias_drop_s4096": (4096, 256, True, 0.9),
         "ch3_s2500": (256, 2560, False, 1.0), "ch1_s2500": (2560, 256, False, 1.0),
         "ch3_s4096": (256, 4352, False, 1.0), "ch1_s4096": (4352, 256, False, 1.0)}


def ptxas_lines(tag: str) -> None:
    """Registers and spill stores of every tensor-core kernel instantiation."""
    name, spill = None, "?"
    for line in _build.build_log("deform_attn_bwd").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(rows|keys)_tcILb(\d)ELb(\d)ELb(\d)", m.group(1))
            name = ("%s_tc bias=%s span=%s drop=%s" % k.groups()) if k else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(tag, "ptxas", name, "registers", m.group(1), "spill_stores", spill, flush=True)
            name = None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default=".")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(args.tag, "card", card, flush=True)
    _build.build(["deform_attn_bwd"])
    ptxas_lines(args.tag)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for name, (n, j, has_bias, keep_prob) in CASES.items():
        rn = lambda *s, scale=1.0: (torch.randn(*s, device="cuda", generator=g) * scale).to(bf)
        q, k, v = rn(BG, n, DH, scale=DH ** -0.5), rn(BG, j, DH), rn(BG, j, DH)
        dout = rn(BG, n, DH, scale=1e-2)
        bias = rn(BG, n, j) if has_bias else None
        run = lambda: deform_attention_bwd(q, k, v, bias, dout, keep_prob, SEED)
        got = run()
        keep = (philox_keep_mask(SEED, BG, n, j, keep_prob, device="cuda")
                if keep_prob < 1 else None)
        want = deform_attention_bwd_plain(q, k, v, bias, dout, keep, keep_prob)
        err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, want) if a is not None)
        del want, keep
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            m = re.search(r"(rows|keys)_(tc|kernel)", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and m:
                ms[m.group(0)] = round(e.self_device_time_total / 1e3 / args.iters, 4)
        print(args.tag, name, json.dumps({"max_rel_err": err, "ms": ms,
                                          "total_ms": round(sum(ms.values()), 4)}), flush=True)
        del q, k, v, dout, bias, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
