#!/usr/bin/env python3
"""Device time of the CPB kernels, forward and backward, per dtype and shape,
on one CUDA card.

    python3 scripts/profile_cpb_bwd.py [--tag NAME] [--csrc DIR] [--iters 20]

Builds ``cpb_bias.cu`` and ``cpb_bias_bwd.cu`` from ``--csrc`` (default: the
package's ``sml_tpu_torch/csrc``; a directory holding variants of the sources
and their shared headers, such as another commit's, compares them in the same
call) into ``build/profile_cpb/<tag>/``, prints each kernel instantiation's
registers and spill stores from the ptxas logs, then, at the main path's
shapes (BG = 64, dm = 32; S2500: 50 x 50 queries, J = 144; S4096: 64 x 64, J =
256), f32 and bf16, for the forward (``"pass": "fwd"``) and the backward
(``"bwd"``): the largest error against the plain version (the forward's
largest absolute error, the backward's largest relative L2 error of a
gradient), whether a second launch repeats the first bit for bit, and the
median device time of one launch over ``--iters`` CUDA-event timings.  One
JSON line per item, prefixed with ``--tag``, so that runs of two sources can
be told apart.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sml_tpu_torch.ops.kernels import (_build, cpb_bias, cpb_bias_bwd,  # noqa: E402
                                       cpb_bias_bwd_plain, cpb_bias_plain)

SOURCES = ("cpb_bias", "cpb_bias_bwd")
KERNEL = re.compile(r"(cpb_bias_fwd_tc|cpb_bias_bwd_tc|cpb_bias_bwd_kernel|cpb_bias_kernel)"
                    r"I(\w*?)Li(\d+)E")

BG, DM = 64, 32
SHAPES = {2500: (50, 144), 4096: (64, 256)}       # fixdim -> (query side, J)


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def ptxas(tag: str) -> None:
    """Registers and spill stores of every kernel instantiation."""
    name = None
    for line in "\n".join(_build.build_log(s) for s in SOURCES).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = KERNEL.search(m.group(1))
            name = (f"{k.group(1)}{'<' + k.group(2) + '>' if k.group(2) else ''} "
                    f"dm={k.group(3)}" if k else m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(json.dumps({"tag": tag, "kernel": name, "registers": int(m.group(1)),
                              "spill_stores": spill}), flush=True)
            name = None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--csrc", default=str(_build.CSRC))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cpb_bwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.CSRC = Path(args.csrc).resolve()
    _build.BUILD_DIR = ROOT / "build" / "profile_cpb" / args.tag
    _build.build(SOURCES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": smi, "csrc": str(_build.CSRC)}), flush=True)
    ptxas(args.tag)
    g = torch.Generator(device="cuda").manual_seed(0)
    for fixdim, (side, j) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            def rn(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda", generator=g) * scale
            inputs = [rn(BG, side * j, scale=0.7), rn(BG, side, j, scale=0.7)] + [
                w.to(dtype) for w in (rn(DM, scale=0.7), rn(DM, scale=0.7), rn(DM, scale=0.1),
                                      rn(DM, DM, scale=DM ** -0.5), rn(DM, scale=0.1),
                                      rn(DM, 1, scale=DM ** -0.5))]
            b2 = rn(1, scale=0.1).to(dtype)
            bias = cpb_bias(*inputs, b2)
            again = cpb_bias(*inputs, b2)
            print(json.dumps({"tag": args.tag, "pass": "fwd", "fixdim": fixdim,
                              "dtype": str(dtype).split(".")[-1],
                              "max_abs_err": (bias.float() - cpb_bias_plain(*inputs, b2).float()
                                              ).abs().max().item(),
                              "repeats": torch.equal(bias, again),
                              "ms": _time_ms(lambda: cpb_bias(*inputs, b2), args.iters)}),
                  flush=True)
            del bias, again
            dbias = (rn(BG, side, side * j) * 1e-3).to(dtype)
            got = cpb_bias_bwd(*inputs, dbias)
            again = cpb_bias_bwd(*inputs, dbias)
            want = cpb_bias_bwd_plain(*inputs, dbias)
            rel = max(((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
                      for a, b in zip(got, want))
            print(json.dumps({"tag": args.tag, "pass": "bwd", "fixdim": fixdim,
                              "dtype": str(dtype).split(".")[-1],
                              "max_rel_l2_err": rel,
                              "repeats": all(torch.equal(a, b) for a, b in zip(got, again)),
                              "ms": _time_ms(lambda: cpb_bias_bwd(*inputs, dbias), args.iters)}),
                  flush=True)
            del got, again, want, inputs, dbias
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
