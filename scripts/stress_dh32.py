#!/usr/bin/env python3
"""Repeat the f32 dh = 32 attention kernels at the cmta-kernels phase's shapes and
count every launch whose result differs from the first, on one CUDA card.

    python3 scripts/stress_dh32.py [--rounds 100] [--load] [--poison] [--side-stream]

The cases are those of ``chip_smoke.py``'s cmta-kernels phase (``dh32_cases``),
drawn from its seeded generator in its order.  Each case's forward and
backward are launched once and held against their plain versions at the
phase's tolerances, then ``--rounds`` more times in the phase's order, each
result compared bit for bit with the first.  ``--load`` keeps a side stream
busy with f32 matrix products while the kernels run, so that they share the
SMs with other blocks; ``--poison`` fills blocks of the caching allocator of
the sizes the wrappers allocate (outputs and scratch) with NaN just before
each launch, so that a read of memory a kernel did not write shows;
``--side-stream`` launches the kernels on a stream other than the default
one.  Prints one JSON line per case (mismatching launches, the largest
difference from the first result, the error against the plain version) and a
summary line; exits non-zero on any mismatch or error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sml_tpu_torch.ops.kernels import (_build, deform_attention_bwd,  # noqa: E402
                                       deform_attention_bwd_plain, deform_attention_fwd,
                                       deform_attention_fwd_plain)
from sml_tpu_torch.ops.kernels.deform_attn import _library  # noqa: E402


def poison(shapes) -> None:
    """NaN-filled blocks of these sizes, freed, for the next allocations to take."""
    held = [torch.full(s, float("nan"), device="cuda") for s in shapes]
    del held


def diff(got, first) -> float:
    """The largest |got - first| over a tree, NaN counted as inf."""
    return max(torch.nan_to_num((a - b).abs(), nan=float("inf")).max().item()
               for a, b in zip(got, first))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--side-stream", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stress_dh32: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("deform_attn", "deform_attn_bwd"))
    fwd_lib, bwd_lib = _library("deform_attn"), _library("deform_attn_bwd")
    bg, dh, f32 = cs.BG, cs.CMTA_DH, torch.float32
    g = torch.Generator(device="cuda").manual_seed(cs.DH32_SEED)
    data = []
    for chain, n, j in cs.dh32_cases():
        q = torch.randn(bg, n, dh, device="cuda", generator=g) * dh ** -0.5
        k, v = torch.randn(2, bg, j, dh, device="cuda", generator=g)
        dout = torch.randn(bg, n, dh, device="cuda", generator=g) * 1e-2
        data.append((chain, n, j, q, k, v, dout))

    side = torch.cuda.Stream()
    run = torch.cuda.Stream() if args.side_stream else torch.cuda.current_stream()
    big = torch.randn(4096, 4096, device="cuda") if args.load else None

    def launch(q, k, v, dout, n, j):
        if args.load:
            with torch.cuda.stream(side):
                for _ in range(2):
                    torch.mm(big, big)
        with torch.cuda.stream(run):
            if args.poison:
                poison([q.shape, (fwd_lib.deform_attn_fwd_work(0, bg, n, j, dh),)])
            out = (deform_attention_fwd(q, k, v),)
            if args.poison:
                n_work = bwd_lib.deform_attn_bwd_work(0, bg, n, j, dh)
                poison([q.shape, k.shape, v.shape, (2, bg, n)] + ([(n_work,)] if n_work else []))
            return {"fwd": out, "bwd": deform_attention_bwd(q, k, v, None, dout)[:3]}

    t0 = time.time()
    first, report = [], []
    for chain, n, j, q, k, v, dout in data:
        res = launch(q, k, v, dout, n, j)
        run.synchronize()
        fwd = cs._compare_fwd(res["fwd"][0], deform_attention_fwd_plain(q, k, v))
        bwd = cs._compare_grads(res["bwd"], deform_attention_bwd_plain(q, k, v, None, dout)[:3],
                                cs.GRAD_RTOL[f32])
        first.append(res)
        report.append({"chain": chain, "n": n, "j": j, "fwd_ok": fwd["ok"],
                       "fwd_err": fwd["max_abs_err"], "bwd_ok": bwd["ok"],
                       "bwd_err": bwd["max_abs_err"], "fwd_mismatch": 0, "bwd_mismatch": 0,
                       "fwd_max_diff": 0.0, "bwd_max_diff": 0.0})
    for _ in range(args.rounds):
        for (chain, n, j, q, k, v, dout), ref, rep in zip(data, first, report):
            res = launch(q, k, v, dout, n, j)
            run.synchronize()
            for p in ("fwd", "bwd"):
                if not all(torch.equal(a, b) for a, b in zip(res[p], ref[p])):
                    rep[f"{p}_mismatch"] += 1
                    rep[f"{p}_max_diff"] = max(rep[f"{p}_max_diff"], diff(res[p], ref[p]))
    torch.cuda.synchronize()
    for rep in report:
        print(json.dumps(rep), flush=True)
    bad = sum(r["fwd_mismatch"] + r["bwd_mismatch"] for r in report)
    wrong = [r["chain"] for r in report if not (r["fwd_ok"] and r["bwd_ok"])]
    print(json.dumps({"rounds": args.rounds, "load": args.load, "poison": args.poison,
                      "side_stream": args.side_stream, "launches": 2 * args.rounds * len(data),
                      "mismatching": bad, "wrong_first": wrong,
                      "seconds": round(time.time() - t0, 1)}), flush=True)
    return 0 if not bad and not wrong else 1


if __name__ == "__main__":
    sys.exit(main())
