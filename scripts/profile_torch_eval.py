#!/usr/bin/env python3
"""Where the time of the port's eval step goes, on one CUDA card.

    python3 scripts/profile_torch_eval.py [--fixdim 2500 4096] [--batch_size 8]
        [--steps 10] [--trace_dir build/profiles]

Builds the deformpathomic serving model (seeded weights, bf16, synthetic
batch already on the card), warms up, then runs ``--steps`` eval steps under
``torch.profiler``.  Prints one JSON line per fixdim with the step time (host
clock around synchronised steps), the kernel time and kernel launches per
step and the kernel time's share of that step, the device's busy share of the
profiled window (union of kernel intervals over the window), and the device
time per step of the kernels that take the most, grouped by name.  The Chrome
trace goes to ``<trace_dir>/profile_eval_<fixdim>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sml_tpu_torch.config import Config  # noqa: E402
from sml_tpu_torch.data.loader import Loader, build_datasets  # noqa: E402
from sml_tpu_torch.models.factory import define_net  # noqa: E402
from sml_tpu_torch.train.evaluate import batch_to_device  # noqa: E402
from sml_tpu_torch.train.steps import make_eval_step  # noqa: E402


def _busy_us(prof) -> tuple[float, float, float]:
    """(union of device kernel intervals, window start, window end) in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, spans[0][0], max(e for _, e in spans)


def profile_one(fixdim: int, batch_size: int, steps: int, card: str,
                trace_dir: str) -> dict:
    config = Config(dataset="synthetic", synthetic_size=4 * batch_size,
                    batch_size=batch_size, compute_dtype="bfloat16", fixdim=fixdim)
    model = define_net(config, "cuda")
    step = make_eval_step(config, model)
    loader = Loader(build_datasets(config, "Test"), batch_size)
    batch = batch_to_device(config, next(iter(loader)), torch.device("cuda"))
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"profile_eval_{fixdim}.json"))
    busy, start, end = _busy_us(prof)

    # kernels only: an aten:: row's device time repeats that of its kernels
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    device_total = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = [{"name": e.key[:90], "calls_per_step": e.count / steps,
            "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
           for e in rows[:20]]
    # the profiler slows the host, so the busy share of its window understates the
    # device's share of an unprofiled step; device_ms / step_ms gives that one
    return {"fixdim": fixdim, "batch": batch_size, "dtype": "bfloat16", "card": card,
            "step_ms": step_ms, "device_ms_per_step": device_total,
            "device_share_of_step": device_total / step_ms,
            "kernels_per_step": sum(e.count for e in rows) / steps,
            "window_ms_per_step": (end - start) / 1e3 / steps,
            "device_busy_share": busy / (end - start), "top": top}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fixdim", type=int, nargs="+", default=[2500, 4096])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--trace_dir", default="build/profiles")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for fixdim in args.fixdim:
        print(json.dumps(profile_one(fixdim, args.batch_size, args.steps, card,
                                     args.trace_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
