#!/usr/bin/env python3
"""Where the time of the port's eval step or train step goes, on one CUDA card.

    python3 scripts/profile_torch_eval.py [--step eval|train] [--fixdim 2500 4096]
        [--batch_size 8] [--steps 10] [--trace_dir build/profiles]
        [--mode deformpathomic | --mode path --path_arch transmil | --mode omic
         | --mode pathomic | --mode pathomic_original | --mode mcat | --mode cmta]
        [--attn_dim 1] [--fusion_type pofusion] [--coattn_fusion bilinear]
        [--task_type survival] [--compute_dtype bfloat16|float32]

Builds the model (deformpathomic by default, with ``--attn_dim 1`` its 1-D
attention, with ``--fusion_type`` its fusion; or TransMIL, ABMIL or another
mode, mcat and cmta with ``--coattn_fusion``; seeded weights, bf16 unless
``--compute_dtype`` says otherwise, synthetic batch already on the card),
warms up, then runs ``--steps`` eval steps (or train steps:
forward with dropout, backward, gradient modulation, Adam) under
``torch.profiler``.  Prints one JSON line per fixdim with the step time (host
clock around synchronised steps), the kernel time and kernel launches per
step and the kernel time's share of that step, the device's busy share of the
profiled window (union of kernel intervals over the window), the device
time per step of the kernels that take the most, grouped by name, and that of
each of the port's own kernels (``sml_tpu_torch/csrc``) the step launched,
with their sum.  The Chrome
trace goes to ``<trace_dir>/profile_<model>_<step>_<fixdim>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sml_tpu_torch.config import Config  # noqa: E402
from sml_tpu_torch.data.loader import Loader, build_datasets  # noqa: E402
from sml_tpu_torch.models.factory import define_net, define_optimizer  # noqa: E402
from sml_tpu_torch.ops.common import DropoutRNG  # noqa: E402
from sml_tpu_torch.train.evaluate import batch_to_device  # noqa: E402
from sml_tpu_torch.train.state import TrainState  # noqa: E402
from sml_tpu_torch.train.steps import make_eval_step, make_train_step  # noqa: E402


# the port's own kernels (sml_tpu_torch/csrc), by name
PORT_KERNEL = re.compile(r"\b(cpb_bias_\w+|attn_(fwd|bwd)_\w+|idct_kernel"
                         r"|colour_kernel)\b")


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


def _make_step(kind: str, config: Config):
    """A no-argument callable running one eval or train step on one batch."""
    dev = torch.device("cuda")
    model = define_net(config, dev, train=kind == "train")
    loader = Loader(build_datasets(config, "Test"), config.batch_size)
    batch = batch_to_device(config, next(iter(loader)), dev)
    if kind == "eval":
        step = make_eval_step(config, model)
        return lambda: step(batch)
    batch.pop("sample_mask")
    optimizer, scheduler = define_optimizer(config, model, 8)
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(0, dev))
    step = make_train_step(config, model)
    return lambda: step(state, batch)


def profile_one(kind: str, fixdim: int, batch_size: int, steps: int, card: str,
                trace_dir: str, mode: str = "deformpathomic", path_arch: str = "abmil",
                attn_dim: int = 2, fusion_type: str = "concat",
                coattn_fusion: str = "concat", task_type: str = "diag2021",
                compute_dtype: str = "bfloat16") -> dict:
    config = Config(dataset="synthetic", synthetic_size=4 * batch_size,
                    batch_size=batch_size, compute_dtype=compute_dtype, fixdim=fixdim,
                    mode=mode, path_arch=path_arch, attn_dim=attn_dim,
                    return_vgrid=attn_dim == 2, fusion_type=fusion_type,
                    coattn_fusion=coattn_fusion, task_type=task_type)
    run = _make_step(kind, config)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    name = mode if mode != "path" else path_arch
    if mode == "deformpathomic" and (attn_dim, fusion_type) != (2, "concat"):
        name = f"{mode}_{attn_dim}d_{fusion_type}"
    if mode in ("mcat", "cmta"):
        name = f"{mode}_{coattn_fusion}_{compute_dtype}"
    prof.export_chrome_trace(os.path.join(trace_dir, f"profile_{name}_{kind}_{fixdim}.json"))
    busy, start, end = _busy_us(prof)

    # kernels only: an aten:: row's device time repeats that of its kernels
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    device_total = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    per_step = lambda e: {"name": e.key[:90], "calls_per_step": e.count / steps,
                          "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
    port = [per_step(e) for e in rows if PORT_KERNEL.search(e.key)]
    # the profiler slows the host, so the busy share of its window understates the
    # device's share of an unprofiled step; device_ms / step_ms gives that one
    return {"model": name, "step": kind, "fixdim": fixdim, "batch": batch_size,
            "dtype": compute_dtype,
            "card": card,
            "step_ms": step_ms, "device_ms_per_step": device_total,
            "device_share_of_step": device_total / step_ms,
            "kernels_per_step": sum(e.count for e in rows) / steps,
            "window_ms_per_step": (end - start) / 1e3 / steps,
            "device_busy_share": busy / (end - start), "top": [per_step(e) for e in rows[:20]],
            "port_kernels": port,
            "port_kernels_ms_per_step": sum(e["device_ms_per_step"] for e in port)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--step", choices=("eval", "train"), default="eval")
    parser.add_argument("--fixdim", type=int, nargs="+", default=[2500, 4096])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--trace_dir", default="build/profiles")
    parser.add_argument("--mode", choices=("deformpathomic", "path", "omic", "pathomic",
                                           "pathomic_original", "mcat", "cmta"),
                        default="deformpathomic")
    parser.add_argument("--path_arch", default="abmil", help="transmil with --mode path")
    parser.add_argument("--attn_dim", type=int, choices=(1, 2), default=2)
    parser.add_argument("--fusion_type", default="concat")
    parser.add_argument("--coattn_fusion", default="concat", help="mcat / cmta fusion")
    parser.add_argument("--task_type", default="diag2021")
    parser.add_argument("--compute_dtype", choices=("bfloat16", "float32"),
                        default="bfloat16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device available", file=sys.stderr)
        return 1
    # f32 products and convolutions in full f32, as the port's CLIs set them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for fixdim in args.fixdim:
        print(json.dumps(profile_one(args.step, fixdim, args.batch_size, args.steps, card,
                                     args.trace_dir, args.mode, args.path_arch,
                                     args.attn_dim, args.fusion_type, args.coattn_fusion,
                                     args.task_type, args.compute_dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
