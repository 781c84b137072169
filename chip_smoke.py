#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name for it;
2. build    nvcc builds of every kernel source, with the compiler's register
            and spill report;
3. kernels  each CUDA kernel at the serving path's shapes (BG = 8 bags x 8
            offset groups; 2500-patch bags: 50x50 queries, J = 144; 4096-patch
            bags: 64x64, J = 256; dm = 32, dh = 64), in f32 and bf16, held
            against its plain PyTorch version on the same inputs, and timed
            beside the plain version, one PyTorch library call where there is
            one, and the least time the card could take for the same work;
4. slice    the port's serving entry point, ``sml_tpu_torch.inference.main``,
            on synthetic data (B = 8, bf16, seeded weights) at 2500 and 4096
            patches per bag: both kernels must be launched once per branch and
            batch, every output finite, and one batch's outputs must agree with
            the same model run through the plain versions; then the eval step's
            time per batch.

Then it prints the ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network, imports nothing of JAX, and exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

# published H100 SXM peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BG, DM, DH = 64, 32, 64
SHAPES = {2500: (50, 144), 4096: (64, 256)}            # fixdim -> (query side, J)
MAIN_FIXDIM = 2500                                     # config/config_mine.yaml fixdim
# |kernel - plain| <= atol + rtol * |plain|: f32 sums run in another order;
# bf16 outputs are both rounded from f32 and may differ by one bf16 ulp
KERNEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
SLICE_TOL = (3e-2, 2e-2)    # bf16 model through kernels vs through plain versions


def _line(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
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


def _compare(got: torch.Tensor, want: torch.Tensor, tol) -> dict:
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs())) and bool(torch.isfinite(got).all())
    return {"max_abs_err": err.max().item(),
            "max_rel_err": (err.max() / want.abs().max().clamp_min(1e-30)).item(),
            "atol": atol, "rtol": rtol, "ok": ok}


def _bound(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    _line("device", **card)
    return card


def phase_build() -> None:
    from sml_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    report = {name: [ln.split("info    : ")[-1] for ln in _build.build_log(name).splitlines()
                     if "registers" in ln or "spill" in ln]
              for name in _build.SOURCES}
    _line("build", seconds=round(time.perf_counter() - t0, 2), per_source=seconds,
          ptxas=report)


def _cpb_inputs(h: int, j: int, dtype: torch.dtype, g: torch.Generator):
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    dx, dy = rn(BG, h * j, scale=0.7), rn(BG, h, j, scale=0.7)
    weights = [rn(DM, scale=0.7), rn(DM, scale=0.7), rn(DM, scale=0.1),
               rn(DM, DM, scale=DM ** -0.5), rn(DM, scale=0.1),
               rn(DM, 1, scale=DM ** -0.5), rn(1, scale=0.1)]
    return [dx, dy] + [w.to(dtype) for w in weights]


def phase_kernels() -> dict:
    """Kernel vs plain at the main path's shapes; returns the JSON entries."""
    import torch.nn.functional as F

    from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_plain, deform_attention_fwd,
                                           deform_attention_fwd_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    entries, failures = {}, []
    for fixdim, (side, j) in SHAPES.items():
        n = side * side
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.finfo(dtype).bits // 8
            args = _cpb_inputs(side, j, dtype, g)
            bias = cpb_bias(*args)
            torch.cuda.synchronize()
            pairs = BG * n * j
            cpb_bytes = 4 * (BG * side * j * 2) + size * (DM * DM + 5 * DM + 1) + size * pairs
            bound_ms, bound_by = _bound(cpb_bytes, pairs * (2 * DM * DM + 6 * DM + 1), dtype)
            cpb = {"name": "cpb_bias", **_compare(bias, cpb_bias_plain(*args),
                                                  KERNEL_TOL[dtype]),
                   "ms": _time_ms(lambda: cpb_bias(*args)),
                   "plain_ms": _time_ms(lambda: cpb_bias_plain(*args), iters=5),
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

            q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(dtype)
            k = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            v = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            fbias = bias.reshape(BG, n, j)
            out = deform_attention_fwd(q, k, v, fbias)
            torch.cuda.synchronize()
            attn_bytes = size * (2 * BG * n * DH + 2 * BG * j * DH + BG * n * j)
            bound_ms, bound_by = _bound(attn_bytes, pairs * (4 * DH + 7), dtype)
            attn = {"name": "deform_attention_fwd",
                    **_compare(out, deform_attention_fwd_plain(q, k, v, fbias),
                               KERNEL_TOL[dtype]),
                    "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias)),
                    "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(q, k, v, fbias),
                                         iters=5),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=fbias, scale=1.0))}
            for e in (cpb, attn):
                e.update(fixdim=fixdim, dtype=str(dtype).split(".")[-1], bg=BG, n=n, j=j)
                _line("kernels", **e)
                if not e["ok"]:
                    failures.append(f"{e['name']} fixdim={fixdim} {dtype}")
                if fixdim == MAIN_FIXDIM and dtype == torch.bfloat16:
                    entries[e["name"]] = e
            del args, bias, q, k, v, out
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    return entries


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in tree.values())


def phase_slice(fixdim: int, card: dict) -> dict:
    """The serving path at ``fixdim``; returns the kernels' launch counts."""
    from sml_tpu_torch import inference
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, model_inputs
    from sml_tpu_torch.ops import deformable
    from sml_tpu_torch.ops.kernels import (KERNELS, cpb_bias_plain,
                                           deform_attention_fwd_plain, reset_launch_counts)
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_eval_step

    flags = {"dataset": "synthetic", "synthetic_size": 64, "batch_size": 8,
             "compute_dtype": "bfloat16", "fixdim": fixdim}
    argv = [f"--{k}={v}" for k, v in flags.items()] + ["--device=cuda"]

    # 1) the entry point a user calls, with the launch counts around it
    reset_launch_counts()
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = inference.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    printed = captured.getvalue().strip()
    print(printed, flush=True)
    metrics = ast.literal_eval(printed.split("test metrics: ")[-1])
    config = Config(**flags)
    loader = Loader(build_datasets(config, "Test"), config.batch_size)
    expected = 2 * len(loader)                     # one launch per branch and batch
    if rc != 0 or any(c != expected for c in launches.values()):
        raise AssertionError(f"launches {launches}, expected {expected} each (rc={rc})")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")

    # 2) one batch through the kernels and through the plain versions
    model = define_net(config, "cuda")
    step = make_eval_step(config, model)
    batch = batch_to_device(config, next(iter(loader)), torch.device("cuda"))
    with torch.inference_mode():
        out = model(**model_inputs(config, batch))
    res = step(batch)
    with mock.patch.object(deformable, "cpb_bias", cpb_bias_plain), \
            mock.patch.object(deformable, "deform_attention_fwd", deform_attention_fwd_plain):
        with torch.inference_mode():
            out_plain = model(**model_inputs(config, batch))
        res_plain = step(batch)
    if not (_finite(out) and _finite(res)):
        raise AssertionError("non-finite model outputs")
    checks = {k: _compare(out[k], out_plain[k], SLICE_TOL)
              for k in ("logits", "logits_tumor", "logits_immune", "features")}
    checks.update({f"step_{k}": _compare(res[k], res_plain[k], SLICE_TOL) for k in res})
    bad = [k for k, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels vs plain versions disagree on {bad}: {checks}")

    # 3) time per batch: the eval step on a device-resident batch, and the transfer
    host_batch = next(iter(loader))
    h2d_ms = statistics.median(_host_ms(lambda: batch_to_device(
        config, host_batch, torch.device("cuda"))) for _ in range(5))
    torch.cuda.reset_peak_memory_stats()
    step_ms = statistics.median(_host_ms(lambda: step(batch)) for _ in range(10))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _line("slice", fixdim=fixdim, batch=config.batch_size, dtype="bfloat16",
          metrics=metrics, launches=launches, expected_launches=expected,
          entry_point_wall_s=round(wall_s, 2),
          max_abs_err={k: c["max_abs_err"] for k, c in checks.items()},
          tol=SLICE_TOL, eval_step_ms=step_ms,
          bags_per_s=config.batch_size / (step_ms / 1e3), h2d_ms=h2d_ms,
          peak_mem_gb=peak_gb, card=card["nvidia_smi"])
    return launches


def _host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    phase_build()
    entries = phase_kernels()
    launches = {}
    for fixdim in SHAPES:
        counts = phase_slice(fixdim, card)
        if fixdim == MAIN_FIXDIM:
            launches = counts
    sources = {"cpb_bias": ("sml_tpu_torch/csrc/cpb_bias.cu",
                            "sml_tpu/ops/pallas/deform_attn.py:335"),
               "deform_attention_fwd": ("sml_tpu_torch/csrc/deform_attn.cu",
                                        "sml_tpu/ops/pallas/deform_attn.py:1016")}
    kernels = []
    for name, (source, replaces) in sources.items():
        e = entries[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                        "shape": f"BG={BG} N={e['n']} J={e['j']} bf16"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
