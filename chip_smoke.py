#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name for it;
2. build    nvcc builds of every kernel source, with the compiler's register
            and spill report;
3. kernels  each CUDA kernel (CPB forward and backward, attention forward
            without and with Philox dropout at keep 0.9, attention backward
            without and with dropout) at the main path's shapes (BG = 8 bags x
            8 offset groups; 2500-patch bags: 50x50 queries, J = 144;
            4096-patch bags: 64x64, J = 256; dm = 32, dh = 64), in f32 and
            bf16, held against its plain PyTorch version on the same inputs,
            and timed beside the plain version, one PyTorch library call where
            there is one, and the least time the card could take for the same
            work; the dropout mask's kept share must be within 5 sigma of 0.9;
4. slice    the port's serving entry point, ``sml_tpu_torch.inference.main``,
            on synthetic data (B = 8, bf16, seeded weights) at 2500 and 4096
            patches per bag: both forward kernels must be launched once per
            branch and batch (no backward, no dropout), every output finite,
            and one batch's outputs must agree with the same model run through
            the plain versions; then the eval step's time per batch;
5. train    the port's train entry point, ``sml_tpu_torch.main.main``, for one
            epoch at 2500 patches (64 synthetic bags, B = 8, bf16: 8 train
            steps, then Val and Test): each of the four kernels launched
            exactly twice per train step (the eval launches counted apart),
            finite loss terms, and a ``best_modal.npz`` that
            ``inference.main --weights`` reads back; one train step's loss and
            every parameter gradient through the kernels against the plain
            versions; then the train step's time, bags/s and peak memory.

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
# gradients: |kernel - plain| <= rtol * max|plain| per tensor (sums in another order;
# bf16 outputs both rounded from f32)
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# CPB backward: ||kernel - plain|| <= 1e-2 ||plain|| per gradient.  The ReLU
# derivative decisions at a ~ 0 and z2 ~ 0 differ between the kernel's fused
# multiply-adds and the plain version's separate operations, and each flip moves
# dz1 by a whole w1 dz2: in f32 at S2500 both lie ~2.5e-4 (d_dx, scale 8e-3) and
# ~1.5e-3 (dw1, scale 1.8) from a float64 evaluation, so no per-element bound holds.
CPB_GRAD_L2 = 1e-2
# one bf16 train step through the kernels vs through the plain versions, same
# batch and generators: |loss terms| within 2e-2, and every parameter gradient
# within 5e-2 relative L2 (bf16 roundings at other points in the two paths),
# gradients under 1e-3 of the largest norm relative to that floor
TRAIN_LOSS_TOL, TRAIN_GRAD_L2 = 2e-2, 5e-2
KEEP_PROB, SEED = 0.9, 20240611       # the attention dropout of the training path


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


def _compare_grads(got, want, rtol: float, l2: bool = False) -> dict:
    """Gradients held per tensor at ``rtol`` of its scale, |kernel - plain| <=
    rtol * max|plain| + 1e-6, or with ``l2`` at ||kernel - plain|| <= rtol *
    ||plain|| (see CPB_GRAD_L2)."""
    worst, worst_l2, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        ok &= bool(torch.isfinite(a).all()) and (
            rel <= rtol if l2 else err <= rtol * b.abs().max().item() + 1e-6)
        worst, worst_l2 = max(worst, err), max(worst_l2, rel)
    return {"max_abs_err": worst, "max_rel_l2_err": worst_l2, "rtol": rtol,
            "metric": "l2" if l2 else "of_scale", "ok": ok}


def _sdpa_bwd_ms(q, k, v, bias, dout):
    """Backward of F.scaled_dot_product_attention with a bias that needs a
    gradient, or None when PyTorch does not run it."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
    try:
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
        torch.autograd.grad(out, leaves, dout, retain_graph=True)
    except RuntimeError:
        return None
    return _time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
                    iters=5)


def phase_kernels() -> dict:
    """Every kernel vs its plain version at the main path's shapes; returns
    the JSON entries of the main shape (S2500, bf16) by name."""
    import torch.nn.functional as F

    from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                           cpb_bias_plain, deform_attention_bwd,
                                           deform_attention_bwd_plain,
                                           deform_attention_fwd,
                                           deform_attention_fwd_plain, philox_keep_mask)

    g = torch.Generator(device="cuda").manual_seed(0)
    entries, failures = {}, []
    for fixdim, (side, j) in SHAPES.items():
        n = side * side
        slow_iters = 2 if fixdim == MAIN_FIXDIM else 1     # the plain CPB versions
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.finfo(dtype).bits // 8
            pairs = BG * n * j
            args = _cpb_inputs(side, j, dtype, g)
            bias = cpb_bias(*args)
            torch.cuda.synchronize()
            w_bytes = size * (DM * DM + 5 * DM + 1)
            table_bytes = 4 * (BG * side * j * 2)            # dx and dy, f32
            bound_ms, bound_by = _bound(table_bytes + w_bytes + size * pairs,
                                        pairs * (2 * DM * DM + 6 * DM + 1), dtype)
            rows = [{"name": "cpb_bias", **_compare(bias, cpb_bias_plain(*args),
                                                    KERNEL_TOL[dtype]),
                     "ms": _time_ms(lambda: cpb_bias(*args)),
                     "plain_ms": _time_ms(lambda: cpb_bias_plain(*args), iters=5),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]

            dbias = (torch.randn(BG, side, side * j, device="cuda", generator=g)
                     * 1e-3).to(dtype)
            got = cpb_bias_bwd(*args[:8], dbias)
            torch.cuda.synchronize()
            bound_ms, bound_by = _bound(table_bytes * 2 + w_bytes * 2 + size * pairs,
                                        pairs * (6 * DM * DM + 16 * DM), dtype)
            rows.append({"name": "cpb_bias_bwd",
                         **_compare_grads(got, cpb_bias_bwd_plain(*args[:8], dbias),
                                          CPB_GRAD_L2, l2=True),
                         "ms": _time_ms(lambda: cpb_bias_bwd(*args[:8], dbias)),
                         "plain_ms": _time_ms(lambda: cpb_bias_bwd_plain(*args[:8], dbias),
                                              iters=slow_iters, warmup=1),
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
            del got, dbias

            q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(dtype)
            k = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            v = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(dtype)
            fbias = bias.reshape(BG, n, j)
            qkv_bytes = size * (2 * BG * n * DH + 2 * BG * j * DH)
            bound_ms, bound_by = _bound(qkv_bytes + size * pairs, pairs * (4 * DH + 7), dtype)
            out = deform_attention_fwd(q, k, v, fbias)
            torch.cuda.synchronize()
            rows.append({"name": "deform_attention_fwd",
                         **_compare(out, deform_attention_fwd_plain(q, k, v, fbias),
                                    KERNEL_TOL[dtype]),
                         "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias)),
                         "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(q, k, v, fbias),
                                              iters=5),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=fbias, scale=1.0))})

            keep = philox_keep_mask(SEED, BG, n, j, KEEP_PROB, device="cuda")
            share = keep.float().mean().item()
            sigma = math.sqrt(KEEP_PROB * (1 - KEEP_PROB) / keep.numel())
            out = deform_attention_fwd(q, k, v, fbias, KEEP_PROB, SEED)
            torch.cuda.synchronize()
            cmp = _compare(out, deform_attention_fwd_plain(q, k, v, fbias, keep, KEEP_PROB),
                           KERNEL_TOL[dtype])
            cmp["kept_share"], cmp["kept_share_sigmas"] = share, (share - KEEP_PROB) / sigma
            cmp["ok"] &= abs(share - KEEP_PROB) < 5 * sigma
            rows.append({"name": "deform_attention_fwd_dropout", **cmp,
                         "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias,
                                                                     KEEP_PROB, SEED)),
                         "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(
                             q, k, v, fbias, philox_keep_mask(SEED, BG, n, j, KEEP_PROB,
                                                              device="cuda"), KEEP_PROB),
                             iters=5),
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

            # backward: q, k, v, bias, dout read once; dq, dk, dv, dbias written once
            bound_ms, bound_by = _bound(2 * qkv_bytes + 2 * size * pairs,
                                        pairs * 10 * DH, dtype)
            for keep_prob in (1.0, KEEP_PROB):
                mask = None if keep_prob == 1.0 else keep
                got = deform_attention_bwd(q, k, v, fbias, dout, keep_prob, SEED)
                torch.cuda.synchronize()
                rows.append({
                    "name": "deform_attention_bwd", "keep_prob": keep_prob,
                    **_compare_grads(got, deform_attention_bwd_plain(
                        q, k, v, fbias, dout, mask, keep_prob), GRAD_RTOL[dtype]),
                    "ms": _time_ms(lambda: deform_attention_bwd(q, k, v, fbias, dout,
                                                                keep_prob, SEED)),
                    "plain_ms": _time_ms(lambda: deform_attention_bwd_plain(
                        q, k, v, fbias, dout, mask, keep_prob), iters=5),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": (_sdpa_bwd_ms(q, k, v, fbias, dout) if keep_prob == 1.0
                                   else None)})
                del got
            for e in rows:
                e.update(fixdim=fixdim, dtype=str(dtype).split(".")[-1], bg=BG, n=n, j=j)
                _line("kernels", **e)
                if not e["ok"]:
                    failures.append(f"{e['name']} fixdim={fixdim} {dtype}")
                main = fixdim == MAIN_FIXDIM and dtype == torch.bfloat16
                if main and e.get("keep_prob", KEEP_PROB) == KEEP_PROB:
                    entries[e["name"]] = e
            del args, bias, q, k, v, dout, out, keep, fbias
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    return entries


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in tree.values())


@contextlib.contextmanager
def _plain_kernels():
    """Route the autograd Functions of the model through the plain versions:
    the four wrappers they call are swapped in their modules, and the plain
    attention draws its dropout mask with ``philox_keep_mask`` on the same seed."""
    import importlib

    cpb = importlib.import_module("sml_tpu_torch.ops.kernels.cpb_bias")
    attn = importlib.import_module("sml_tpu_torch.ops.kernels.deform_attn")
    from sml_tpu_torch.ops.kernels import philox_keep_mask

    def keep(q, k, keep_prob, seed):
        if keep_prob >= 1.0:
            return None
        return philox_keep_mask(seed, q.shape[0], q.shape[1], k.shape[1], keep_prob,
                                device=q.device)

    def fwd(q, k, v, bias, keep_prob=1.0, seed=0):
        return attn.deform_attention_fwd_plain(q, k, v, bias, keep(q, k, keep_prob, seed),
                                               keep_prob)

    def bwd(q, k, v, bias, dout, keep_prob=1.0, seed=0):
        return attn.deform_attention_bwd_plain(q, k, v, bias, dout,
                                               keep(q, k, keep_prob, seed), keep_prob)

    with mock.patch.object(cpb, "cpb_bias", cpb.cpb_bias_plain), \
            mock.patch.object(cpb, "cpb_bias_bwd", cpb.cpb_bias_bwd_plain), \
            mock.patch.object(attn, "deform_attention_fwd", fwd), \
            mock.patch.object(attn, "deform_attention_bwd", bwd):
        yield


def phase_slice(fixdim: int, card: dict) -> dict:
    """The serving path at ``fixdim``; returns the kernels' launch counts."""
    from sml_tpu_torch import inference
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, model_inputs
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
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
    launches = launch_counts()
    printed = captured.getvalue().strip()
    print(printed, flush=True)
    metrics = ast.literal_eval(printed.split("test metrics: ")[-1])
    config = Config(**flags)
    loader = Loader(build_datasets(config, "Test"), config.batch_size)
    expected = 2 * len(loader)                     # one launch per branch and batch
    want = {"cpb_bias": expected, "deform_attention_fwd": expected, "cpb_bias_bwd": 0,
            "deform_attention_bwd": 0, "deform_attention_fwd_dropout": 0}
    if rc != 0 or launches != want:
        raise AssertionError(f"launches {launches}, expected {want} (rc={rc})")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")

    # 2) one batch through the kernels and through the plain versions
    model = define_net(config, "cuda")
    step = make_eval_step(config, model)
    batch = batch_to_device(config, next(iter(loader)), torch.device("cuda"))
    with torch.inference_mode():
        out = model(**model_inputs(config, batch))
    res = step(batch)
    with _plain_kernels():
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


def _grad_snapshot(grad_step, model, batch, seed: int):
    """(metrics, {name: grad}) of one grad step with fresh generators from ``seed``."""
    from sml_tpu_torch.ops.common import DropoutRNG

    metrics = grad_step(batch, DropoutRNG.from_seed(seed, "cuda"))
    return ({k: v.float().item() for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def phase_train(card: dict) -> dict:
    """The training path at S2500 through ``sml_tpu_torch.main``; returns the
    kernels' launch counts of that run."""
    import tempfile

    import numpy as np

    from sml_tpu_torch import inference
    from sml_tpu_torch import main as train_main
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sml_tpu_torch.train import loop
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_grad_step, make_train_step

    flags = {"dataset": "synthetic", "synthetic_size": 64, "fixdim": MAIN_FIXDIM,
             "batch_size": 8, "compute_dtype": "bfloat16", "epochs": 1}
    config = Config(**flags)
    steps = len(Loader(build_datasets(config, "Train"), config.batch_size, drop_last=True))
    eval_counts = []

    def counted_evaluate(*args, **kwargs):
        before = launch_counts()
        result = evaluate(*args, **kwargs)
        after = launch_counts()
        eval_counts.append({k: after[k] - before[k] for k in after})
        return result

    evaluate = loop.evaluate
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ([f"--{k}={v}" for k, v in flags.items()]
                + [f"--checkpoints={ckpt}", "--device=cuda"])
        reset_launch_counts()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured), \
                mock.patch.object(loop, "evaluate", counted_evaluate):
            rc = train_main.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        total = launch_counts()
        printed = captured.getvalue()
        print(printed.strip(), flush=True)
        train_m = ast.literal_eval(printed.split(" train=")[1].splitlines()[0])
        eval_l = {k: sum(c[k] for c in eval_counts) for k in total}
        train_l = {k: total[k] - eval_l[k] for k in total}
        want = {k: 2 * steps for k in ("cpb_bias", "cpb_bias_bwd", "deform_attention_fwd",
                                       "deform_attention_bwd",
                                       "deform_attention_fwd_dropout")}
        if rc != 0 or train_l != want:
            raise AssertionError(f"train-step launches {train_l}, expected {want} (rc={rc})")
        if eval_l["cpb_bias_bwd"] or eval_l["deform_attention_bwd"] or \
                eval_l["deform_attention_fwd_dropout"]:
            raise AssertionError(f"eval launched a training kernel: {eval_l}")
        if set(train_m) != {"loss", "loss3", "batch_sim_loss"} or \
                not all(math.isfinite(v) for v in train_m.values()):
            raise AssertionError(f"train metrics {train_m}")
        weights = f"{ckpt}/best_modal.npz"
        with contextlib.redirect_stdout(io.StringIO()) as served:
            rc = inference.main([f"--{k}={v}" for k, v in flags.items() if k != "epochs"]
                                + [f"--weights={weights}", "--device=cuda"])
        served = ast.literal_eval(served.getvalue().split("test metrics: ")[-1])
        if rc != 0 or not all(math.isfinite(v) for v in served.values()):
            raise AssertionError(f"inference --weights best_modal.npz: rc={rc} {served}")
        n_leaves = len(np.load(weights).files)

    # one train step's loss and gradients, through the kernels and the plain versions
    dev = torch.device("cuda")
    model = define_net(config, dev, train=True)
    grad_step = make_grad_step(config, model)
    batch = next(iter(Loader(build_datasets(config, "Train"), config.batch_size,
                             shuffle=True, drop_last=True, seed=config.seed)))
    batch.pop("sample_mask")
    batch = batch_to_device(config, batch, dev)
    m_k, g_k = _grad_snapshot(grad_step, model, batch, seed=7)
    with _plain_kernels():
        m_p, g_p = _grad_snapshot(grad_step, model, batch, seed=7)
    loss_err = {k: abs(m_k[k] - m_p[k]) for k in m_k}
    # a gradient under 1e-3 of the largest is held against that floor: the CPB's
    # b2 shifts every softmax row, so its true gradient is 0 and both paths
    # return the rounding residue of sum_j dbias over all pairs
    floor = 1e-3 * max(g.norm().item() for g in g_p.values())
    rel = {n: ((g_k[n] - g_p[n]).norm().item() / max(g_p[n].norm().item(), floor))
           for n in g_k}
    worst = max(rel, key=rel.get)
    top = dict(sorted(rel.items(), key=lambda kv: -kv[1])[:5])
    ok = (all(e <= TRAIN_LOSS_TOL for e in loss_err.values())
          and all(r <= TRAIN_GRAD_L2 for r in rel.values())
          and all(bool(torch.isfinite(g).all()) for g in g_k.values()))

    # time per train step on a device-resident batch (optimizer step included)
    from sml_tpu_torch.models.factory import define_optimizer
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.train.state import TrainState

    optimizer, scheduler = define_optimizer(config, model, steps)
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(1, dev))
    train_step = make_train_step(config, model)
    for _ in range(2):
        train_step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    step_ms = statistics.median(_host_ms(lambda: train_step(state, batch))
                                for _ in range(10))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _line("train", fixdim=MAIN_FIXDIM, batch=config.batch_size, dtype="bfloat16",
          steps=steps, train_metrics=train_m, served_metrics=served, weight_leaves=n_leaves,
          launches_total=total, launches_train_steps=train_l, launches_eval=eval_l,
          entry_point_wall_s=round(wall_s, 2), loss_kernel=m_k, loss_plain=m_p,
          loss_abs_err=loss_err, loss_tol=TRAIN_LOSS_TOL,
          grad_rel_l2_top5=top, grad_floor=floor, grad_tol=TRAIN_GRAD_L2,
          grads_compared=len(rel), ok=ok, train_step_ms=step_ms,
          bags_per_s=config.batch_size / (step_ms / 1e3), peak_mem_gb=peak_gb,
          card=card["nvidia_smi"])
    if not ok:
        raise AssertionError(f"train step through kernels vs plain versions: loss "
                             f"{loss_err}, worst gradient {worst} {rel[worst]}")
    return total


def _host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


PALLAS = "sml_tpu/ops/pallas/deform_attn.py"
JSON_KERNELS = (   # (entry name, source, replaces, launch-count key)
    ("cpb_bias", "sml_tpu_torch/csrc/cpb_bias.cu", f"{PALLAS}:335", "cpb_bias"),
    ("cpb_bias_bwd", "sml_tpu_torch/csrc/cpb_bias_bwd.cu", f"{PALLAS}:587",
     "cpb_bias_bwd"),
    ("deform_attention_fwd", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:1016",
     "deform_attention_fwd_eval"),
    ("deform_attention_fwd_dropout", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:877",
     "deform_attention_fwd_dropout"),
    ("deform_attention_bwd", "sml_tpu_torch/csrc/deform_attn_bwd.cu", f"{PALLAS}:1044",
     "deform_attention_bwd"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    phase_build()
    entries = phase_kernels()
    serving = {fixdim: phase_slice(fixdim, card) for fixdim in SHAPES}
    launches = phase_train(card)
    # the train entry point's run: forward launches split into eval form and dropout
    launches["deform_attention_fwd_eval"] = (launches["deform_attention_fwd"]
                                             - launches["deform_attention_fwd_dropout"])
    kernels = []
    for name, source, replaces, count in JSON_KERNELS:
        e = entries[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[count],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                        "launches_serving_s2500": serving[MAIN_FIXDIM].get(name, 0),
                        "shape": f"BG={BG} N={e['n']} J={e['j']} bf16"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
