#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name for it;
2. build    nvcc builds of every kernel source, with the compiler's register
            and spill report of every kernel, the f32 dh = 64 forward's
            ``attn_fwd_tf32_64`` and backward's ``attn_bwd_rows_tf32_64`` /
            ``attn_bwd_keys_tf32_64`` and the f32 CPB forward's
            ``cpb_bias_fwd_tf32`` and backward's ``cpb_bias_bwd_tf32`` among
            them
            (a spill fails the run);
3. ragged   the attention forward and backward in all eight forms, and the
            f32 bias beside bf16 q, k, v (its dbias at the f32 bound), at N =
            100 and J = 20 / 72 / 37 (tails of a row tile, a key tile and a
            16-key step; J not a multiple of 8, J odd), then the forms with a
            bias at J = 38 / 39 / 41 / 42 / 43 and at N = 65 (one row past a
            row tile), J = 37 / 72, so that every residue of J mod 8 meets the
            staged bias tile's row shifts, f32 and bf16, against their plain
            versions (the forward at KERNEL_TOL and, in bf16, FWD_ULPS of its
            largest output; the backward at GRAD_RTOL), and two launches bit
            for bit;
3b. cpb-ragged  the CPB forward and backward at (H, W, J) = (8, 8, 4), (9,
            7, 20), (6, 11, 37) and (5, 9, 72) (a 64-token bag's J = 4; W*J
            not a multiple of 16; a J split across two backward tiles), dm 8
            / 16 / 32, f32 and bf16, against their plain versions (the
            forward at KERNEL_TOL, the backward at CPB_GRAD_L2), and two
            launches bit for bit; then the f32 forward's and backward's
            layer-2 ReLU decisions, counted per column of z2 at each shape
            and dm on random inputs and on inputs that put a class of pairs
            at z2's rounding boundary, must be equal (``cpb_mask_counts``);
4. kernels  each CUDA kernel (CPB forward and backward, attention forward
            without and with Philox dropout at keep 0.9, attention backward
            without and with dropout) at the main path's shapes (BG = 8 bags x
            8 offset groups; 2500-patch bags: 50x50 queries, J = 144;
            4096-patch bags: 64x64, J = 256; dm = 32, dh = 64), in f32 and
            bf16, held against its plain PyTorch version on the same inputs,
            and timed beside the plain version, one PyTorch library call where
            there is one, and the least time the card could take for the same
            work; the dropout mask's kept share must be within 5 sigma of 0.9;
            every kernel must repeat bit for bit (the f32 attention kernels,
            on the tf32 tensor cores, also give their bound at 3xTF32; each
            f32 attention forward its error against float64 beside the
            plain version's and its lse, which must equal the backward's bit
            for bit; the f32 CPB forward its largest and relative L2 error
            against float64, the backward each gradient's relative L2 error
            against float64, beside the plain version's); the bf16 forwards' largest
            error in bf16 ulps of each element and their share of elements
            equal to the plain version's; then the f32-bias forms at the 1-D
            path's shape (BG = 64, N = 2501, J = 625), dbias at the f32 bound;
5. slice    the port's serving entry point, ``sml_tpu_torch.inference.main``,
            on synthetic data (B = 8, bf16, seeded weights) at 2500 and 4096
            patches per bag: both forward kernels must be launched once per
            branch and batch (no backward, no dropout), every output finite,
            and one batch's outputs must agree with the same model run through
            the plain versions; then the eval step's time per batch;
6. train    the port's train entry point, ``sml_tpu_torch.main.main``, for one
            epoch at 2500 patches (64 synthetic bags, B = 8, bf16: 8 train
            steps, then Val and Test): each of the four kernels launched
            exactly twice per train step (the eval launches counted apart),
            finite loss terms, and a ``best_modal.npz`` that
            ``inference.main --weights`` reads back; one train step's loss and
            every parameter gradient through the kernels against the plain
            versions; then the train step's time, bags/s and peak memory.

TransMIL (``--mode path --path_arch transmil``: hidden 512, two TransLayers of
8 heads x 64 with 256 landmarks, PPEG, B = 8, bf16, seeded weights), whose two
Nystrom chains per layer run the attention kernels without a bias (with a span
on masked bags):

7. chains   the bias-less and the span forms, forward and backward, at chain 1
            (n_pad rows x 256 landmark keys) and chain 3 (256 landmark rows x
            n_pad keys) of 2500- and 4096-patch bags (n_pad 2560 / 4352,
            BG = 64), f32 and bf16, against their plain versions, repeated bit
            for bit and timed as in phase 4 (the f32 forwards also against
            float64 and their lse against the backward's); the spans come
            from bucketed
            masks, with an all-invalid bag, invalid landmark rows and a column
            start past the first key tile.  (Phase 4 also holds the span form
            with a bias and dropout.)
8. tm-slice ``inference.main`` at 2500 and 4096 patches: exactly 4 bias-less
            forward launches per batch and no backward, finite metrics, one
            batch through the kernels against the plain versions, the eval
            step's time, bags/s and peak memory;
9. tm-train ``main.main`` for one epoch at 2500 patches: 4 bias-less forward
            and 4 backward launches per train step, finite loss, one train
            step's loss and every gradient through the kernels against the
            plain versions, the train step's time, bags/s and peak memory;
10. bucketed ``main.main`` with ``--variable_bags true --bucket_sizes
             1024,2500`` for one epoch and its Val / Test: span launches in both
            directions, every batch's loss and outputs finite.
10b. f32-train  phase 6 for deformpathomic and phase 9 for TransMIL without
            ``--compute_dtype`` (the config's default, float32): every
            attention launch in the f32 dh = 64 form (the backward on the
            tf32 tensor cores), 2 and 4 backward launches per train step,
            and deformpathomic's CPB launches in f32 (both on the tf32
            tensor cores), 2 each per train step,
            finite losses, one train step's loss and every gradient through
            the kernels against the plain versions at TRAIN_TOL["float32"], the
            train step's time, bags/s and peak memory.

The other deformpathomic configurations and the modes without a kernel:

11. deform-masked  phase 10's run for deformpathomic (masked bags zeroed, no
            span: each kernel twice per train step), then phase 5 at fixdim
            2000 (45 x 45 queries, J = 121);
12. deform-1d  ``--attn_dim 1`` at 2500 patches (N = 2501, J = 625): phases 5
            and 6 with the f32-bias forms of the attention forward and
            backward (no CPB kernel, no dropout);
13. deform-fusion  phase 6 with ``--fusion_type pofusion``: the BatchNorm
            running averages moved, finite, written to ``best_modal.npz`` and
            read back by ``inference.main --weights``;
14. modes   omic, path with ABMIL (fixed and bucketed bags), pathomic
            (concat and pofusion), pathomic_original and MCAT (survival,
            concat and bilinear co-attention fusion): one short epoch each,
            no kernel launch, finite metrics, a train step's time.

CMTA (``--mode cmta``, survival, f32 as the config default: 256-wide
TransLayers of 8 heads x 32 with 128 landmarks), whose two Nystrom chains per
TransLayer of its two TransformerP (4 layers) run the f32 dh = 32 form of the
attention kernels:

15. cmta-kernels  the registers of the dh = 32 kernels (3xTF32 on the
            tensor cores), then the dh = 32 forward and backward at chain 3
            (128 landmark rows x 2560 keys) and chain 1 (2560 rows x 128
            landmark keys) of a 2500-patch bag (BG = 64), at both chains of
            the bucketed bags (1152 and 4224 tokens) and at the ragged (N, J)
            of phase 3 and their transposes, against their plain versions
            (KERNEL_TOL and GRAD_RTOL in f32; the backward's largest error of
            each gradient's max also beside DH32_ERR_AIM; the kernel's and
            the plain version's errors against float64), repeated bit for
            bit; the forward's lse against the backward's, bit for bit
            (``lse_equal_bwd``); at the chains and the bucketed chains timed
            beside the plain version and F.scaled_dot_product_attention in
            f32, the forward's stats, out and combine kernels and the
            backward's rows, keys and combine kernels timed apart, each
            bound on the CUDA cores and at 3xTF32; every other dh = 32 form
            (bf16, a bias, a span, dropout) must raise in the wrapper and be
            refused by the C entries;
16. cmta    ``inference.main`` and ``main.main`` at 2500 patches (B = 8, f32):
            exactly 8 dh = 32 forward launches per eval batch, 8 forward and 8
            backward per train step, finite losses and C-index, one batch and
            one train step's loss and gradients through the kernels against
            the plain versions (SLICE_TOL and TRAIN_TOL in f32), the step
            times, bags/s and peak memory; then a bf16 CMTA epoch, where the
            gate admits no chain (32 x 2 bytes < 128): no launch.

The rest of a training run, deformpathomic at 2500 patches (B = 8, bf16):

17. resume  ``main.main`` for 2 epochs (8 steps each, ``--eval_every_iters
            4``) against 1 epoch resumed with ``--epochs 2 --resume true``:
            ``resuming from epoch 1``, each kernel twice per train step in the
            resumed epoch, the checkpoint files of a run, the two runs' final
            train states alike (parameters within RESUME_PARAM_TOL, Adam
            moments within RESUME_OPT_TOL, scheduler, generators and step
            exactly; bit equality reported), each resume of RESUME_FAULTS
            (fresh optimizer, restarted scheduler, lost generators) outside
            the parameter bound, and the time to write and to read
            ``last_state.pt`` and its size;
18. remat   one train step with ``remat`` against one without, from one init
            and one dropout seed, at S2500 and on the 1-D path (N = 2501, J =
            625): loss and gradients within TRAIN_TOL, the generators equal
            after the step, #1 and #3 launched 4 times and #2 and #4 twice
            (without remat: each twice), and both steps' time and peak memory.

The real-data workflow, on a fake cohort written at full size (IvYGAP and
TCGA, 16 patients each, 2500 x 1024 f32 features per slide in .h5 files from
``write_h5``, the 431 genes of the signature, CSVs and TSVs from ``csv``):

19. cohort  the readers' Train epoch timed (MB/s, samples/s); deformpathomic
            (bf16) trained one epoch by ``main.main --dataset both``, each of
            #1-#4 twice per train step as in phase 6; the cohort packed by
            ``python -m sml_tpu_torch.pack_data``, the native prefetcher's
            (workers 2) and the numpy path's batches equal to the readers'
            (Train and Test), both timed; the same epoch from ``--packed_dir``
            (losses within TRAIN_TOL, bit equality reported); pathomic (f32,
            ``--novalset``) trained one epoch and attributed by
            ``inference.main --attribution`` ablation, permutation,
            gradient_shap and deep_shap, MCAT (survival) by mcat_groups: each a
            CSV of 431 finite rows and a ``metrics.jsonl`` record, no kernel
            launch, timed; then the phase's wall time.

The device loop and the last utilities, deformpathomic at 2500 patches (B = 8,
bf16):

20. device-loop  one epoch of 6 train steps through ``main.main`` per step and
            with ``--device_loop true --device_loop_chunk 4`` (a chunk of 4 and
            a remainder of 2), from one seed: the final parameters within
            RESUME_PARAM_TOL and Adam's moments within RESUME_OPT_TOL (bit
            equality reported), the rest of the state exactly, each of #1-#4
            launched 12 times in both runs; the median step time both ways
            (``utils/profiling.StepTimer``), a chunk's stacked copy to the
            card, the peak memory; ``return_attn`` of a TransMIL (bf16, dh =
            64) and a CMTA (f32, dh = 32) Nystrom attention at 2501 tokens
            against its kernel route (SLICE_TOL, no launch, the attention
            finite and of JAX's shape); ``utils/profiling.trace`` around a
            train step naming the kernel functions of #1-#4;
            ``utils/flops.deformpathomic_flops`` at S2500 / S4096, train and
            eval, beside its time at the bf16 peak and phase 4's kernel times;
            ``utils/torch_compat.load_reference_state_dict`` of a reference
            state dict (``reference_state_dict``) into a model on the card,
            then an eval step.

Several ranks, children of this script (``--parallel-child``) sharing the card
over gloo, as the port's bootstrap chooses when ranks outnumber cards:

21. parallel  two ranks: deformpathomic at S2500 data-parallel (bf16, a
            global batch of 8, 4 a rank, dropout off, 3 train steps; one f32
            step); on a (1, 2) grid deformpathomic at S4096 seq-parallel (one
            train step with dropout off, one with dropout on: 32 of the 64
            query rows a rank, J = 256) and TransMIL at S4096 seq-parallel (an eval batch
            and a train step: chain 1 of 2176 of the 4352 tokens a rank on
            #3 / #4); then one rank in an NCCL group against the same step
            without a group.  Each rank's launches of #1-#4 and their shapes,
            the first step's loss and summed gradients against this process's
            run (TRAIN_TOL; the bf16 data-parallel gradients against this
            process running the model on each rank's half of the batch), the
            TransMIL outputs (SLICE_TOL), the ranks' states bit-equal after
            every step, median step times.

The raw patch reader (``RawPatchReader``, ``if_end2end``), whose JPEG pixel
stage is the port's one kernel with no Pallas counterpart:

22. raw-patches  ``jpeg_pixels`` against its plain version bit for bit on
            every committed fixture (``tests/data/jpeg``: quality 50 / 75 / 95,
            4:2:0 / 4:2:2 / 4:4:4, grey, optimised tables, restart markers, 100
            x 60) and a 4:4:0 file made from the 4:2:2 one, uint8 and f32; then
            at 2500 distinct 224 x 224 4:2:0 patches, timed beside its plain
            version and its bound; then a fake TCGA raw cohort beside phase
            19's, two Train slides of 3000 and 1000 coordinates (the subsample
            and the repetition branches) read at fixdim 2500 by
            ``TCGADataset("Train", config, if_end2end=True)`` on cuda through a
            ``Loader`` of batch 2 with 2 workers: one launch per slide, each
            ``x_path`` bit-equal to the CPU reading of its slide, per slide the
            host entropy stage's ms and patches/s, the kernel's ms and bound,
            the bytes copied to the card, and the peak memory.

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
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

# published H100 SXM peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12     # the tf32 tensor cores, three of whose products make one f32 (3xTF32)
BG, DM, DH = 64, 32, 64
SHAPES = {2500: (50, 144), 4096: (64, 256)}            # fixdim -> (query side, J)
MAIN_FIXDIM = 2500                                     # config/config_mine.yaml fixdim
# |kernel - plain| <= atol + rtol * |plain|: f32 sums run in another order;
# bf16 outputs are both rounded from f32 and may differ by one bf16 ulp
KERNEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# bf16 attention forwards: also max|kernel - plain| <= FWD_ULPS bf16 ulps of
# max|plain|.  Where outputs are small, KERNEL_TOL's atol is as large as a
# typical output (chain 3 at 4352 keys: ~0.02, max ~0.1) and would pass a 20%
# error; the two differ by one rounding of p or of out, one ulp of the largest
FWD_ULPS = 4
# the model through the kernels vs through the plain versions, by compute
# dtype: bf16 outputs are rounded at other points in the two paths; the f32
# model (CMTA's dh = 32 chains) sums the chains in f32, in another order
SLICE_TOL = {"bfloat16": (3e-2, 2e-2), "float32": (1e-3, 1e-3)}
# gradients: |kernel - plain| <= rtol * max|plain| per tensor (sums in another order;
# bf16 outputs both rounded from f32)
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# CPB backward: ||kernel - plain|| <= 1e-2 ||plain|| per gradient.  The ReLU
# derivative decisions at a ~ 0 and z2 ~ 0 differ between the kernel's fused
# multiply-adds and the plain version's separate operations, and each flip moves
# dz1 by a whole w1 dz2: in f32 at S2500 both lie ~2.5e-4 (d_dx, scale 8e-3) and
# ~1.5e-3 (dw1, scale 1.8) from a float64 evaluation, so no per-element bound holds.
CPB_GRAD_L2 = 1e-2
# one train step through the kernels vs through the plain versions, same batch
# and generators, by compute dtype: (|loss terms|, every parameter gradient's
# relative L2), gradients under 1e-3 of the largest norm relative to that
# floor.  bf16 roundings fall at other points in the two paths; f32 sums run
# in another order
TRAIN_TOL = {"bfloat16": (2e-2, 5e-2), "float32": (1e-3, 1e-3)}
# CMTA's Nystrom chains: 256-wide TransLayers, 8 heads of 32 and 128 landmarks;
# 2500 patches + cls = 2501 tokens, front-padded to 2560
CMTA_M, CMTA_DH, CMTA_NPAD = 128, 32, 2560
# bucketed CMTA bags: 1024 and 4096 patches + cls, front-padded to 1152 / 4224
CMTA_BUCKETED = (1152, 4224)
# the aim (not a pass rule: that stays GRAD_RTOL) for the dh = 32 backward's
# largest gradient error, relative to each gradient's max
DH32_ERR_AIM = 2e-6
DH32_SEED = 6                         # the cmta-kernels phase's inputs
CMTA_FLAGS = {"mode": "cmta", "task_type": "survival", "compute_dtype": "float32"}
KEEP_PROB, SEED = 0.9, 20240611       # the attention dropout of the training path
# TransMIL's Nystrom chains: 256 landmarks; bag + cls token front-padded to a
# multiple of them
NYSTROM_M = 256
N_PAD = {2500: 2560, 4096: 4352}
TM_FLAGS = {"mode": "path", "path_arch": "transmil"}
# the 1-D deformable path (attn_dim 1): the cls token and 2500 patches, J = Nd
# of the stride-4 offset conv; its bias is f32 beside bf16 q, k, v
D1_FLAGS = {"attn_dim": 1, "return_vgrid": False}
D1_N, D1_J = 2501, 625
PATH_FLAGS = {"transmil": TM_FLAGS, "deform1d": D1_FLAGS, "cmta": CMTA_FLAGS}
LABELS = {"deformpathomic": ("slice", "train"), "transmil": ("tm-slice", "tm-train"),
          "deform1d": ("deform-1d", "deform-1d"), "cmta": ("cmta", "cmta")}


_START = time.perf_counter()


def _line(phase: str, **fields) -> None:
    """One result line; ``at_s`` is the script's wall time so far (the phases'
    share of the run's time limit)."""
    fields["at_s"] = round(time.perf_counter() - _START, 1)
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


def _compare_fwd(got: torch.Tensor, want: torch.Tensor) -> dict:
    """An attention forward against its plain version: ``_compare`` at
    KERNEL_TOL and, in bf16, the largest error within FWD_ULPS bf16 ulps of
    the largest |plain| (``ulps_of_max``)."""
    cmp = _compare(got, want, KERNEL_TOL[got.dtype])
    if got.dtype == torch.bfloat16:
        top = want.float().abs().max().clamp_min(1e-30)
        cmp["ulps_of_max"] = cmp["max_abs_err"] / torch.exp2(torch.floor(torch.log2(top)) - 7
                                                             ).item()
        cmp["ok"] &= cmp["ulps_of_max"] <= FWD_ULPS
    return cmp


def _bound(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _attn_work(n: int, j: int, size: int, bias_size: int = 0, bwd: bool = False, work=None):
    """(bytes, FLOPs) of the dh = DH attention forward (``bwd``: backward) of BG
    bags of n rows and j keys at ``size`` bytes an element: q, k, v (and dout)
    read once, out (dq, dk, dv) written once, the bias (and dbias) at
    ``bias_size`` bytes a pair; 4 DH FLOP a valid pair forward (+ 7 with a
    bias), 10 DH backward, and 2 DH a key for each uniform row.  ``work``:
    (valid pairs, uniform rows) of a span batch (``_span_work``); all pairs
    without."""
    pairs, uniform = (BG * n * j, 0) if work is None else work
    if bwd:
        return (size * (3 * BG * n * DH + 4 * BG * j * DH) + 2 * bias_size * BG * n * j,
                10 * DH * pairs + 2 * DH * j * uniform)
    return (size * (2 * BG * n * DH + 2 * BG * j * DH) + bias_size * BG * n * j,
            (4 * DH + (7 if bias_size else 0)) * pairs + 2 * DH * j * uniform)


def _attn_bound(n: int, j: int, dtype: torch.dtype, bias_size: int = 0, bwd: bool = False,
                work=None):
    """``_bound`` of ``_attn_work`` in ``dtype``."""
    return _bound(*_attn_work(n, j, torch.finfo(dtype).bits // 8, bias_size, bwd, work), dtype)


def _tf32x3(cost, dtype: torch.dtype) -> dict:
    """An f32 kernel's bound at 3xTF32, three tf32 products for each f32 one at
    PEAK_TF32 beside the same bytes (ms), as {"bound_3xtf32_ms": ...}; nothing
    in bf16.  ``cost``: (bytes, FLOPs)."""
    if dtype != torch.float32:
        return {}
    n_bytes, flops = cost
    return {"bound_3xtf32_ms": max(n_bytes / HBM_BYTES_PER_S, 3 * flops / PEAK_TF32) * 1e3}


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
    spilled = sorted({name for name, lines in report.items() for ln in lines
                      if any(int(n) for n in re.findall(r"(\d+) bytes spill stores", ln))})
    if spilled:     # a kernel that spills registers is a design fault, not a slow kernel
        raise AssertionError(f"register spills in {spilled}: see the [build] line")


def _cpb_inputs(h: int, w: int, j: int, dtype: torch.dtype, g: torch.Generator,
                dm: int = DM):
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    dx, dy = rn(BG, w * j, scale=0.7), rn(BG, h, j, scale=0.7)
    weights = [rn(dm, scale=0.7), rn(dm, scale=0.7), rn(dm, scale=0.1),
               rn(dm, dm, scale=dm ** -0.5), rn(dm, scale=0.1),
               rn(dm, 1, scale=dm ** -0.5), rn(1, scale=0.1)]
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


CPB_GRADS = ("d_dx", "d_dy", "dw0x", "dw0y", "db0", "dw1", "db1", "dw2", "db2")
# the f32 CPB backward's former CUDA-core twin (replaced by
# the tf32 kernel): its largest relative L2 error of a gradient against the
# plain version at S2500 / S4096 in phase 4 (PERF.md's kernel table), printed
# beside the kernel's own for comparison, not as a pass rule
CPB_BWD_TWIN_L2 = {2500: 4.5e-4, 4096: 4.8e-4}


def _cpb_bwd_f64(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias):
    """The CPB backward's formulas (``cpb_bias_bwd_plain``'s, f32 weights) in
    float64, rows in chunks so the (BG, rows, W, J, dm) activations stay under
    2**25 elements: the exact yardstick of the f32 kernel and the plain f32
    version."""
    from sml_tpu_torch.ops.kernels.cpb_bias import _layer1

    dx, dy, w0x, w0y, b0, w1, b1, w2, dbias = (
        t.double() for t in (dx, dy, w0x, w0y, b0, w1, b1, w2, dbias))
    bg, wj = dx.shape
    _, h, j = dy.shape
    w, dm = wj // j, w1.shape[0]
    ddx, ddy = dx.new_zeros(bg, w, j), dx.new_empty(bg, h, j)
    acc = [dx.new_zeros(s) for s in (dm, dm, dm, (dm, dm), dm, dm, 1)]
    rows = max(1, (1 << 25) // (bg * wj * dm))
    for y0 in range(0, h, rows):
        a = _layer1(dx, dy, w0x, w0y, b0, y0, rows)                 # (BG, r, W, J, dm)
        h1 = torch.relu(a)
        z2 = h1 @ w1 + b1
        g = dbias[:, y0:y0 + rows].reshape(bg, -1, w, j)
        dz2 = torch.where(z2 > 0, w2[:, 0] * g[..., None], 0.0)
        dz1 = torch.where(a > 0, dz2 @ w1.T, 0.0)
        ddx += (dz1 @ w0x).sum(dim=1)
        ddy[:, y0:y0 + rows] = (dz1 @ w0y).sum(dim=2)
        for i, part in enumerate((
                torch.einsum("brxjk,bxj->k", dz1, dx.reshape(bg, w, j)),
                torch.einsum("brxjk,brxj->k", dz1, dy[:, y0:y0 + rows, None, :].expand_as(g)),
                dz1.sum(dim=(0, 1, 2, 3)), torch.einsum("brxjk,brxjm->km", h1, dz2),
                dz2.sum(dim=(0, 1, 2, 3)), torch.einsum("brxjm,brxj->m", torch.relu(z2), g),
                g.sum().reshape(1))):
            acc[i] += part
        del a, h1, z2, g, dz2, dz1
    return (ddx.reshape(bg, wj), ddy, *acc[:5], acc[5].reshape(dm, 1), acc[6])


# the f32 CPB forward's former CUDA-core twin (replaced by the tf32 kernel):
# its largest absolute error against the plain version at S2500 / S4096 in
# phase 4 (PERF.md's kernel table), printed beside the kernel's own for
# comparison, not as a pass rule
CPB_FWD_TWIN_ERR = {2500: 6.6e-7, 4096: 9.5e-7}


def _cpb_fwd_f64(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """The CPB forward's formulas (``cpb_bias_plain``'s, f32 weights) in
    float64, rows in chunks so the (BG, rows, W, J, dm) activations stay under
    2**25 elements: the exact yardstick of the f32 kernel and the plain f32
    version."""
    from sml_tpu_torch.ops.kernels.cpb_bias import _layer1

    dx, dy, w0x, w0y, b0, w1, b1, w2, b2 = (
        t.double() for t in (dx, dy, w0x, w0y, b0, w1, b1, w2, b2))
    bg, wj = dx.shape
    _, h, j = dy.shape
    out = dx.new_empty(bg, h, wj)
    rows = max(1, (1 << 25) // (bg * wj * w1.shape[0]))
    for y0 in range(0, h, rows):
        h1 = torch.relu(_layer1(dx, dy, w0x, w0y, b0, y0, rows))
        bias = (torch.relu(h1 @ w1 + b1) @ w2)[..., 0] + b2           # (BG, r, W, J)
        out[:, y0:y0 + rows] = bias.reshape(bg, -1, wj)
        del h1, bias
    return out


def _cpb_fwd_f64_errors(bias, plain, args, fixdim: int) -> dict:
    """The largest absolute and the relative L2 error against
    ``_cpb_fwd_f64``, for the f32 kernel (``max_abs_err_f64``,
    ``rel_l2_f64``) and the plain f32 version (``plain_...``), beside the
    twin's figure against the plain version (CPB_FWD_TWIN_ERR)."""
    exact = _cpb_fwd_f64(*args)

    def errs(a):
        d = a.double() - exact
        return d.abs().max().item(), (d.norm() / exact.norm().clamp_min(1e-300)).item()

    (k_max, k_l2), (p_max, p_l2) = errs(bias), errs(plain)
    return {"max_abs_err_f64": k_max, "rel_l2_f64": k_l2, "plain_max_abs_err_f64": p_max,
            "plain_rel_l2_f64": p_l2, "twin_max_abs_err_plain": CPB_FWD_TWIN_ERR.get(fixdim)}


def _cpb_bwd_f64_errors(got, want, args, dbias, fixdim: int) -> dict:
    """Each gradient's relative L2 error against ``_cpb_bwd_f64``, for the f32
    kernel (``rel_l2_f64``) and the plain f32 version (``plain_rel_l2_f64``),
    beside the twin's figure against the plain version (CPB_BWD_TWIN_L2)."""
    exact = _cpb_bwd_f64(*args, dbias)

    def rel(a, b):
        return ((a.double() - b).norm() / b.norm().clamp_min(1e-300)).item()

    return {"rel_l2_f64": {n: rel(a, b) for n, a, b in zip(CPB_GRADS, got, exact)},
            "plain_rel_l2_f64": {n: rel(a, b) for n, a, b in zip(CPB_GRADS, want, exact)},
            "twin_rel_l2_plain": CPB_BWD_TWIN_L2.get(fixdim)}


def _compare_f32_dbias(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The f32-bias form's dbias on its own, at the f32 gradient bound:
    max|kernel - plain| <= GRAD_RTOL[float32] * max|plain| (its other three
    gradients are bf16, held at GRAD_RTOL[bfloat16]).  As a control the plain
    dbias rounded through bf16 (up to 2^-9 of each element) must miss the same
    bound, so that a kernel which rounded dbias would fail it too."""
    rtol = GRAD_RTOL[torch.float32]
    scale = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    control = (want.to(torch.bfloat16).float() - want).abs().max().item()
    ok = (got.dtype == torch.float32 and bool(torch.isfinite(got).all())
          and err <= rtol * scale < control)
    return {"dbias_dtype": str(got.dtype).split(".")[-1], "dbias_max_abs_err": err,
            "dbias_of_scale": err / scale, "dbias_rtol": rtol,
            "dbias_bf16_control_of_scale": control / scale, "dbias_ok": ok}


def _f32_dbias(got, want) -> dict:
    """``_compare_f32_dbias`` of an f32 dbias (got[3]), nothing otherwise."""
    if got[3] is None or got[3].dtype != torch.float32:
        return {}
    return _compare_f32_dbias(got[3], want[3])


def _repeats(fn, got) -> bool:
    """Whether a second launch of ``fn`` returns ``got`` bit for bit (the
    kernels sum in a fixed order, without atomics)."""
    again = fn()
    torch.cuda.synchronize()
    return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))


def _ulps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The largest |got - want| in bf16 ulps of each element of ``want``, and
    the share of elements equal to it."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return {"max_bf16_ulps": ((got - want).abs() / ulp).max().item(),
            "equal_share": (got == want).float().mean().item()}


def _ulps_bf16(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``_ulps`` of a bf16 output, nothing of an f32 one."""
    return _ulps(got, want) if got.dtype == torch.bfloat16 else {}


def _sdpa_ms(q, k, v, dout, mask, mask_grad: bool = False):
    """(forward ms, backward ms) of F.scaled_dot_product_attention(q, k, v,
    attn_mask=mask, scale=1.0), its backward with respect to q, k, v (and the
    mask with ``mask_grad``); the backward's is None when PyTorch does not run
    that form."""
    import torch.nn.functional as F

    fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=1.0))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if mask_grad:
        mask = mask.detach().requires_grad_(True)
        leaves.append(mask)
    try:
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=mask, scale=1.0)
        torch.autograd.grad(out, leaves, dout, retain_graph=True)
    except RuntimeError:          # a yardstick only: PyTorch may not run this form
        return fwd_ms, None
    return fwd_ms, _time_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                                        retain_graph=True), iters=5)


def phase_kernels() -> dict:
    """Every kernel vs its plain version at the main path's shapes; returns
    the JSON entries of the main shape (S2500, bf16) by name, and the f32
    forward and backward with dropout there as ``deform_attention_fwd_f32``
    and ``deform_attention_bwd_f32``."""
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
            args = _cpb_inputs(side, side, j, dtype, g)
            bias = cpb_bias(*args)
            torch.cuda.synchronize()
            w_bytes = size * (DM * DM + 5 * DM + 1)
            table_bytes = 4 * (BG * side * j * 2)            # dx and dy, f32
            cost = (table_bytes + w_bytes + size * pairs, pairs * (2 * DM * DM + 6 * DM + 1))
            bound_ms, bound_by = _bound(*cost, dtype)
            plain = cpb_bias_plain(*args)
            rows = [{"name": "cpb_bias", **_compare(bias, plain, KERNEL_TOL[dtype]),
                     **_ulps_bf16(bias, plain),
                     **(_cpb_fwd_f64_errors(bias, plain, args, fixdim)
                        if dtype == torch.float32 else {}),
                     "repeats": _repeats(lambda: (cpb_bias(*args),), (bias,)),
                     "ms": _time_ms(lambda: cpb_bias(*args)),
                     "plain_ms": _time_ms(lambda: cpb_bias_plain(*args), iters=5),
                     "bound_ms": bound_ms, "bound_by": bound_by, **_tf32x3(cost, dtype),
                     "library_ms": None}]
            del plain

            dbias = (torch.randn(BG, side, side * j, device="cuda", generator=g)
                     * 1e-3).to(dtype)
            got = cpb_bias_bwd(*args[:8], dbias)
            torch.cuda.synchronize()
            cost = (table_bytes * 2 + w_bytes * 2 + size * pairs, pairs * (6 * DM * DM + 16 * DM))
            bound_ms, bound_by = _bound(*cost, dtype)
            want = cpb_bias_bwd_plain(*args[:8], dbias)
            rows.append({"name": "cpb_bias_bwd",
                         **_compare_grads(got, want, CPB_GRAD_L2, l2=True),
                         **(_cpb_bwd_f64_errors(got, want, args[:8], dbias, fixdim)
                            if dtype == torch.float32 else {}),
                         "repeats": _repeats(lambda: cpb_bias_bwd(*args[:8], dbias), got),
                         "ms": _time_ms(lambda: cpb_bias_bwd(*args[:8], dbias)),
                         "plain_ms": _time_ms(lambda: cpb_bias_bwd_plain(*args[:8], dbias),
                                              iters=slow_iters, warmup=1),
                         "bound_ms": bound_ms, "bound_by": bound_by, **_tf32x3(cost, dtype),
                         "library_ms": None})
            del got, want, dbias

            q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(dtype)
            k = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            v = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
            dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(dtype)
            fbias = bias.reshape(BG, n, j)
            cost = _attn_work(n, j, size, size)
            bound_ms, bound_by = _attn_bound(n, j, dtype, size)
            lib_fwd, lib_bwd = _sdpa_ms(q, k, v, dout, fbias, mask_grad=True)
            out = deform_attention_fwd(q, k, v, fbias)
            torch.cuda.synchronize()
            plain = deform_attention_fwd_plain(q, k, v, fbias)
            f32 = dtype == torch.float32
            rows.append({"name": "deform_attention_fwd",
                         **_compare_fwd(out, plain), **_ulps_bf16(out, plain),
                         **(_f32_fwd_checks(out, plain, q, k, v, dout, fbias) if f32 else {}),
                         "repeats": _repeats(lambda: (deform_attention_fwd(q, k, v, fbias),),
                                             (out,)),
                         "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias)),
                         "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(q, k, v, fbias),
                                              iters=5),
                         "bound_ms": bound_ms, "bound_by": bound_by, **_tf32x3(cost, dtype),
                         "library_ms": lib_fwd})

            keep = philox_keep_mask(SEED, BG, n, j, KEEP_PROB, device="cuda")
            share = keep.float().mean().item()
            sigma = math.sqrt(KEEP_PROB * (1 - KEEP_PROB) / keep.numel())
            out = deform_attention_fwd(q, k, v, fbias, KEEP_PROB, SEED)
            torch.cuda.synchronize()
            plain = deform_attention_fwd_plain(q, k, v, fbias, keep, KEEP_PROB)
            cmp = _compare_fwd(out, plain)
            cmp["kept_share"], cmp["kept_share_sigmas"] = share, (share - KEEP_PROB) / sigma
            cmp["ok"] &= abs(share - KEEP_PROB) < 5 * sigma
            if f32:
                cmp.update(_f32_fwd_checks(out, plain, q, k, v, dout, fbias, keep, KEEP_PROB))
            rows.append({"name": "deform_attention_fwd_dropout", **cmp, **_ulps_bf16(out, plain),
                         "repeats": _repeats(lambda: (deform_attention_fwd(
                             q, k, v, fbias, KEEP_PROB, SEED),), (out,)),
                         "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias,
                                                                     KEEP_PROB, SEED)),
                         "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(
                             q, k, v, fbias, philox_keep_mask(SEED, BG, n, j, KEEP_PROB,
                                                              device="cuda"), KEEP_PROB),
                             iters=5),
                         "bound_ms": bound_ms, "bound_by": bound_by, **_tf32x3(cost, dtype),
                         "library_ms": None})

            cost = _attn_work(n, j, size, size, bwd=True)
            bound_ms, bound_by = _attn_bound(n, j, dtype, size, bwd=True)
            for keep_prob in (1.0, KEEP_PROB):
                mask = None if keep_prob == 1.0 else keep
                got = deform_attention_bwd(q, k, v, fbias, dout, keep_prob, SEED)
                torch.cuda.synchronize()
                want = deform_attention_bwd_plain(q, k, v, fbias, dout, mask, keep_prob)
                rows.append({
                    "name": "deform_attention_bwd", "keep_prob": keep_prob,
                    **_compare_grads(got, want, GRAD_RTOL[dtype]), **_f32_dbias(got, want),
                    "repeats": _repeats(lambda: deform_attention_bwd(
                        q, k, v, fbias, dout, keep_prob, SEED), got),
                    "ms": _time_ms(lambda: deform_attention_bwd(q, k, v, fbias, dout,
                                                                keep_prob, SEED)),
                    "plain_ms": _time_ms(lambda: deform_attention_bwd_plain(
                        q, k, v, fbias, dout, mask, keep_prob), iters=5),
                    "bound_ms": bound_ms, "bound_by": bound_by, **_tf32x3(cost, dtype),
                    "library_ms": lib_bwd if keep_prob == 1.0 else None})
                del got

            # the span form with a bias and dropout, on random intervals: no port
            # path reaches it (JAX reaches it only through the TPU's sampled-point
            # padding of the 1-D route), and it is held here all the same
            span = _interval_spans(n, j)
            out = deform_attention_fwd(q, k, v, fbias, KEEP_PROB, SEED, span)
            torch.cuda.synchronize()
            plain = deform_attention_fwd_plain(q, k, v, fbias, keep, KEEP_PROB, span)
            rows.append({"name": "deform_attention_fwd_span_bias_dropout",
                         **_compare_fwd(out, plain), **_ulps_bf16(out, plain),
                         **(_f32_fwd_checks(out, plain, q, k, v, dout, fbias, keep, KEEP_PROB,
                                            span) if f32 else {}),
                         "repeats": _repeats(lambda: (deform_attention_fwd(
                             q, k, v, fbias, KEEP_PROB, SEED, span),), (out,)),
                         "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, fbias,
                                                                     KEEP_PROB, SEED, span))})
            got = deform_attention_bwd(q, k, v, fbias, dout, KEEP_PROB, SEED, span)
            torch.cuda.synchronize()
            want = deform_attention_bwd_plain(q, k, v, fbias, dout, keep, KEEP_PROB, span)
            rows.append({"name": "deform_attention_bwd_span_bias_dropout",
                         **_compare_grads(got, want, GRAD_RTOL[dtype]), **_f32_dbias(got, want),
                         "repeats": _repeats(lambda: deform_attention_bwd(
                             q, k, v, fbias, dout, KEEP_PROB, SEED, span), got),
                         "ms": _time_ms(lambda: deform_attention_bwd(
                             q, k, v, fbias, dout, KEEP_PROB, SEED, span))})
            del got, want
            for e in rows:
                e["ok"] &= e.get("dbias_ok", True) and e.get("lse_equal_bwd", True)
                e.update(fixdim=fixdim, dtype=str(dtype).split(".")[-1], bg=BG, n=n, j=j)
                _line("kernels", **e)
                if not e["ok"] or not e.get("repeats", True):
                    failures.append(f"{e['name']} fixdim={fixdim} {dtype}")
                main = fixdim == MAIN_FIXDIM and dtype == torch.bfloat16
                if main and e.get("keep_prob", KEEP_PROB) == KEEP_PROB:
                    entries[e["name"]] = e
                if fixdim == MAIN_FIXDIM and f32 and e["name"] == "deform_attention_bwd" and \
                        e["keep_prob"] == KEEP_PROB:
                    entries["deform_attention_bwd_f32"] = e
                if fixdim == MAIN_FIXDIM and f32 and e["name"] == "deform_attention_fwd_dropout":
                    entries["deform_attention_fwd_f32"] = e
                if fixdim == MAIN_FIXDIM and f32 and e["name"] in ("cpb_bias", "cpb_bias_bwd"):
                    entries[e["name"] + "_f32"] = e
            del args, bias, q, k, v, dout, out, plain, keep, fbias, span
            torch.cuda.empty_cache()
    for e in _f32_bias_rows():
        e.update(fixdim=MAIN_FIXDIM, dtype="bfloat16", bias_dtype="float32", bg=BG, n=D1_N,
                 j=D1_J)
        _line("kernels", **e)
        if not e["ok"] or not e["repeats"]:
            failures.append(f"{e['name']} N={D1_N} J={D1_J}")
        entries[e["name"]] = e
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    return entries


def _f32_bias_rows() -> list:
    """The f32-bias form (bf16 q, k, v; no span, no dropout) forward and
    backward at the 1-D path's shape (BG = 8 bags x 8 heads, N = 2501, J =
    625).  The library time is F.scaled_dot_product_attention with the bias as
    attn_mask, which it takes only in q's dtype (bf16)."""
    from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                           deform_attention_fwd, deform_attention_fwd_plain)

    g = torch.Generator(device="cuda").manual_seed(5)
    n, j, bf = D1_N, D1_J, torch.bfloat16
    q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(bf)
    k = torch.randn(BG, j, DH, device="cuda", generator=g).to(bf)
    v = torch.randn(BG, j, DH, device="cuda", generator=g).to(bf)
    bias = torch.randn(BG, n, j, device="cuda", generator=g)
    dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(bf)
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, dout, bias.to(bf), mask_grad=True)
    out = deform_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    plain = deform_attention_fwd_plain(q, k, v, bias)
    # the bias f32: 4 bytes a pair read (and dbias 4 written in the backward)
    bound_ms, bound_by = _attn_bound(n, j, bf, 4)
    rows = [{"name": "deform_attention_fwd_f32bias", **_compare_fwd(out, plain),
             **_ulps_bf16(out, plain),
             "repeats": _repeats(lambda: (deform_attention_fwd(q, k, v, bias),), (out,)),
             "ms": _time_ms(lambda: deform_attention_fwd(q, k, v, bias)),
             "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(q, k, v, bias), iters=5),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_fwd,
             "library_mask_dtype": "bfloat16"}]
    del out, plain
    got = deform_attention_bwd(q, k, v, bias, dout)
    torch.cuda.synchronize()
    want = deform_attention_bwd_plain(q, k, v, bias, dout)
    bound_ms, bound_by = _attn_bound(n, j, bf, 4, bwd=True)
    rows.append({"name": "deform_attention_bwd_f32bias",
                 **_compare_grads(got, want, GRAD_RTOL[bf]), **_compare_f32_dbias(got[3], want[3]),
                 "repeats": _repeats(lambda: deform_attention_bwd(q, k, v, bias, dout), got),
                 "ms": _time_ms(lambda: deform_attention_bwd(q, k, v, bias, dout)),
                 "plain_ms": _time_ms(lambda: deform_attention_bwd_plain(q, k, v, bias, dout),
                                      iters=3),
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_bwd,
                 "library_mask_dtype": "bfloat16"})
    rows[-1]["ok"] &= rows[-1]["dbias_ok"]
    del got, want, q, k, v, bias, dout
    torch.cuda.empty_cache()
    return rows


def _interval_spans(n: int, j: int) -> torch.Tensor:
    """(BG, 4) int32 random [row_start, row_end, col_start, col_end) intervals,
    the last bag with no valid row."""
    g = torch.Generator().manual_seed(n + j)
    r0 = torch.randint(0, n // 2, (BG,), generator=g)
    r1 = r0 + torch.randint(1, n // 2, (BG,), generator=g)
    c0 = torch.randint(0, j // 2, (BG,), generator=g)
    c1 = c0 + torch.randint(1, j // 2, (BG,), generator=g)
    span = torch.stack([r0, r1, c0, c1], dim=1)
    span[-1, :2] = n
    return span.to(torch.int32).cuda()


# (N, J): 36 rows past a 64-row tile; a partial 64-key tile of 20 / 8 / 37 keys, 4 / 8
# / 5 keys past a 16-key step; each bias row starts at another 16-byte phase unless J
# is a multiple of 8 (bf16) or 4 (f32), and J odd reads and writes the staged bias
# element by element.  Every form runs at RAGGED; the bias forms also at RAGGED_BIAS,
# so that the two cover every residue of J mod 8 (20, 37, 38, 39, 41, 42, 43, 72: 4,
# 5, 6, 7, 1, 2, 3, 0), with N = 65 one row past a 64-row tile
RAGGED = ((100, 20), (100, 72), (100, 37))
RAGGED_BIAS = ((100, 38), (100, 39), (100, 41), (100, 42), (100, 43), (65, 37), (65, 72))
BIAS_FORMS = ("bias", "span_bias", "bias_f32")


def phase_ragged() -> None:
    """The attention forward and backward in every form (bias or none x span
    or none x dropout or none) at ragged shapes, f32 and bf16, and the f32
    bias beside bf16 q, k, v, against their plain versions (the forward at
    KERNEL_TOL and, in bf16, FWD_ULPS of its largest output; the backward at
    GRAD_RTOL), and two launches bit for bit; the forms with a bias also at
    RAGGED_BIAS."""
    from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                           deform_attention_fwd, deform_attention_fwd_plain,
                                           philox_keep_mask)

    g = torch.Generator(device="cuda").manual_seed(2)
    g32 = torch.Generator(device="cuda").manual_seed(4)      # the f32 biases
    failures = []
    for n, j in RAGGED + RAGGED_BIAS:
        span = _interval_spans(n, j)
        keep = philox_keep_mask(SEED, BG, n, j, KEEP_PROB, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5).to(dtype)
            k, v = (torch.randn(2, BG, j, DH, device="cuda", generator=g) * 2).to(dtype)
            bias = torch.randn(BG, n, j, device="cuda", generator=g).to(dtype)
            dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(dtype)
            # bf16 q, k, v with an f32 bias: the 1-D path's form (no span, no dropout)
            forms = ("bias", "nobias", "span", "span_bias") + (
                ("bias_f32",) if dtype == torch.bfloat16 else ())
            if (n, j) in RAGGED_BIAS:
                forms = tuple(f for f in forms if f in BIAS_FORMS)
            for form in forms:
                b = bias if form in ("bias", "span_bias") else None
                if form == "bias_f32":
                    b = torch.randn(BG, n, j, device="cuda", generator=g32)
                s = span if form.startswith("span") else None
                for keep_prob in ((1.0,) if form == "bias_f32" else (1.0, KEEP_PROB)):
                    mask = keep if keep_prob < 1.0 else None
                    case = {"form": form, "keep_prob": keep_prob, "n": n, "j": j, "bg": BG,
                            "dtype": str(dtype).split(".")[-1]}
                    fwd = lambda: (deform_attention_fwd(q, k, v, b, keep_prob, SEED, s),)
                    out = fwd()
                    torch.cuda.synchronize()
                    plain = deform_attention_fwd_plain(q, k, v, b, mask, keep_prob, s)
                    bwd = lambda: deform_attention_bwd(q, k, v, b, dout, keep_prob, SEED, s)
                    got = bwd()
                    torch.cuda.synchronize()
                    want = deform_attention_bwd_plain(q, k, v, b, dout, mask, keep_prob, s)
                    n_out = 4 if b is not None else 3
                    grads = _compare_grads(got[:n_out], want[:n_out], GRAD_RTOL[dtype])
                    if b is not None and b.dtype == torch.float32:   # f32 dbias, unrounded
                        grads.update(_compare_f32_dbias(got[3], want[3]))
                        grads["ok"] &= grads["dbias_ok"]
                    for e in ({"pass": "fwd", **case,
                               **_compare_fwd(out[0], plain),
                               **_ulps_bf16(out[0], plain), "repeats": _repeats(fwd, out)},
                              {"pass": "bwd", **case, **grads, "repeats": _repeats(bwd, got)}):
                        _line("ragged", **e)
                        if not (e["ok"] and e["repeats"]):
                            failures.append(f"{e['pass']} {form} keep={keep_prob} N={n} J={j} "
                                            f"{dtype}")
                    if (b is None) != (got[3] is None):
                        failures.append(f"bwd {form} N={n} J={j}: dbias is wrong")
    if failures:
        raise AssertionError(f"attention kernels at ragged shapes: {failures}")


# (H, W, J) of the CPB backward: a 64-token bag (8 x 8 queries, 2 x 2 offsets, J = 4,
# under a warp's 32 lanes); W*J = 140, 407 and 648, none a multiple of the tensor-core
# kernel's 16-pair step; 648 spans two 512-lane tiles, the second cutting J = 72 apart
CPB_RAGGED = ((8, 8, 4), (9, 7, 20), (6, 11, 37), (5, 9, 72))


# the layer-2 mask check's boundary inputs: dx and dy take these values (a
# class of pairs is one (dx, dy) of them), w0x and w0y lie on the grid 1/16 and
# b0 on 1/64, so that layer 1 is exact in f32 in any order of its operations
MASK_DX = (-1.5, -0.5, 0.25, 1.0)
MASK_DY = (-1.0, -0.25, 0.5, 1.25)


def cpb_mask_inputs(h: int, w: int, j: int, dm: int, seed: int, boundary: bool = False,
                    device: str = "cuda", bg: int = BG) -> list:
    """f32 inputs (dx, dy, w0x, w0y, b0, w1, b1, w2, b2) of the layer-2 mask
    check, w2 and b2 zero (``cpb_mask_counts`` sets w2's column), drawn with
    numpy from ``seed``: as ``_cpb_inputs`` draws them or, with ``boundary``,
    dx and dy from MASK_DX and MASK_DY, w0x, w0y and b0 on their grids, and
    b1 = -(h1 w1) of the class (MASK_DX[0], MASK_DY[0]) evaluated in float64
    and rounded to f32: that class's z2 lies within the rounding of a sum of
    0 in every column, where another order of the sums may change its sign."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(dm, dm)) * dm ** -0.5
    if boundary:
        dx, dy = rng.choice(MASK_DX, size=(bg, w * j)), rng.choice(MASK_DY, size=(bg, h, j))
        w0x, w0y = rng.integers(-16, 17, size=(2, dm)) / 16
        b0 = rng.integers(-16, 17, size=dm) / 64
        h1 = np.maximum(w0x * MASK_DX[0] + w0y * MASK_DY[0] + b0, 0.0)     # exact
        b1 = -(h1 @ w1.astype(np.float32).astype(np.float64))
    else:
        dx, dy = rng.normal(size=(bg, w * j)) * 0.7, rng.normal(size=(bg, h, j)) * 0.7
        w0x, w0y = rng.normal(size=(2, dm)) * 0.7
        b0, b1 = rng.normal(size=(2, dm)) * 0.1
    return [torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
            for a in (dx, dy, w0x, w0y, b0, w1, b1, np.zeros((dm, 1)), np.zeros(1))]


def cpb_mask_counts(args: list, c: int) -> tuple:
    """(pairs with bias > 0, db1[c] from dbias = 1) of the CPB forward and
    backward (the kernels on CUDA tensors, the plain versions on CPU ones) on
    ``cpb_mask_inputs`` with w2 = e_c and b2 = 0.  Then each bias is exactly
    relu(z2[c]) (every other term of layer 3 is 0), and db1[c] = w2[c] sum
    [z2[c] > 0] g sums ones: both count the pairs whose z2[c] > 0, exactly in
    f32 below 2**24 pairs, the first by the forward's z2 and the second by the
    backward's."""
    from sml_tpu_torch.ops.kernels import cpb_bias, cpb_bias_bwd

    w2 = torch.zeros_like(args[7])
    w2[c, 0] = 1.0
    bias = cpb_bias(*args[:7], w2, args[8])
    db1 = cpb_bias_bwd(*args[:7], w2, torch.ones_like(bias))[6]
    return int((bias > 0).sum().item()), db1[c].item()


def cpb_mask_check(h: int, w: int, j: int, dm: int, boundary: bool) -> dict:
    """The mask check at one shape and dm on the card: ``cpb_mask_counts`` of
    every column on ``cpb_mask_inputs`` (seeded by dm and J), both counts of
    each column, the columns where they differ, and ``ok`` if none does."""
    args = cpb_mask_inputs(h, w, j, dm, seed=100 * dm + j, boundary=boundary)
    counts = [cpb_mask_counts(args, c) for c in range(dm)]
    bad = [c for c, (f, b) in enumerate(counts) if f != b]
    return {"pass": "mask", "h": h, "w": w, "j": j, "dm": dm, "bg": BG, "boundary": boundary,
            "fwd_counts": [f for f, _ in counts], "bwd_counts": [b for _, b in counts],
            "columns_unequal": bad, "pairs_unequal": sum(abs(f - b) for f, b in counts),
            "ok": not bad}


def phase_cpb_ragged() -> None:
    """The CPB forward and backward at ragged shapes, dm 8 / 16 / 32, f32 (the
    tf32 tensor-core kernels) and bf16 (the tensor-core kernels), against
    their plain versions (the forward at KERNEL_TOL, the backward at
    CPB_GRAD_L2), and two launches bit for bit; then, in f32, the layer-2
    mask check at each shape and dm for every column, on random and on
    boundary inputs (``cpb_mask_inputs``): the forward's and the backward's
    counts of z2 > 0 (``cpb_mask_counts``) must be equal."""
    from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                           cpb_bias_plain)

    g = torch.Generator(device="cuda").manual_seed(3)
    failures = []
    for h, w, j in CPB_RAGGED:
        for dm in (8, 16, 32):
            for dtype in (torch.float32, torch.bfloat16):
                args = _cpb_inputs(h, w, j, dtype, g, dm)
                dbias = (torch.randn(BG, h, w * j, device="cuda", generator=g) * 1e-3
                         ).to(dtype)
                case = {"h": h, "w": w, "j": j, "dm": dm, "bg": BG,
                        "dtype": str(dtype).split(".")[-1]}
                fwd = lambda: (cpb_bias(*args),)
                bias = fwd()
                torch.cuda.synchronize()
                bwd = lambda: cpb_bias_bwd(*args[:8], dbias)
                got = bwd()
                torch.cuda.synchronize()
                for e in ({"pass": "fwd", **case,
                           **_compare(bias[0], cpb_bias_plain(*args), KERNEL_TOL[dtype]),
                           "repeats": _repeats(fwd, bias)},
                          {"pass": "bwd", **case,
                           **_compare_grads(got, cpb_bias_bwd_plain(*args[:8], dbias),
                                            CPB_GRAD_L2, l2=True),
                           "repeats": _repeats(bwd, got)}):
                    _line("cpb-ragged", **e)
                    if not (e["ok"] and e["repeats"]):
                        failures.append(f"{e['pass']} H={h} W={w} J={j} dm={dm} {dtype}")
            for boundary in (False, True):
                e = cpb_mask_check(h, w, j, dm, boundary)
                _line("cpb-ragged", **e)
                if not e["ok"]:
                    failures.append(f"mask H={h} W={w} J={j} dm={dm} boundary={boundary} "
                                    f"columns {e['columns_unequal']}")
    if failures:
        raise AssertionError(f"CPB kernels at ragged shapes: {failures}")


def _span_work(span: torch.Tensor, n: int, j: int):
    """(valid pairs, uniform rows) of a span batch: what this data needs."""
    s = span.long().cpu()
    rows = (s[:, 1].clamp(max=n) - s[:, 0].clamp(min=0)).clamp(min=0)
    cols = (s[:, 3].clamp(max=j) - s[:, 2].clamp(min=0)).clamp(min=0)
    rows = torch.where(cols > 0, rows, 0)
    return int((rows * cols).sum()), int((n - rows).sum())


def _bucketed_spans(fixdim: int, n_pad: int):
    """(span3, span1) of 8 bags' token masks laid out as TransMIL lays them out
    (front pad, cls, bucketed patches), with an all-invalid bag (3), a short
    bag with invalid landmark rows (2), and an interval whose start lies past
    the first key tile of both chains (4)."""
    from sml_tpu_torch.ops.nystrom import landmark_spans

    pad = n_pad - (fixdim + 1)
    mask = torch.zeros(8, n_pad, dtype=torch.bool, device="cuda")
    for b, frac in enumerate((1.0, 0.75, 0.4, None, None, 0.55, 0.5, 0.9)):
        if frac is not None:
            mask[b, pad:pad + 1 + int(frac * fixdim)] = True
    start = n_pad // 2 + 100
    mask[4, start:start + n_pad // 4] = True
    span3, span1 = landmark_spans(mask, n_pad // NYSTROM_M, 8)
    heads = 8
    assert span3[3 * heads, :2].tolist() == [0, 0] and span1[3 * heads, 0] == 0
    assert span3[2 * heads, 0] > 0 and span3[2 * heads, 1] < NYSTROM_M
    assert span1[4 * heads, 2] >= 128 and span3[4 * heads, 2] >= 128
    return span3, span1


def phase_chains() -> dict:
    """The bias-less and span forms at the Nystrom chains of TransMIL; returns
    the entries of S2500 by (name, chain), the f32 ones' names ending in
    ``_f32``."""
    from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                           deform_attention_fwd, deform_attention_fwd_plain)
    from sml_tpu_torch.ops.kernels.deform_attn import _span_valid

    g = torch.Generator(device="cuda").manual_seed(1)
    entries, failures = {}, []
    for fixdim, n_pad in N_PAD.items():
        spans = dict(zip(("chain3", "chain1"), _bucketed_spans(fixdim, n_pad)))
        for dtype in (torch.float32, torch.bfloat16):
            for chain, (n, j) in (("chain1", (n_pad, NYSTROM_M)),
                                  ("chain3", (NYSTROM_M, n_pad))):
                q = (torch.randn(BG, n, DH, device="cuda", generator=g) * DH ** -0.5
                     ).to(dtype)
                k = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
                v = torch.randn(BG, j, DH, device="cuda", generator=g).to(dtype)
                dout = (torch.randn(BG, n, DH, device="cuda", generator=g) * 1e-2).to(dtype)
                rows = []
                for form in ("nobias", "span"):
                    span = spans[chain] if form == "span" else None
                    work = None if span is None else _span_work(span, n, j)
                    mask = None
                    if span is not None:
                        rv, cv = _span_valid(span, n, j)
                        mask = torch.zeros(BG, n, j, dtype=dtype, device="cuda"
                                           ).masked_fill_(~(rv & cv), float("-inf"))
                    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, dout, mask)
                    out = deform_attention_fwd(q, k, v, span=span)
                    torch.cuda.synchronize()
                    plain = deform_attention_fwd_plain(q, k, v, span=span)
                    size = torch.finfo(dtype).bits // 8
                    bound_ms, bound_by = _attn_bound(n, j, dtype, work=work)
                    f32 = dtype == torch.float32
                    rows.append({"name": f"deform_attention_fwd_{form}",
                                 **_compare_fwd(out, plain), **_ulps_bf16(out, plain),
                                 **(_f32_fwd_checks(out, plain, q, k, v, dout, span=span)
                                    if f32 else {}),
                                 "repeats": _repeats(lambda: (deform_attention_fwd(
                                     q, k, v, span=span),), (out,)),
                                 "ms": _time_ms(lambda: deform_attention_fwd(q, k, v,
                                                                             span=span)),
                                 "plain_ms": _time_ms(lambda: deform_attention_fwd_plain(
                                     q, k, v, span=span), iters=5),
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 **_tf32x3(_attn_work(n, j, size, work=work), dtype),
                                 "library_ms": lib_fwd})
                    got = deform_attention_bwd(q, k, v, None, dout, span=span)
                    torch.cuda.synchronize()
                    want = deform_attention_bwd_plain(q, k, v, None, dout, span=span)
                    bound_ms, bound_by = _attn_bound(n, j, dtype, bwd=True, work=work)
                    rows.append({"name": f"deform_attention_bwd_{form}",
                                 **_compare_grads(got[:3], want[:3], GRAD_RTOL[dtype]),
                                 "repeats": _repeats(lambda: deform_attention_bwd(
                                     q, k, v, None, dout, span=span), got),
                                 "ms": _time_ms(lambda: deform_attention_bwd(
                                     q, k, v, None, dout, span=span)),
                                 "plain_ms": _time_ms(lambda: deform_attention_bwd_plain(
                                     q, k, v, None, dout, span=span), iters=5),
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 **_tf32x3(_attn_work(n, j, size, bwd=True, work=work), dtype),
                                 "library_ms": lib_bwd})
                    if got[3] is not None:
                        failures.append("bias-less backward returned a bias gradient")
                    del out, plain, got, want, mask
                for e in rows:
                    e.update(chain=chain, fixdim=fixdim, dtype=str(dtype).split(".")[-1],
                             bg=BG, n=n, j=j)
                    e["ok"] &= e.get("lse_equal_bwd", True)
                    _line("chains", **e)
                    if not e["ok"] or not e.get("repeats", True):
                        failures.append(f"{e['name']} {chain} fixdim={fixdim} {dtype}")
                    if fixdim == MAIN_FIXDIM:
                        entries[(e["name"] + ("_f32" if dtype == torch.float32 else ""),
                                 chain)] = e
                del q, k, v, dout
                torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    return entries


def _refusals() -> dict:
    """Every dh = 32 form but CMTA's (f32, no bias, span or dropout) at a
    ragged shape: the wrapper must raise, and the C entries, called directly,
    must return cudaErrorInvalidValue (1) before launching anything."""
    from sml_tpu_torch.ops.kernels import deform_attention_bwd, deform_attention_fwd
    from sml_tpu_torch.ops.kernels.deform_attn import _library

    n, j, f32 = 100, 20, torch.float32
    q, k, v, dout = (torch.randn(BG, r, CMTA_DH, device="cuda") for r in (n, j, j, n))
    bias = torch.randn(BG, n, j, device="cuda")
    span = _interval_spans(n, j)
    cases = {"bf16": ((q, k, v, dout), None, None, 1.0),
             "bias": ((q, k, v, dout), bias, None, 1.0),
             "span": ((q, k, v, dout), None, span, 1.0),
             "dropout": ((q, k, v, dout), None, None, KEEP_PROB)}
    result = {}
    fwd_lib, bwd_lib = _library("deform_attn"), _library("deform_attn_bwd")
    scratch = torch.empty(2, BG, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for form, (tensors, b, sp, keep_prob) in cases.items():
        if form == "bf16":
            tensors = tuple(t.to(torch.bfloat16) for t in tensors)
        qq, kk, vv, do = tensors
        raised = []
        for call in (lambda: deform_attention_fwd(qq, kk, vv, b, keep_prob, SEED, sp),
                     lambda: deform_attention_bwd(qq, kk, vv, b, do, keep_prob, SEED, sp)):
            try:
                call()
                raised.append(False)
            except ValueError:
                raised.append(True)
        code = 1 if form == "bf16" else 0
        ptr = lambda t: None if t is None else t.data_ptr()
        rc_fwd = fwd_lib.deform_attn_fwd(code, code, qq.data_ptr(), kk.data_ptr(),
                                         vv.data_ptr(), ptr(b), ptr(sp), do.data_ptr(), None,
                                         BG, n, j, CMTA_DH, keep_prob, 1.0 / keep_prob, SEED,
                                         q.device.index, stream)
        rc_bwd = bwd_lib.deform_attn_bwd(code, code, qq.data_ptr(), kk.data_ptr(),
                                         vv.data_ptr(), ptr(b), ptr(sp), do.data_ptr(),
                                         do.data_ptr(), do.data_ptr(), do.data_ptr(), None,
                                         scratch[0].data_ptr(), scratch[1].data_ptr(), None,
                                         BG, n, j, CMTA_DH, keep_prob, 1.0 / keep_prob,
                                         SEED, q.device.index, stream)
        result[form] = {"wrapper_raised": raised, "c_entry_rc": [rc_fwd, rc_bwd],
                        "ok": all(raised) and rc_fwd == rc_bwd == 1}
    torch.cuda.synchronize()
    return result


def _err_of_scale(got, want) -> float:
    """The largest max|kernel - plain| / max|plain| over the gradients."""
    return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def _bwd_f64(q, k, v, dout):
    """(dq, dk, dv) of the bias-less attention without span or dropout in
    float64: the yardstick of both the kernel and the f32 plain version."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(torch.einsum("bnd,bjd->bnj", q, k), dim=-1)
    dp = torch.einsum("bnd,bjd->bnj", dout, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (torch.einsum("bnj,bjd->bnd", ds, k), torch.einsum("bnj,bnd->bjd", ds, q),
            torch.einsum("bnj,bnd->bjd", p, dout))


def _fwd_f64(q, k, v, bias=None, keep=None, keep_prob: float = 1.0, span=None):
    """The attention forward in float64 (the plain version's masking, the
    {0, 1} ``keep`` mask at ``keep_prob``): the yardstick of both the kernel
    and the f32 plain version."""
    from sml_tpu_torch.ops.kernels.deform_attn import NEG_MAX, _span_valid

    sim = torch.einsum("bnd,bjd->bnj", q.double(), k.double())
    if bias is not None:
        sim = sim + bias.double()
    if span is not None:
        rv, cv = _span_valid(span, q.shape[1], k.shape[1])
        sim = torch.where(rv, torch.where(cv, sim, NEG_MAX), 0.0)
    p = torch.softmax(sim, dim=-1)
    if keep is not None:
        p = p * keep.double() / keep_prob
    return torch.einsum("bnj,bjd->bnd", p, v.double())


# the roles of the dh = 32 kernels in a profiler's (demangled) kernel names:
# the forward's statistics, outputs (both in one launch with one key segment)
# and the backward's rows and keys, and the sum of the segments' partials
FWD_ROLES = {"true, false": "stats", "false, true": "out", "true, true": "stats_out"}


def _dh32_role(name: str):
    m = re.search(r"attn_fwd_tf32<(\w+), ?(\w+)>", name)
    if m:
        return FWD_ROLES[f"{m.group(1)}, {m.group(2)}"]
    m = re.search(r"attn_bwd_(rows|keys|combine)", name)
    return m.group(1) if m else None


def _parts_ms(fn, iters: int = 10) -> dict:
    """Device ms per call of a dh = 32 wrapper's kernels by role (the
    forward's stats, out and combine; the backward's rows, keys and combine),
    from torch.profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        role = _dh32_role(e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and role:
            ms[role] = ms.get(role, 0.0) + e.self_device_time_total / 1e3 / iters
    return ms


def _lse_fwd_bwd(q, k, v, dout, bias=None, span=None, keep_prob: float = 1.0):
    """Each row's lse as the f32 forward (dh = 32 or 64) leaves it in its
    scratch and as the backward's rows kernel writes it, by their C entries
    (the wrappers return neither); (BG, N) f32 each."""
    from sml_tpu_torch.ops.kernels.deform_attn import _library

    bg, n, dh = q.shape
    j = k.shape[1]
    fwd_lib, bwd_lib = _library("deform_attn"), _library("deform_attn_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    work = torch.empty(fwd_lib.deform_attn_fwd_work(0, bg, n, j, dh), device="cuda")
    n_bwd = bwd_lib.deform_attn_bwd_work(0, bg, n, j, dh)
    bwd_work = torch.empty(n_bwd, device="cuda") if n_bwd else None
    stats = torch.empty(2, bg, n, device="cuda")
    out, grads = torch.empty_like(q), [torch.empty_like(t) for t in (q, k, v)]
    dbias = None if bias is None else torch.empty_like(bias)
    rc = [fwd_lib.deform_attn_fwd(0, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias),
                                  ptr(span), out.data_ptr(), work.data_ptr(), bg, n, j, dh,
                                  keep_prob, 1.0 / keep_prob, SEED, q.device.index, stream),
          bwd_lib.deform_attn_bwd(0, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias),
                                  ptr(span), dout.data_ptr(), *(t.data_ptr() for t in grads),
                                  ptr(dbias), stats[0].data_ptr(), stats[1].data_ptr(),
                                  ptr(bwd_work), bg, n, j, dh, keep_prob, 1.0 / keep_prob,
                                  SEED, q.device.index, stream)]
    if any(rc):
        raise RuntimeError(f"f32 attention C entries returned {rc}")
    torch.cuda.synchronize()
    return work[:bg * n].view(bg, n), stats[0]


def _lse_fields(lse_fwd, lse_bwd) -> dict:
    """``lse_equal_bwd`` (the same walk, sums and order: equal by
    construction) and, where they differ, the largest difference in f32 ulps."""
    e = {"lse_equal_bwd": torch.equal(lse_fwd, lse_bwd)}
    if not e["lse_equal_bwd"]:
        e["lse_ulps"] = (lse_fwd.view(torch.int32).long()
                         - lse_bwd.view(torch.int32).long()).abs().max().item()
    return e


def _f32_fwd_checks(out, plain, q, k, v, dout, bias=None, keep=None,
                    keep_prob: float = 1.0, span=None) -> dict:
    """An f32 dh = 64 forward's largest error against float64 beside the
    plain version's, and its lse against the backward's (``lse_equal_bwd``,
    which the caller requires)."""
    exact = _fwd_f64(q, k, v, bias, keep, keep_prob, span)
    return {"max_err_f64": (out.double() - exact).abs().max().item(),
            "plain_err_f64": (plain.double() - exact).abs().max().item(),
            **_lse_fields(*_lse_fwd_bwd(q, k, v, dout, bias, span, keep_prob))}


def _tf32_usage() -> list:
    """Registers and spill stores of the tf32 kernels (ptxas): dh = 32, and
    the f32 dh = 64 forward and backward."""
    from sml_tpu_torch.ops.kernels import _build

    return [{"kernel": name, "registers": regs, "spill_stores": spill}
            for src in ("deform_attn", "deform_attn_bwd")
            for name, (regs, spill) in _build.kernel_usage(_build.build_log(src)).items()
            if "tf32" in name]


def dh32_cases() -> list:
    """(name, N, J) of the cmta-kernels phase: CMTA's chain 3 and chain 1, both
    chains of the bucketed bags, the ragged shapes and their transposes; their
    inputs are drawn in this order from a generator seeded with DH32_SEED
    (``scripts/stress_dh32.py`` repeats them)."""
    cases = [("chain3", CMTA_M, CMTA_NPAD), ("chain1", CMTA_NPAD, CMTA_M)]
    cases += [(f"bucket{n_pad}_{c}", *shape) for n_pad in CMTA_BUCKETED
              for c, shape in (("chain3", (CMTA_M, n_pad)), ("chain1", (n_pad, CMTA_M)))]
    return cases + [("ragged", *shape) for n, j in RAGGED for shape in ((n, j), (j, n))]


def phase_cmta_kernels() -> dict:
    """The f32 dh = 32 forms (no bias, span or dropout) of the attention
    forward and backward at CMTA's chain 3 and chain 1 of a 2500-patch bag, at
    both chains of the bucketed bags (1152 and 4224 tokens) and at the ragged
    (N, J) of phase 3 and their transposes, against their plain versions,
    repeated bit for bit; the backward's largest error of each gradient's
    scale beside DH32_ERR_AIM; the kernels' and the plain versions' errors
    against float64; the forward's lse against the backward's; at the chains
    and the bucketed chains both timed beside the plain versions and
    F.scaled_dot_product_attention in f32 without a mask, their kernels by
    role apart (the forward's stats, out and combine; the backward's rows,
    keys and combine), each bound on the CUDA cores and at 3xTF32 on the
    tf32 tensor cores; the registers of the tf32 kernels; then the refusals
    of every other dh = 32 form.  Returns the chains' entries by (name,
    chain)."""
    from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                           deform_attention_fwd, deform_attention_fwd_plain)

    _line("cmta-kernels", ptxas=_tf32_usage())
    g = torch.Generator(device="cuda").manual_seed(DH32_SEED)
    f32, dh, size = torch.float32, CMTA_DH, 4
    entries, failures = {}, []
    for chain, n, j in dh32_cases():
        q = torch.randn(BG, n, dh, device="cuda", generator=g) * dh ** -0.5
        k, v = torch.randn(2, BG, j, dh, device="cuda", generator=g)
        dout = torch.randn(BG, n, dh, device="cuda", generator=g) * 1e-2
        timed = chain != "ragged"
        pairs = BG * n * j
        fwd = lambda: (deform_attention_fwd(q, k, v),)
        out = fwd()
        torch.cuda.synchronize()
        plain = deform_attention_fwd_plain(q, k, v)
        exact = _fwd_f64(q, k, v)
        fwd_e = {"name": "deform_attention_fwd_dh32", "pass": "fwd",
                 **_compare_fwd(out[0], plain), "repeats": _repeats(fwd, out),
                 "max_err_f64": (out[0].double() - exact).abs().max().item(),
                 "plain_err_f64": (plain.double() - exact).abs().max().item(),
                 **_lse_fields(*_lse_fwd_bwd(q, k, v, dout))}
        del exact
        bwd = lambda: deform_attention_bwd(q, k, v, None, dout)
        got = bwd()
        torch.cuda.synchronize()
        want = deform_attention_bwd_plain(q, k, v, None, dout)
        err = _err_of_scale(got[:3], want[:3])
        exact = _bwd_f64(q, k, v, dout)
        bwd_e = {"name": "deform_attention_bwd_dh32", "pass": "bwd",
                 **_compare_grads(got[:3], want[:3], GRAD_RTOL[f32]),
                 "max_err_of_scale": err, "err_aim": DH32_ERR_AIM,
                 "within_aim": err <= DH32_ERR_AIM,
                 # both against float64: the plain f32 version's own error is of
                 # the same size at the long sums
                 "max_err_of_scale_f64": _err_of_scale(got[:3], exact),
                 "plain_err_of_scale_f64": _err_of_scale(want[:3], exact),
                 "repeats": _repeats(bwd, got)}
        del exact
        if got[3] is not None:
            failures.append("the dh = 32 backward returned a bias gradient")
        if timed:
            lib_fwd, lib_bwd = _sdpa_ms(q, k, v, dout, None)
            # (entry, bytes, f32 products of 2 dh FLOP a pair, plain, library)
            for e, n_bytes, products, plain_fn, lib_ms in (
                    (fwd_e, size * (2 * BG * n * dh + 2 * BG * j * dh), 2,
                     lambda: deform_attention_fwd_plain(q, k, v), lib_fwd),
                    (bwd_e, size * (3 * BG * n * dh + 4 * BG * j * dh), 5,
                     lambda: deform_attention_bwd_plain(q, k, v, None, dout), lib_bwd)):
                run = fwd if e is fwd_e else bwd
                bound_ms, bound_by = _bound(n_bytes, 2 * products * dh * pairs, f32)
                e.update(ms=_time_ms(run), parts_ms=_parts_ms(run),
                         plain_ms=_time_ms(plain_fn, iters=5), bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms,
                         **_tf32x3((n_bytes, 2 * products * dh * pairs), f32))
        for e in (fwd_e, bwd_e):
            e.update(chain=chain, dtype="float32", dh=dh, bg=BG, n=n, j=j)
            if not (e["ok"] and e["repeats"]):
                # a diagnosis, not a second chance: whether three more launches
                # agree with the plain version tells a fault that comes and goes
                # from one in the result; the entry fails either way
                e["reruns_ok"] = [
                    _compare_fwd(fwd()[0], plain)["ok"] if e is fwd_e
                    else _compare_grads(bwd()[:3], want[:3], GRAD_RTOL[f32])["ok"]
                    for _ in range(3)]
                failures.append(f"{e['pass']} {chain} N={n} J={j}: ok={e['ok']} "
                                f"repeats={e['repeats']} max_abs_err={e['max_abs_err']} "
                                f"reruns_ok={e['reruns_ok']}")
            _line("cmta-kernels", **e)
            if chain in ("chain3", "chain1"):
                entries[(e["name"], chain)] = e
        del q, k, v, dout, out, plain, got, want
        torch.cuda.empty_cache()
    refused = _refusals()
    _line("cmta-kernels", refusals=refused)
    failures += [f"dh 32 {form} not refused" for form, r in refused.items() if not r["ok"]]
    if failures:
        raise AssertionError(f"dh = 32 attention kernels: {failures}")
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

    def fwd(q, k, v, bias=None, keep_prob=1.0, seed=0, span=None):
        return attn.deform_attention_fwd_plain(q, k, v, bias, keep(q, k, keep_prob, seed),
                                               keep_prob, span)

    def bwd(q, k, v, bias, dout, keep_prob=1.0, seed=0, span=None):
        return attn.deform_attention_bwd_plain(q, k, v, bias, dout,
                                               keep(q, k, keep_prob, seed), keep_prob, span)

    with mock.patch.object(cpb, "cpb_bias", cpb.cpb_bias_plain), \
            mock.patch.object(cpb, "cpb_bias_bwd", cpb.cpb_bias_bwd_plain), \
            mock.patch.object(attn, "deform_attention_fwd", fwd), \
            mock.patch.object(attn, "deform_attention_bwd", bwd):
        yield


# the launches of each wrapper (and form) per batch of the serving path and per
# train step of the training path; every other count must stay 0
SERVE_LAUNCHES = {
    "deformpathomic": {"cpb_bias": 2, "deform_attention_fwd": 2},
    "transmil": {"deform_attention_fwd": 4, "deform_attention_fwd_nobias": 4},
    "deform1d": {"deform_attention_fwd": 2, "deform_attention_fwd_f32bias": 2},
    "cmta": {"deform_attention_fwd": 8, "deform_attention_fwd_nobias": 8,
             "deform_attention_fwd_dh32": 8}}
TRAIN_LAUNCHES = {
    "deformpathomic": {"cpb_bias": 2, "cpb_bias_bwd": 2, "deform_attention_fwd": 2,
                       "deform_attention_bwd": 2, "deform_attention_fwd_dropout": 2},
    "transmil": {"deform_attention_fwd": 4, "deform_attention_fwd_nobias": 4,
                 "deform_attention_bwd": 4, "deform_attention_bwd_nobias": 4},
    "deform1d": {"deform_attention_fwd": 2, "deform_attention_bwd": 2,
                 "deform_attention_fwd_f32bias": 2, "deform_attention_bwd_f32bias": 2},
    "cmta": {"deform_attention_fwd": 8, "deform_attention_fwd_nobias": 8,
             "deform_attention_fwd_dh32": 8, "deform_attention_bwd": 8,
             "deform_attention_bwd_nobias": 8, "deform_attention_bwd_dh32": 8}}
# the f32 forms that the default compute dtype (float32) adds to
# TRAIN_LAUNCHES per train step: every attention launch of deformpathomic and
# TransMIL in the f32 dh = 64 form, both directions, and every CPB launch of
# deformpathomic in f32 (both directions on the tf32 kernels)
F32_LAUNCHES = {"deformpathomic": {"deform_attention_fwd_f32": 2, "deform_attention_bwd_f32": 2,
                                   "cpb_bias_f32": 2, "cpb_bias_bwd_f32": 2},
                "transmil": {"deform_attention_fwd_f32": 4, "deform_attention_bwd_f32": 4}}
# the span forms that a masked bag adds to TRAIN_LAUNCHES per train step (and,
# the forward's, to SERVE_LAUNCHES per eval batch): TransMIL's four masked
# chains; deformpathomic zeroes its masked tokens and passes no span
BUCKETED_SPAN = {"transmil": {"deform_attention_fwd_span": 4, "deform_attention_bwd_span": 4},
                 "deformpathomic": {}}
OUTPUTS = {"deformpathomic": ("logits", "logits_tumor", "logits_immune", "features"),
           "transmil": ("logits", "features"),
           "deform1d": ("logits", "logits_tumor", "logits_immune", "features"),
           "cmta": ("logits", "hazards", "S", "P", "P_hat", "G", "G_hat")}
TRAIN_METRICS = {"deformpathomic": {"loss", "loss3", "batch_sim_loss"},
                 "transmil": {"loss", "loss3"}, "deform1d": {"loss", "loss3"},
                 "cmta": {"loss", "loss3", "alignment_loss"}}


def _flags(path: str, **extra) -> dict:
    base = {"dataset": "synthetic", "batch_size": 8, "compute_dtype": "bfloat16"}
    return {**base, **PATH_FLAGS.get(path, {}), **extra}


def phase_slice(fixdim: int, card: dict, path: str = "deformpathomic",
                label: str = "") -> dict:
    """The serving path of ``path`` at ``fixdim``; returns the kernels' launch
    counts.  Its line is labelled ``label`` (default: the path's)."""
    from sml_tpu_torch import inference
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, model_inputs
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_eval_step

    flags = _flags(path, synthetic_size=64, fixdim=fixdim)
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
    want = {k: SERVE_LAUNCHES[path].get(k, 0) * len(loader) for k in launches}
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
    tol = SLICE_TOL[config.compute_dtype]
    checks = {k: _compare(out[k], out_plain[k], tol) for k in OUTPUTS[path]}
    checks.update({f"step_{k}": _compare(res[k], res_plain[k], tol) for k in res})
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
    _line(label or LABELS[path][0], run="serve", fixdim=fixdim,
          batch=config.batch_size, dtype=config.compute_dtype, metrics=metrics,
          launches=launches,
          expected_launches=want, entry_point_wall_s=round(wall_s, 2),
          max_abs_err={k: c["max_abs_err"] for k, c in checks.items()},
          tol=tol, eval_step_ms=step_ms,
          bags_per_s=config.batch_size / (step_ms / 1e3), h2d_ms=h2d_ms,
          peak_mem_gb=peak_gb, card=card["nvidia_smi"])
    return launches


def _grad_snapshot(grad_step, model, batch, seed: int):
    """(metrics, {name: grad}) of one grad step with fresh generators from ``seed``."""
    from sml_tpu_torch.ops.common import DropoutRNG

    metrics = grad_step(batch, DropoutRNG.from_seed(seed, "cuda"))
    return ({k: v.float().item() for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def _train_entry(flags: dict, ckpt: str):
    """``sml_tpu_torch.main.main`` on ``flags``: (rc, printed, launches of the
    whole run, launches of its Val / Test passes, wall seconds)."""
    from sml_tpu_torch import main as train_main
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sml_tpu_torch.train import loop

    eval_counts = []
    evaluate = loop.evaluate

    def counted_evaluate(*args, **kwargs):
        before = launch_counts()
        result = evaluate(*args, **kwargs)
        after = launch_counts()
        eval_counts.append({k: after[k] - before[k] for k in after})
        return result

    argv = [f"--{k}={v}" for k, v in flags.items()] + [f"--checkpoints={ckpt}",
                                                      "--device=cuda"]
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
    eval_l = {k: sum(c[k] for c in eval_counts) for k in total}
    return rc, printed, total, eval_l, wall_s


def _epoch_metrics(printed: str):
    """(train, val, test) metrics of the first epoch line ``main.main`` printed."""
    train_m = ast.literal_eval(printed.split(" train=")[1].splitlines()[0])
    evals = printed.split(" val=")[1]
    val_m = ast.literal_eval(evals.split(" test=")[0])
    return train_m, val_m, ast.literal_eval(evals.split(" test=")[1].split(" elapsed_sec")[0])


def _train_step_ms(config, model, batch, steps: int, iters: int = 10):
    """(median host ms of a train step on a device-resident batch, optimizer
    step included; peak device GB over those steps)."""
    from sml_tpu_torch.models.factory import define_optimizer
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.train.state import TrainState
    from sml_tpu_torch.train.steps import make_train_step

    optimizer, scheduler = define_optimizer(config, model, steps)
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(1, "cuda"))
    train_step = make_train_step(config, model)
    for _ in range(2):
        train_step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    step_ms = statistics.median(_host_ms(lambda: train_step(state, batch))
                                for _ in range(iters))
    return step_ms, torch.cuda.max_memory_allocated() / 1e9


def _batch_stats(npz_path: str) -> dict:
    """The BatchNorm running averages stored in a weights file: {key: (finite,
    moved off the init's 0 / 1)}."""
    import numpy as np

    with np.load(npz_path) as data:
        return {k: (bool(np.isfinite(data[k]).all()),
                    not np.allclose(data[k], 0.0 if k.endswith("/mean") else 1.0))
                for k in data.files if k.startswith("batch_stats/")}


def phase_train(card: dict, path: str = "deformpathomic", extra: dict | None = None,
                label: str = "", default_dtype: bool = False) -> dict:
    """The training path of ``path`` (with the config flags ``extra``) at S2500
    through ``sml_tpu_torch.main``; returns the kernels' launch counts of that
    run.  With a BatchNorm in the model, its running averages in
    ``best_modal.npz`` must have moved and be finite, and ``inference.main
    --weights`` must reproduce the best epoch's Test metrics.  With
    ``default_dtype`` no ``--compute_dtype`` is passed: the config's default,
    float32, whose dh = 64 attention launches count in F32_LAUNCHES."""
    import tempfile

    import numpy as np

    from sml_tpu_torch import inference
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_grad_step

    flags = _flags(path, synthetic_size=32 if path == "transmil" else 64,
                   fixdim=MAIN_FIXDIM, epochs=1, **(extra or {}))
    if default_dtype:
        del flags["compute_dtype"]
    config = Config(**flags)
    steps = len(Loader(build_datasets(config, "Train"), config.batch_size, drop_last=True))
    per_step = {**TRAIN_LAUNCHES[path], **(F32_LAUNCHES[path] if default_dtype else {})}
    with tempfile.TemporaryDirectory() as ckpt:
        rc, printed, total, eval_l, wall_s = _train_entry(flags, ckpt)
        train_m, _, test_m = _epoch_metrics(printed)
        train_l = {k: total[k] - eval_l[k] for k in total}
        want = {k: per_step.get(k, 0) * steps for k in total}
        if rc != 0 or train_l != want:
            raise AssertionError(f"train-step launches {train_l}, expected {want} (rc={rc})")
        if eval_l["cpb_bias_bwd"] or eval_l["deform_attention_bwd"] or \
                eval_l["deform_attention_fwd_dropout"]:
            raise AssertionError(f"eval launched a training kernel: {eval_l}")
        if set(train_m) != TRAIN_METRICS[path] or \
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
        stats = _batch_stats(weights)
        served_err = None
        if stats:
            # one epoch: its Test metrics are the best epoch's
            served_err = {k: abs(served[k] - test_m[k]) for k in test_m}
            if not all(finite and moved for finite, moved in stats.values()) or \
                    set(served) != set(test_m) or max(served_err.values()) > 1e-5:
                raise AssertionError(f"BatchNorm statistics {stats}; served {served} vs "
                                     f"Test {test_m}")

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
    loss_tol, grad_tol = TRAIN_TOL[config.compute_dtype]
    ok = (all(e <= loss_tol for e in loss_err.values())
          and all(r <= grad_tol for r in rel.values())
          and all(bool(torch.isfinite(g).all()) for g in g_k.values()))

    # time per train step on a device-resident batch (optimizer step included)
    step_ms, peak_gb = _train_step_ms(config, model, batch, steps)
    _line(label or LABELS[path][1], run="train", fixdim=MAIN_FIXDIM,
          batch=config.batch_size, dtype=config.compute_dtype, flags=extra or {},
          steps=steps, train_metrics=train_m, served_metrics=served, weight_leaves=n_leaves,
          batch_stats=stats, served_vs_test_abs_err=served_err,
          launches_total=total, launches_train_steps=train_l, launches_eval=eval_l,
          entry_point_wall_s=round(wall_s, 2), loss_kernel=m_k, loss_plain=m_p,
          loss_abs_err=loss_err, loss_tol=loss_tol,
          grad_rel_l2_top5=top, grad_floor=floor, grad_tol=grad_tol,
          grads_compared=len(rel), ok=ok, train_step_ms=step_ms,
          bags_per_s=config.batch_size / (step_ms / 1e3), peak_mem_gb=peak_gb,
          card=card["nvidia_smi"])
    if not ok:
        raise AssertionError(f"train step through kernels vs plain versions: loss "
                             f"{loss_err}, worst gradient {worst} {rel[worst]}")
    return total


def phase_f32_train(card: dict) -> dict:
    """Phase 6 for deformpathomic and for TransMIL at the default compute dtype
    (no ``--compute_dtype``: float32), whose attention runs the f32 dh = 64
    forms: every backward launch (2 and 4 per train step) counted as the f32
    form of the tf32 kernels, and deformpathomic's CPB forward and backward
    launches (2 each) as their f32 forms (``cpb_bias_f32``,
    ``cpb_bias_bwd_f32``), finite losses, one train step's loss and
    gradients through the kernels against the plain versions at
    TRAIN_TOL["float32"]; returns the launch counts by path."""
    return {path: phase_train(card, path, label="f32-train", default_dtype=True)
            for path in ("deformpathomic", "transmil")}


def phase_bucketed(card: dict, path: str = "transmil", label: str = "bucketed") -> dict:
    """TransMIL (or deformpathomic) trained for one epoch on bucketed masked
    bags, then Val and Test; returns the kernels' launch counts of that run.
    TransMIL's masked chains run the span forms; deformpathomic zeroes its
    masked tokens and runs its forms without a span."""
    import tempfile
    import warnings

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import BucketedLoader, build_datasets
    from sml_tpu_torch.train import loop

    flags = _flags(path, synthetic_size=48, fixdim=MAIN_FIXDIM, epochs=1,
                   variable_bags=True, bucket_sizes="1024,2500")
    config = Config(**flags)
    train_ds = build_datasets(config, "Train")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a bucket smaller than a batch never trains
        loader = BucketedLoader(train_ds, config.batch_size, shuffle=True, drop_last=True,
                                seed=config.seed)
        steps = len(loader)
        per_bucket = {}
        for chunk in loader._index_batches():
            b = train_ds.bucket_of(int(chunk[0]))
            per_bucket[b] = per_bucket.get(b, 0) + 1
    finite = {"train": [], "eval": []}
    make_train, make_eval = loop.make_train_step, loop.make_eval_step

    def checked_train_step(config_, model):
        step = make_train(config_, model)

        def run(state, batch):
            metrics = step(state, batch)
            finite["train"].append(torch.stack([torch.isfinite(v).all()
                                                for v in metrics.values()]).all())
            return metrics
        return run

    def checked_eval_step(config_, model):
        step = make_eval(config_, model)

        def run(batch):
            result = step(batch)
            finite["eval"].append(torch.stack([torch.isfinite(v).all()
                                               for v in result.values()]).all())
            return result
        return run

    with tempfile.TemporaryDirectory() as ckpt, warnings.catch_warnings(), \
            mock.patch.object(loop, "make_train_step", checked_train_step), \
            mock.patch.object(loop, "make_eval_step", checked_eval_step):
        warnings.simplefilter("ignore")
        rc, printed, total, eval_l, wall_s = _train_entry(flags, ckpt)
    train_l = {k: total[k] - eval_l[k] for k in total}
    span = BUCKETED_SPAN[path]
    want = {k: (TRAIN_LAUNCHES[path].get(k, 0) + span.get(k, 0)) * steps for k in total}
    eval_batches = len(finite["eval"])
    want_eval = {k: (SERVE_LAUNCHES[path].get(k, 0) + (span.get(k, 0) if "_fwd" in k else 0))
                 * eval_batches for k in total}
    eval_ok = eval_batches > 0 and eval_l == want_eval
    all_finite = {k: len(v) > 0 and bool(torch.stack(v).all()) for k, v in finite.items()}
    train_m, val_m, test_m = _epoch_metrics(printed)
    ok = (rc == 0 and train_l == want and eval_ok and all(all_finite.values())
          and all(math.isfinite(v) for m in (train_m, val_m, test_m) for v in m.values()))
    _line(label, run="train", path=path, buckets=config.bucket_list(), steps=steps,
          eval_batches=eval_batches,
          train_batches_per_bucket=per_bucket, launches_total=total,
          launches_train_steps=train_l, expected_train_launches=want,
          launches_eval=eval_l, expected_eval_launches=want_eval, batches_finite=all_finite,
          batches_checked={k: len(v) for k, v in finite.items()}, train_metrics=train_m,
          val_metrics=val_m, test_metrics=test_m, entry_point_wall_s=round(wall_s, 2),
          ok=ok, card=card["nvidia_smi"])
    if not ok:
        raise AssertionError(f"bucketed {path} run: see the [{label}] line")
    return total


# the modes that run no kernel: (name, flags), one short epoch each
MODES = (("omic", {"mode": "omic"}),
         ("path-abmil", {"mode": "path"}),
         ("path-abmil-bucketed", {"mode": "path", "variable_bags": True,
                                  "bucket_sizes": "1024,2500", "synthetic_size": 48}),
         ("pathomic", {"mode": "pathomic"}),
         ("pathomic-pofusion", {"mode": "pathomic", "fusion_type": "pofusion"}),
         ("pathomic_original", {"mode": "pathomic_original"}),
         ("mcat", {"mode": "mcat", "task_type": "survival"}),
         ("mcat-bilinear", {"mode": "mcat", "task_type": "survival",
                            "coattn_fusion": "bilinear"}))
# CMTA in bf16: the Nystrom gate admits no chain at dh = 32 (64 bytes a row);
# one train step of 8 bags (full width), to keep the run within its time
CMTA_BF16 = (("cmta-bf16", {"mode": "cmta", "task_type": "survival", "synthetic_size": 8}),)


def phase_modes(card: dict, modes=MODES, label: str = "modes") -> None:
    """``modes`` (default: omic, path with ABMIL (fixed and bucketed bags),
    pathomic (concat and pofusion), pathomic_original and MCAT (concat and
    bilinear)): one short epoch each through ``main.main`` at fixdim 2500 (B
    = 8, bf16), no kernel launch, finite metrics, and a train step's time on a
    device-resident batch."""
    import tempfile
    import warnings

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.train.evaluate import batch_to_device

    failures = []
    for name, extra in modes:
        flags = _flags("", **{"synthetic_size": 16, "fixdim": MAIN_FIXDIM, "epochs": 1,
                              **extra})
        config = Config(**flags)
        with tempfile.TemporaryDirectory() as ckpt, warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a bucket smaller than a batch never trains
            rc, printed, total, _, wall_s = _train_entry(flags, ckpt)
            loader_cls = BucketedLoader if config.bucket_list() else Loader
            loader = loader_cls(build_datasets(config, "Train"), config.batch_size,
                                shuffle=True, drop_last=True, seed=config.seed)
            steps = len(loader)
            batch = next(iter(loader))
        train_m, val_m, test_m = _epoch_metrics(printed)
        batch.pop("sample_mask")
        model = define_net(config, "cuda", train=True)
        step_ms, peak_gb = _train_step_ms(config, model,
                                          batch_to_device(config, batch, torch.device("cuda")),
                                          steps, iters=5)
        ok = (rc == 0 and steps > 0 and not any(total.values())
              and all(math.isfinite(v) for m in (train_m, val_m, test_m) for v in m.values()))
        _line(label, run=name, flags=extra, steps=steps, launches=total,
              train_metrics=train_m, val_metrics=val_m, test_metrics=test_m,
              entry_point_wall_s=round(wall_s, 2), train_step_ms=step_ms,
              bags_per_s=config.batch_size / (step_ms / 1e3), peak_mem_gb=peak_gb, ok=ok,
              card=card["nvidia_smi"])
        if not ok:
            failures.append(name)
        del model
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{label} runs without kernels: {failures}")


def _state_files(ckpt: str) -> dict:
    """{kind: names} of the files a train run leaves in its checkpoint dir."""
    import os

    names = sorted(os.listdir(ckpt))
    best = [n for n in names if re.fullmatch(r"epoch_\d+_.*_\.npz", n)]
    return {"fixed": [n for n in names if n not in best], "best_named": best}


RESUME_FILES = ["best_modal.npz", "last_state.pt", "last_state_meta.json", "metrics.jsonl"]


def _state_diff(a, b, prefix: str = "") -> dict:
    """{path: distance} between two nested train states (``TrainState.
    state_dict``): a floating tensor's relative L2 distance ||b - a|| / ||a||,
    every other leaf 0 where it is equal and inf where it is not."""
    if isinstance(a, dict) or isinstance(a, (list, tuple)):
        items = a.items() if isinstance(a, dict) else enumerate(a)
        other = b if isinstance(b, dict) else dict(enumerate(b))
        if len(a) != len(other):
            return {prefix: math.inf}
        out = {}
        for k, v in items:
            path = f"{prefix}/{k}" if prefix else str(k)
            out.update(_state_diff(v, other[k], path) if k in other else {path: math.inf})
        return out
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
            return {prefix: math.inf}
        if torch.equal(a, b):
            return {prefix: 0.0}
        if a.is_floating_point():
            a32, b32 = a.float(), b.float()
            return {prefix: ((b32 - a32).norm() / a32.norm().clamp_min(1e-12)).item()}
        return {prefix: math.inf}
    return {prefix: 0.0 if a == b else math.inf}


def _plant_fresh_optimizer(state: dict, config) -> None:
    state["optimizer"]["state"] = {}                     # Adam's moments lost


def _plant_restarted_scheduler(state: dict, config) -> None:
    state["scheduler"]["last_epoch"] = 0                 # cosine from its start


def _plant_lost_generators(state: dict, config) -> None:
    from sml_tpu_torch.ops.common import DropoutRNG

    state["rng"] = DropoutRNG.from_seed(config.seed, "cuda").get_state()


# resumes that lose one piece of the saved state; phase 17 runs each and
# requires that it fails the parameter bound
RESUME_FAULTS = {"fresh_optimizer": _plant_fresh_optimizer,
                 "restarted_scheduler": _plant_restarted_scheduler,
                 "lost_generators": _plant_lost_generators}
# largest relative L2 distance per tensor allowed between the resumed run's
# final parameters / Adam moments and the uninterrupted run's
RESUME_PARAM_TOL = 1e-3
RESUME_OPT_TOL = 1e-2


def _split_diff(diff: dict) -> dict:
    """{"params": largest distance of a model entry, "optimizer": of an
    optimizer entry, "exact": the other entries that differ}."""
    model = [v for k, v in diff.items() if k.startswith("model/")]
    opt = [v for k, v in diff.items() if k.startswith("optimizer/")]
    return {"params": max(model), "optimizer": max(opt),
            "exact": sorted(k for k, v in diff.items()
                            if v and not k.startswith(("model/", "optimizer/")))}


def phase_resume(card: dict) -> None:
    """17. The deformpathomic training path at S2500 (B = 8, bf16, 8-step
    epochs, ``--eval_every_iters 4``) through ``main.main``: run A trains 2
    epochs; run B trains 1, then resumes into the same checkpoints with
    ``--epochs 2 --resume true`` (epoch 0's cosine rate does not depend on
    ``epochs``, so run B's first epoch is run A's).  Run B must say ``resuming
    from epoch 1``, its resumed epoch launch each kernel twice per train step,
    both leave the file set of a run, and their final ``last_state.pt`` must
    agree: the parameters within RESUME_PARAM_TOL and the Adam moments within
    RESUME_OPT_TOL (relative L2 per tensor; the CUDA backward of
    ``F.grid_sample`` adds with atomics, so bit equality is reported, not
    required), the scheduler, both dropout generators and the step exactly.
    Each resume of RESUME_FAULTS, from a copy of run B's epoch-1 state with
    one piece lost, must fail the parameter bound.  Then the time to write and
    to read ``last_state.pt`` and its size."""
    import os
    import shutil
    import tempfile

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.train import checkpoint as ckpt
    from sml_tpu_torch.train.loop import setup

    flags = _flags("deformpathomic", synthetic_size=64, fixdim=MAIN_FIXDIM,
                   eval_every_iters=4)
    config = Config(**flags)
    steps = len(Loader(build_datasets(config, "Train"), config.batch_size, drop_last=True))
    resume = {**flags, "epochs": 2, "resume": True}
    with tempfile.TemporaryDirectory() as root:
        dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
        rc_a, _, _, _, wall_a = _train_entry({**flags, "epochs": 2}, dir_a)
        rc_b1, _, _, _, _ = _train_entry({**flags, "epochs": 1}, dir_b)
        for fault, plant in RESUME_FAULTS.items():
            shutil.copytree(dir_b, os.path.join(root, fault))
            path = os.path.join(root, fault, ckpt.LAST_STATE)
            state = torch.load(path, weights_only=True)
            plant(state, config)
            torch.save(state, path)
        rc_b, printed, total, eval_l, wall_b = _train_entry(resume, dir_b)
        train_l = {k: total[k] - eval_l[k] for k in total}
        want = {k: TRAIN_LAUNCHES["deformpathomic"].get(k, 0) * steps for k in total}
        rc_f = {f: _train_entry(resume, os.path.join(root, f))[0] for f in RESUME_FAULTS}
        files = {"a": _state_files(dir_a), "b": _state_files(dir_b)}
        with open(os.path.join(dir_b, ckpt.RESUME_META)) as f:
            meta = json.load(f)
        with open(os.path.join(dir_b, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        final_a = torch.load(os.path.join(dir_a, ckpt.LAST_STATE), weights_only=True)
        diff = {run: _state_diff(final_a, torch.load(
                    os.path.join(root, run, ckpt.LAST_STATE), weights_only=True))
                for run in ("b", *RESUME_FAULTS)}
        split = {run: _split_diff(d) for run, d in diff.items()}
        bit_equal = all(v == 0.0 for v in diff["b"].values())
        steps_equal = final_a["step"] == 2 * steps

        # write and read the whole train state of this run (on the card)
        state = setup(Config(**{**resume, "checkpoints": dir_b}), "cuda")[0]
        path = os.path.join(dir_b, "timed_state.pt")
        write_ms = statistics.median(_host_ms(lambda: ckpt.save_train_state(path, state))
                                     for _ in range(3))
        read_ms = statistics.median(_host_ms(lambda: ckpt.restore_train_state(path, state))
                                    for _ in range(3))
        size_mb = os.path.getsize(path) / 1e6
        del state
    mid = [r for r in records if "test/loss" in r and "epoch" not in r]
    faults_caught = {f: split[f]["params"] > RESUME_PARAM_TOL for f in RESUME_FAULTS}
    ok = (rc_a == rc_b1 == rc_b == 0 and "resuming from epoch 1 (step " in printed
          and all(rc == 0 for rc in rc_f.values())
          and train_l == want and steps_equal and split["b"]["params"] <= RESUME_PARAM_TOL
          and split["b"]["optimizer"] <= RESUME_OPT_TOL and not split["b"]["exact"]
          and all(faults_caught.values())
          and all(f["fixed"] == RESUME_FILES and f["best_named"] for f in files.values())
          and meta["epoch"] == 1 and meta["iters"] == 2 * steps and len(mid) == 2)
    rel = {k[len("model/"):]: v for k, v in diff["b"].items() if k.startswith("model/")}
    _line("resume", fixdim=MAIN_FIXDIM, batch=config.batch_size, dtype=config.compute_dtype,
          steps_per_epoch=steps, launches_resumed_train_steps=train_l,
          expected_launches=want, launches_eval=eval_l, files=files, meta=meta,
          mid_epoch_records=len(mid), records=len(records),
          param_rel_l2_max=split["b"]["params"], param_rel_l2_worst=max(rel, key=rel.get),
          optimizer_rel_l2_max=split["b"]["optimizer"], exact_entries_differing=split["b"][
              "exact"], entries_compared=len(diff["b"]), state_bit_equal=bit_equal,
          param_tol=RESUME_PARAM_TOL, optimizer_tol=RESUME_OPT_TOL,
          planted_faults={f: {**split[f], "caught": faults_caught[f], "rc": rc_f[f]}
                          for f in RESUME_FAULTS},
          last_state_mb=size_mb, save_ms=write_ms, load_ms=read_ms,
          entry_point_wall_s={"a": round(wall_a, 2), "b_resumed": round(wall_b, 2)},
          ok=ok, card=card["nvidia_smi"])
    if not ok:
        raise AssertionError("resume: run B does not continue run A (see the line above)")
    torch.cuda.empty_cache()


# launches of one train step with remat (the recompute runs the CPB forward
# and the attention forward again in each branch) and without
REMAT_LAUNCHES = {
    "deformpathomic": ({"cpb_bias": 4, "cpb_bias_bwd": 2, "deform_attention_fwd": 4,
                        "deform_attention_bwd": 2, "deform_attention_fwd_dropout": 4},
                       TRAIN_LAUNCHES["deformpathomic"]),
    "deform1d": ({"deform_attention_fwd": 4, "deform_attention_bwd": 2,
                  "deform_attention_fwd_f32bias": 4, "deform_attention_bwd_f32bias": 2},
                 TRAIN_LAUNCHES["deform1d"])}


def phase_remat(card: dict) -> None:
    """18. One train step with ``remat`` against one without, from one init and
    one ``DropoutRNG`` seed (dropout on), at S2500 for deformpathomic and for
    the 1-D path (N = 2501, J = 625): the loss and every gradient within
    TRAIN_TOL, the generators' states equal after the step, and the launch
    counts of REMAT_LAUNCHES; then the train step's time and peak memory
    with and without remat."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_grad_step

    dev = torch.device("cuda")
    for path in ("deformpathomic", "deform1d"):
        config = Config(**_flags(path, synthetic_size=64, fixdim=MAIN_FIXDIM))
        model = define_net(config, dev, train=True)
        grad_step = make_grad_step(config, model)
        batch = next(iter(Loader(build_datasets(config, "Train"), config.batch_size,
                                 shuffle=True, drop_last=True, seed=config.seed)))
        batch.pop("sample_mask")
        batch = batch_to_device(config, batch, dev)
        runs = {}
        for remat in (False, True):
            model.remat = remat
            rng = DropoutRNG.from_seed(7, dev)
            reset_launch_counts()
            metrics = grad_step(batch, rng)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            runs[remat] = ({k: v.float().item() for k, v in metrics.items()},
                           {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                           rng.get_state(), counts)
        (m_p, g_p, rng_p, counts_p), (m_r, g_r, rng_r, counts_r) = runs[False], runs[True]
        loss_err = {k: abs(m_r[k] - m_p[k]) for k in m_p}
        floor = 1e-3 * max(g.norm().item() for g in g_p.values())
        rel = {n: (g_r[n] - g_p[n]).norm().item() / max(g_p[n].norm().item(), floor)
               for n in g_p}
        loss_tol, grad_tol = TRAIN_TOL[config.compute_dtype]
        want_r, want_p = REMAT_LAUNCHES[path]
        rng_equal = all(torch.equal(rng_p[k], rng_r[k]) for k in rng_p)
        ok = (all(e <= loss_tol for e in loss_err.values())
              and all(r <= grad_tol for r in rel.values()) and rng_equal
              and counts_r == want_r and counts_p == want_p
              and all(bool(torch.isfinite(g).all()) for g in g_r.values()))
        times = {}
        for remat in (False, True):
            model.remat = remat
            times[remat] = _train_step_ms(config, model, batch, 8)
        _line("remat", path=path, fixdim=MAIN_FIXDIM, batch=config.batch_size,
              dtype=config.compute_dtype, launches_remat=counts_r, launches_plain=counts_p,
              loss_remat=m_r, loss_abs_err=loss_err, loss_tol=loss_tol,
              grad_rel_l2_max=max(rel.values()), grad_rel_l2_worst=max(rel, key=rel.get),
              grads_bit_equal=all(torch.equal(g_r[n], g_p[n]) for n in g_p),
              grad_floor=floor, grad_tol=grad_tol, generators_equal=rng_equal,
              train_step_ms={"plain": times[False][0], "remat": times[True][0]},
              peak_mem_gb={"plain": times[False][1], "remat": times[True][1]},
              ok=ok, card=card["nvidia_smi"])
        if not ok:
            raise AssertionError(f"remat on {path}: see the line above")
        del model, grad_step, runs
        torch.cuda.empty_cache()


def reference_state_dict(variables: dict, mode: str, attn_dim: int = 2) -> dict:
    """A reference model's ``state_dict`` (numpy) that holds the flax
    ``variables`` of ``mode`` (a ``--mode``, or ``"transmil"``): the key names
    and layouts that ``convert_reference_state_dict`` reads, so that
    converting it gives ``variables`` back.  The reference also declares keys
    the converter reads and drops (the unused 1-D or 2-D deformable attention,
    the 2-D model's ``cls_token``); they are filled from the used ones."""
    import numpy as np

    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}

    def put(key, a):
        sd[key] = np.ascontiguousarray(a)

    def dense(p, t):
        put(p + ".weight", t["kernel"].T)
        if "bias" in t:
            put(p + ".bias", t["bias"])

    def conv(p, t):                  # Conv (kh, kw, in/g, out) or Conv1 (k, in/g, out)
        k = t["kernel"]
        put(p + ".weight", k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(2, 1, 0))
        if "bias" in t:
            put(p + ".bias", t["bias"])

    def layernorm(p, t):
        put(p + ".weight", t["scale"])
        put(p + ".bias", t["bias"])

    def packed_mha(p, t):
        qkv = ("q_proj", "k_proj", "v_proj")
        put(p + ".in_proj_weight", np.concatenate([t[n]["kernel"].T for n in qkv]))
        put(p + ".in_proj_bias", np.concatenate([t[n]["bias"] for n in qkv]))
        dense(p + ".out_proj", t["out_proj"])

    def maxnet(p, t):
        for i in range(4):
            dense(f"{p}encoder.{i}.0", t[f"encoder{i + 1}"])
        dense(p + "classifier.0", t["classifier"])

    def abmil(p, t):
        dense(p + "attention.0", t["attention_0"])
        dense(p + "attention.2", t["attention_1"])
        dense(p + "classifier.0", t["classifier"])
        dense(p + "multimodal_projection", t["multimodal_projection"])

    def transformer(p, t):           # TransMIL's, CMTA's Transformer_P and _G
        put(p + "cls_token", t["cls_token"])
        for layer in ("layer1", "layer2"):
            a = t[layer]["attn"]
            layernorm(f"{p}{layer}.norm", t[layer]["norm"])
            put(f"{p}{layer}.attn.to_qkv.weight", a["to_qkv"]["kernel"].T)
            dense(f"{p}{layer}.attn.to_out.0", a["to_out"])
            put(f"{p}{layer}.attn.res_conv.weight", a["res_conv_kernel"].T[:, None, :, None])
        for proj in ("proj", "proj1", "proj2") if "pos_layer" in t else ():
            conv(f"{p}pos_layer.{proj}", t["pos_layer"][proj])
        layernorm(p + "norm", t["norm"])

    def bilinear_fusion(p, t, s):
        for i in (1, 2):
            dense(f"{p}linear_h{i}.0", t[f"linear_h{i}"])
            put(f"{p}linear_z{i}.weight", t[f"linear_z{i}"]["weight"])
            put(f"{p}linear_z{i}.bias", t[f"linear_z{i}"]["bias"])
            dense(f"{p}linear_o{i}.0", t[f"linear_o{i}"])
            dense(f"{p}encoder{i}.0", t[f"encoder{i}"])
            layernorm(f"{p}encoder{i}.1", t[f"bn{i}"])
            put(f"{p}encoder{i}.1.running_mean", s[f"bn{i}"]["mean"])
            put(f"{p}encoder{i}.1.running_var", s[f"bn{i}"]["var"])

    def deform_attn(p, t):
        for name in ("to_q", "to_k", "to_v", "to_out"):
            conv(p + name, t[name])
        conv(p + "to_offsets.0", t["offset_conv"])
        conv(p + "to_offsets.2", t["offset_proj"])
        for i, name in enumerate(("mlp.0.0", "mlp.1.0", "mlp.2")):
            put(f"{p}rel_pos_bias.{name}.weight", t["rel_pos_bias"][f"w{i}"].T)
            put(f"{p}rel_pos_bias.{name}.bias", t["rel_pos_bias"][f"b{i}"])

    def other_dim(t):                # the unused attention: 2-D kernels as 1-D, or back
        return {k: other_dim(v) if isinstance(v, dict) else
                (v[0] if v.ndim == 4 else v[None]) if k == "kernel" else v
                for k, v in t.items()}

    def deform_mil(p, t):
        dense(p + "_fc1.0", t["fc1"])
        dense(p + "fusion_layer.fusion_layer", t["fusion_layer"]["fusion_layer"])
        layernorm(p + "layer3.norm", t["layer3"]["norm"])
        used = t["layer3"]["attn2d" if attn_dim == 2 else "attn1d"]
        deform_attn(f"{p}layer3.attn{attn_dim}d.", used)
        deform_attn(f"{p}layer3.attn{3 - attn_dim}d.", other_dim(used))
        if attn_dim == 2:
            put(p + "cls_token", np.zeros((1, 1, t["norm"]["scale"].shape[0]), np.float32))
            dense(p + "pooler.dense", t["pooler"]["dense"])
        else:
            put(p + "cls_token", t["cls_token"])
        layernorm(p + "norm", t["norm"])
        dense(p + "_fc2", t["fc2"])
        dense(p + "multimodal_projection", t["multimodal_projection"])

    def coattn_model(p):             # MCAT and CMTA: wsi net, signature nets, fusion
        dense("wsi_net.0", p["wsi_net"])
        for i in range(4):
            for j in range(2):
                dense(f"sig_networks.{i}.{j}.0", p[f"sig_net{i}"][f"SNNBlock_{j}"]["Dense_0"])
        if "mm0" in p:
            dense("mm.0", p["mm0"])
            dense("mm.2", p["mm1"])
        else:
            bilinear_fusion("mm.", p["mm"], stats["mm"])
        dense("classifier", p["classifier"])

    p = params
    if mode == "omic":
        maxnet("", p)
    elif mode == "path":
        abmil("", p)
    elif mode == "transmil":
        transformer("", p)
        dense("_fc1.0", p["fc1"])
        dense("_fc2", p["fc2"])
        dense("multimodal_projection", p["multimodal_projection"])
    elif mode in ("pathomic", "pathomic_original"):
        if mode == "pathomic":
            abmil("path_net.", p["path_net"])
        else:
            dense("path_net.0", p["path_net"])
            dense("path_classifier.0", p["path_classifier"])
        maxnet("omic_net.", p["omic_net"])
        dense("classifier.0", p["classifier"])
    elif mode == "deformpathomic":
        for branch in ("tumor", "immune"):
            maxnet(f"omic_net_{branch}.", p[f"omic_net_{branch}"])
            deform_mil(f"pathomic_net_{branch}.", p[f"pathomic_net_{branch}"])
        dense("classifier", p["classifier"])
        dense("classifier_tumor.0", p["classifier_tumor"])
        dense("classifier_immune.0", p["classifier_immune"])
    elif mode == "mcat":
        coattn_model(p)
        packed_mha("coattn", p["coattn"])
        for prefix in ("path", "omic"):
            for j in range(2):
                t, q = p[f"{prefix}_transformer"][f"layer{j}"], f"{prefix}_transformer.layers.{j}."
                packed_mha(q + "self_attn", t["self_attn"])
                for name in ("linear1", "linear2"):
                    dense(q + name, t[name])
                for name in ("norm1", "norm2"):
                    layernorm(q + name, t[name])
            for name in ("attention_a", "attention_b"):
                dense(f"{prefix}_attention_head.{name}.0", p[f"{prefix}_attention_head"][name])
            dense(f"{prefix}_attention_head.attention_c",
                  p[f"{prefix}_attention_head"]["attention_c"])
            dense(f"{prefix}_rho.0", p[f"{prefix}_rho"])
    elif mode == "cmta":
        coattn_model(p)
        for name in ("pathomics_encoder", "pathomics_decoder", "genomics_encoder",
                     "genomics_decoder"):
            transformer(name + ".", p[name])
        packed_mha("P_in_G_Att", p["P_in_G_Att"])
        packed_mha("G_in_P_Att", p["G_in_P_Att"])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if "fusion" in p:
        bilinear_fusion("fusion.", p["fusion"], stats["fusion"])
    return sd


def write_h5(path: str, name: str, arr) -> None:
    """A minimal HDF5 file holding one contiguous little-endian f32 dataset
    ``name`` in its root group, as h5py lays it out by default (superblock 0,
    a symbol-table root group, version-1 object headers), without h5py."""
    import struct

    import numpy as np

    arr = np.ascontiguousarray(arr, dtype="<f4")
    undef = 0xFFFFFFFFFFFFFFFF
    leaf_k, internal_k = 4, 16

    def message(mtype: int, body: bytes) -> bytes:
        body += b"\0" * (-len(body) % 8)
        return struct.pack("<HHB3x", mtype, len(body), 0) + body

    def header(msgs) -> bytes:
        blob = b"".join(msgs)
        return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(blob)) + blob

    # root object header, local heap (names), group B-tree, symbol node, the
    # dataset's object header, then the data, each at an 8-byte boundary
    names = b"\0" * 8 + name.encode() + b"\0"
    names += b"\0" * (-len(names) % 8)
    sizes = {"sb": 96, "root": 40, "heap": 32 + len(names),
             "btree": 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8,
             "snod": 8 + 2 * leaf_k * 40}
    space = struct.pack("<BBBx4x", 1, arr.ndim, 0) + struct.pack(f"<{arr.ndim}Q", *arr.shape)
    dtype = struct.pack("<B3BI", 0x11, 0x20, 31, 0, 4) + struct.pack("<HHBBBBI", 0, 32, 23, 8,
                                                                     0, 23, 127)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)
    addr, at = 0, {}
    for key in ("sb", "root", "heap", "btree", "snod"):
        at[key] = addr
        addr += sizes[key]
    at["dset"] = addr
    dset_len = len(header([message(1, space), message(3, dtype), message(5, fill),
                           message(8, bytes(18))]))
    at["data"] = -(-(addr + dset_len) // 8) * 8
    layout = struct.pack("<BBQQ", 3, 1, at["data"], arr.nbytes)
    dset = header([message(1, space), message(3, dtype), message(5, fill),
                   message(8, layout)])
    eof = at["data"] + arr.nbytes
    sb = (b"\x89HDF\r\n\x1a\n" + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
          + struct.pack("<HHI", leaf_k, internal_k, 0)
          + struct.pack("<4Q", 0, undef, eof, undef)
          + struct.pack("<QQII", 0, at["root"], 1, 0) + struct.pack("<QQ", at["btree"],
                                                                   at["heap"]))
    root = header([message(0x11, struct.pack("<QQ", at["btree"], at["heap"]))])
    heap = (b"HEAP" + struct.pack("<B3xQQQ", 0, len(names), 1, at["heap"] + 32) + names)
    btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, undef, undef)
             + struct.pack("<QQQ", 0, at["snod"], 8)).ljust(sizes["btree"], b"\0")
    snod = (b"SNOD" + struct.pack("<BxH", 1, 1)
            + struct.pack("<QQII16x", 8, at["dset"], 0, 0)).ljust(sizes["snod"], b"\0")
    with open(path, "wb") as f:
        for key, blob in (("sb", sb), ("root", root), ("heap", heap), ("btree", btree),
                          ("snod", snod), ("dset", dset)):
            f.seek(at[key])
            f.write(blob)
        f.seek(at["data"])
        f.write(arr.tobytes())


# phase 19's fake cohort: IvYGAP and TCGA with COHORT_PATIENTS patients (one
# slide each) and the 431 genes of the signature (59 Tumor, 361 Immune, 11 of
# neither); each slide's features (1, fixdim, 1024) f32 in an .h5 file; each
# TCGA sample's GDC file at its real size, GDC_GENES rows after the 4 N_ rows
COHORT_PATIENTS = 16
COHORT_SEED = 42       # Config's default seed: the readers' patient shuffle
COHORT_GENES = (("Tumor", 59), ("Immune", 361), ("Other", 11))
GDC_GENES = 60660
# diag2021 class -> (idh, codel, cdkn, grade, TCGA histology)
COHORT_CLASSES = (("WT", "non-codel", 0, "G4", "glioblastoma"),
                  ("Mutant", "non-codel", -2, "G3", "astrocytoma"),
                  ("Mutant", "non-codel", 0, "G2", "astrocytoma"),
                  ("Mutant", "codel", 0, "G3", "oligodendroglioma"))
ATTRIBUTIONS = ("ablation", "permutation", "gradient_shap", "deep_shap")


def write_cohort(root: str, fixdim: int) -> int:
    """The IvYGAP and TCGA trees the readers expect, written with ``csv`` and
    ``write_h5``; returns the bytes written.  A patient's diag2021 class is its
    rank in the readers' seeded patient shuffle mod 4, so any 4 consecutive
    ranks (every split of either size) hold every class."""
    import csv
    import os

    import numpy as np

    rng = np.random.default_rng(COHORT_SEED)
    genes = [f"G{i}" for i in range(sum(n for _, n in COHORT_GENES))]
    kinds = [k for k, n in COHORT_GENES for _ in range(n)]
    written = 0

    def table(path, header, rows, delimiter=",", comment=""):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", newline="") as f:
            f.write(comment)
            w = csv.writer(f, delimiter=delimiter)
            w.writerow(header)
            w.writerows(rows)

    def features(path):
        nonlocal written
        os.makedirs(os.path.dirname(path), exist_ok=True)
        x = rng.standard_normal((1, fixdim, 1024), dtype=np.float32)
        write_h5(path, "Res_feature", x)
        written += x.nbytes

    def ranks(ids):
        order = np.unique(np.asarray(ids, dtype=object))
        np.random.RandomState(COHORT_SEED).shuffle(order)
        return {p: r for r, p in enumerate(order)}

    sig = rng.permutation(len(genes))             # the signature in its own order
    table(f"{root}/TCGA/gene_signature_selected.csv", ["gene_symbol", "Type"],
          [[genes[i], kinds[i]] for i in sig])

    tcga, rows = f"{root}/TCGA", []
    ids = [f"TCGA-{i:02d}" for i in range(COHORT_PATIENTS)]
    rank = ranks(ids)
    # a GDC STAR-counts file: the signature genes among the others, in one
    # order for every sample
    names = [f"GENE{j}" for j in range(GDC_GENES)]
    for g, j in zip(genes, rng.choice(GDC_GENES, len(genes), replace=False)):
        names[j] = g
    gdc_cols = ["gene_id", "gene_name", "gene_type", "unstranded", "stranded_first",
                "stranded_second", "tpm_unstranded", "fpkm_unstranded",
                "fpkm_uq_unstranded"]
    for i, pid in enumerate(ids):
        idh, codel, cdkn, grade, his = COHORT_CLASSES[rank[pid] % 4]
        slide = f"{pid}-01Z"
        features(f"{tcga}/Res50_feature_{fixdim}_fixdim0_norm/{slide}.h5")
        counts = rng.integers(0, 5000, (GDC_GENES, 3)).tolist()
        fpkm = np.round(rng.uniform(0, 100, (GDC_GENES, 3)), 4).tolist()
        table(f"{tcga}/transcriptomeProfiling_geneExpression/case{i}/expr{i}.tsv", gdc_cols,
              [[f"N_{k}", "", "", *rng.integers(0, 10 ** 6, 3).tolist(), "", "", ""]
               for k in ("unmapped", "multimapping", "noFeature", "ambiguous")]
              + [[f"ENSG{j:011d}.{j % 20}", name, "protein_coding", *c, *f]
                 for j, (name, c, f) in enumerate(zip(names, counts, fpkm))],
              delimiter="\t", comment="# gene-model: GENCODE v36\n")
        rows.append([pid, slide, his, grade, idh, codel, cdkn, 0, 0, 0, 0, f"case{i}",
                     f"expr{i}.tsv", rank[pid] % 2, f"{rng.uniform(30, 2000):.1f}"])
    table(f"{tcga}/multimodal_diag_survival_TCGA.csv",
          ["patient", "slide", "his", "grade", "idh", "codel", "cdkn", "c7", "c8", "c9",
           "c10", "gene_dir", "gene_file", "dead", "time"], rows)

    ivy = f"{root}/IvYGAP"
    gdir = f"{ivy}/gene_expression_matrix_2014-11-25"
    table(f"{gdir}/rows-genes.csv", ["gene_id", "gene_symbol"],
          [[100 + j, g] for j, g in enumerate(genes)])
    ids = [f"W{i}" for i in range(COHORT_PATIENTS)]
    rank = ranks(ids)
    wells = [1000 + i for i in range(COHORT_PATIENTS)]
    table(f"{gdir}/columns-samples.csv", ["rna_well_id", "specimen_name"],
          [[w, f"{pid}-1-1-X"] for w, pid in zip(wells, ids)])
    values = rng.uniform(0, 100, (len(genes), COHORT_PATIENTS))
    table(f"{gdir}/fpkm_table.csv", ["gene_id\\rna_well_id"] + [str(w) for w in wells],
          [[100 + j] + [f"{v:.4f}" for v in values[j]] for j in range(len(genes))])
    rows = []
    for pid in ids:
        idh, codel, cdkn, grade, _ = COHORT_CLASSES[rank[pid] % 4]
        slide = f"{pid}-1-1-D.01"
        features(f"{ivy}/Res50_feature_{fixdim}_fixdim0_norm/{slide}.h5")
        rows.append([pid, slide, 0, grade, idh, codel, cdkn, rank[pid] % 2,
                     f"{rng.uniform(30, 2000):.1f}"])
    table(f"{ivy}/multimodal_diag_survival_IvY.csv",
          ["patient", "slide", "c2", "grade", "idh", "codel", "cdkn", "dead", "time"], rows)
    return written


def _batches_equal(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def _epoch_mb_s(loader) -> tuple:
    """(batches, MB/s, samples/s) of one pass over ``loader``."""
    t0 = time.perf_counter()
    batches = list(loader)
    s = time.perf_counter() - t0
    n_bytes = sum(v.nbytes for b in batches for v in b.values())
    return batches, n_bytes / 1e6 / s, sum(len(b["labels"]) for b in batches) / s


def _attribute(flags: dict, ckpt: str, kind: str, n_genes: int) -> dict:
    """``inference.main --attribution kind`` on ``ckpt/best_modal.npz``: its
    seconds, the CSV's rows (all finite) and the ``metrics.jsonl`` records."""
    import numpy as np

    from sml_tpu_torch import inference
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    argv = ([f"--{k}={v}" for k, v in flags.items() if k != "epochs"]
            + [f"--weights={ckpt}/best_modal.npz", f"--checkpoints={ckpt}",
               f"--attribution={kind}", "--device=cuda"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = inference.main(argv)
    seconds = time.perf_counter() - t0
    name = "difference_acc_list.csv" if kind == "ablation" else "gene_importance.csv"
    with open(f"{ckpt}/{name}") as f:
        lines = f.read().strip().splitlines()
    values = np.asarray([float(ln.split(",")[1]) for ln in lines[1:]])
    with open(f"{ckpt}/metrics.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    record = {k: v for k, v in records[-1].items() if k.startswith("attribution/")}
    ok = (rc == 0 and lines[0] == "gene_index,importance" and len(values) == n_genes
          and bool(np.isfinite(values).all()) and bool(record)
          and any(k.startswith("test/") for k in records[-2])
          and not any(launch_counts().values()))
    return {"kind": kind, "s": round(seconds, 2), "rows": len(values),
            "top_gene": int(values.argmax()), "record": record, "ok": ok,
            "printed": printed.getvalue().strip().splitlines()[-1]}


def phase_cohort(card: dict) -> None:
    """Phase 19: the real-data workflow on a full-size fake cohort (IvYGAP and
    TCGA, COHORT_PATIENTS patients each, 2500 x 1024 f32 features per slide
    in .h5 files, the 431 genes): the readers' Train epoch timed; deformpathomic
    (bf16) trained one epoch from ``--dataset both`` with #1-#4 launched as in
    phase 6; the cohort packed by ``python -m sml_tpu_torch.pack_data``, whose
    native (workers 2) and numpy batches must equal the readers'; the same
    epoch trained from ``--packed_dir`` (losses within TRAIN_TOL, bit equality
    reported); then pathomic (f32, ``--novalset``) trained one epoch and
    attributed by ``inference.main --attribution`` ablation / permutation /
    gradient_shap / deep_shap, and MCAT (survival) by mcat_groups: a CSV of
    431 finite rows each, its ``metrics.jsonl`` record, no kernel launch."""
    import os
    import subprocess
    import tempfile

    from sml_tpu_torch import runtime
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.data.packed import PackedLoader

    t_phase = time.perf_counter()
    n_genes = sum(n for _, n in COHORT_GENES)
    with tempfile.TemporaryDirectory() as tmp:
        data, packed = f"{tmp}/data/", f"{tmp}/packed"
        t0 = time.perf_counter()
        n_bytes = write_cohort(data, MAIN_FIXDIM)
        _line("cohort", step="write", patients_per_cohort=COHORT_PATIENTS, genes=n_genes,
              feature_mb=n_bytes / 1e6, s=round(time.perf_counter() - t0, 2))

        # 1) the readers' Train epoch, then deformpathomic trained from them
        flags = _flags("deformpathomic", dataset="both", dataDir=data, fixdim=MAIN_FIXDIM,
                       epochs=1)
        config = Config(**flags)
        train_loader = Loader(build_datasets(config, "Train"), config.batch_size,
                              shuffle=True, drop_last=True, seed=config.seed)
        test_loader = Loader(build_datasets(config, "Test"), config.batch_size)
        readers, reader_mb_s, reader_samples_s = _epoch_mb_s(train_loader)
        train_loader.set_epoch(1)          # the TCGA gene files parsed once, in epoch 0
        _, reader_mb_s_2, reader_samples_s_2 = _epoch_mb_s(train_loader)
        train_loader.set_epoch(0)
        steps = len(train_loader)
        rc, printed, total, eval_l, wall_s = _train_entry(flags, f"{tmp}/readers")
        train_l = {k: total[k] - eval_l[k] for k in total}
        want = {k: TRAIN_LAUNCHES["deformpathomic"].get(k, 0) * steps for k in total}
        train_m, val_m, test_m = _epoch_metrics(printed)
        ok = (rc == 0 and steps > 0 and train_l == want
              and not (eval_l["cpb_bias_bwd"] or eval_l["deform_attention_bwd"])
              and all(math.isfinite(v) for m in (train_m, val_m, test_m)
                      for v in m.values()))
        _line("cohort", step="train", dataset="both", mode="deformpathomic",
              dtype=config.compute_dtype, samples={"Train": len(train_loader.dataset),
                                                   "Test": len(test_loader.dataset)},
              steps=steps, launches_train_steps=train_l, expected_launches=want,
              launches_eval=eval_l, train_metrics=train_m, val_metrics=val_m,
              test_metrics=test_m, reader_mb_s=reader_mb_s,
              reader_samples_s=reader_samples_s, reader_mb_s_epoch2=reader_mb_s_2,
              reader_samples_s_epoch2=reader_samples_s_2, entry_point_wall_s=round(wall_s, 2),
              ok=ok, card=card["nvidia_smi"])
        if not ok:
            raise AssertionError(f"cohort train: rc={rc} launches {train_l}, expected {want}")

        # 2) packed: the same batches three ways, then the same epoch trained
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sml_tpu_torch.pack_data",
                               "--dataset", "both", "--dataDir", data, "--out", packed,
                               "--fixdim", str(MAIN_FIXDIM), "--seed", str(config.seed)],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
        pack_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"pack_data failed: {proc.stderr[-2000:]}")
        t0 = time.perf_counter()
        runtime.load_library()                    # g++, outside the timed passes
        prefetch_build_s = time.perf_counter() - t0
        kw = dict(shuffle=True, drop_last=True, seed=config.seed)
        native, native_mb_s, _ = _epoch_mb_s(
            PackedLoader(f"{packed}/Train.bin", config.batch_size, workers=2, **kw))
        numpy_b, numpy_mb_s, _ = _epoch_mb_s(
            PackedLoader(f"{packed}/Train.bin", config.batch_size, workers=0, **kw))
        tests = [list(PackedLoader(f"{packed}/Test.bin", config.batch_size, workers=w))
                 for w in (2, 0)]
        equal = {"train_native": _batches_equal(native, readers),
                 "train_numpy": _batches_equal(numpy_b, readers),
                 "test_native": _batches_equal(tests[0], list(test_loader)),
                 "test_numpy": _batches_equal(tests[1], list(test_loader))}
        rc, printed, total_p, _, wall_p = _train_entry(dict(flags, packed_dir=packed),
                                                       f"{tmp}/packed_run")
        train_p, val_p, test_p = _epoch_metrics(printed)
        loss_tol = TRAIN_TOL[config.compute_dtype][0]
        loss_err = {k: abs(train_p[k] - train_m[k]) for k in train_m}
        bit_equal = (train_p, val_p, test_p) == (train_m, val_m, test_m)
        ok = (rc == 0 and all(equal.values()) and total_p == total
              and all(e <= loss_tol for e in loss_err.values()))
        _line("cohort", step="packed", pack_s=round(pack_s, 2),
              prefetch_build_s=round(prefetch_build_s, 2), batches_equal=equal,
              native_workers2_mb_s=native_mb_s, numpy_mb_s=numpy_mb_s,
              train_metrics=train_p, loss_abs_err=loss_err, loss_tol=loss_tol,
              bit_equal_to_readers_run=bit_equal, launches_equal=total_p == total,
              entry_point_wall_s=round(wall_p, 2), ok=ok, card=card["nvidia_smi"])
        if not ok:
            raise AssertionError(f"cohort packed: rc={rc} batches {equal}, loss {loss_err}")

        # 3) attribution: pathomic (classification) and MCAT (survival), one
        # epoch each from the readers, weights from best_modal.npz
        failures = []
        runs = ((dict(mode="pathomic"), ATTRIBUTIONS),
                (dict(mode="mcat", task_type="survival"), ("mcat_groups",)))
        for extra, kinds in runs:
            aflags = {"dataset": "both", "dataDir": data, "fixdim": MAIN_FIXDIM,
                      "batch_size": 8, "epochs": 1, "novalset": True, **extra}
            ckpt = f"{tmp}/{extra['mode']}"
            rc, _, total_a, _, wall_a = _train_entry(aflags, ckpt)
            if rc != 0 or any(total_a.values()) or \
                    not os.path.exists(f"{ckpt}/best_modal.npz"):
                raise AssertionError(f"{extra['mode']} run: rc={rc} launches {total_a}")
            for kind in kinds:
                res = _attribute(aflags, ckpt, kind, n_genes)
                _line("cohort", step="attribution", mode=extra["mode"], train_wall_s=round(
                    wall_a, 2), **res, card=card["nvidia_smi"])
                if not res["ok"]:
                    failures.append(kind)
        if failures:
            raise AssertionError(f"cohort attribution failed: {failures}")
    _line("cohort", step="phase", wall_s=round(time.perf_counter() - t_phase, 1))


# phase 20: one deformpathomic epoch of DEVICE_LOOP_STEPS train steps, per step
# and in chunks of DEVICE_LOOP_CHUNK (a chunk and a shorter remainder)
DEVICE_LOOP_STEPS = 6
DEVICE_LOOP_CHUNK = 4
# the kernel functions a bf16 deformpathomic train step launches (#1-#4), which
# the profiler's trace must name
TRACE_KERNELS = ("cpb_bias_fwd_tc", "cpb_bias_bwd_tc", "attn_fwd_tc", "attn_bwd_rows_tc",
                 "attn_bwd_keys_tc")
# the Nystrom attentions held with return_attn: TransMIL's TransLayer (bf16,
# dh = 64) and CMTA's (f32, dh = 32), each at 2501 tokens (n_pad 2560)
RETURN_ATTN = (("transmil", "layer1"), ("cmta", "pathomics_encoder.layer1"))


def _device_loop_runs() -> dict:
    """Phase 20's first part: the epoch per step and in chunks through
    ``main.main``; returns the line's fields (``ok`` among them)."""
    import os
    import tempfile

    from sml_tpu_torch.train import checkpoint as ckpt

    flags = _flags("deformpathomic", synthetic_size=8 * DEVICE_LOOP_STEPS,
                   fixdim=MAIN_FIXDIM, epochs=1)
    loop_flags = {"device_loop": True, "device_loop_chunk": DEVICE_LOOP_CHUNK}
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        for name, extra in (("per_step", {}), ("device_loop", loop_flags)):
            ck = os.path.join(root, name)
            rc, _, total, eval_l, wall_s = _train_entry({**flags, **extra}, ck)
            with open(os.path.join(ck, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            runs[name] = {"rc": rc, "launches": {k: total[k] - eval_l[k] for k in total},
                          "wall_s": round(wall_s, 2),
                          "training_records": sum("training/loss" in r for r in records),
                          "state": torch.load(os.path.join(ck, ckpt.LAST_STATE),
                                              weights_only=True)}
    want = {k: TRAIN_LAUNCHES["deformpathomic"].get(k, 0) * DEVICE_LOOP_STEPS
            for k in runs["per_step"]["launches"]}
    diff = _state_diff(runs["per_step"].pop("state"), runs["device_loop"].pop("state"))
    split = _split_diff(diff)
    ok = (all(r["rc"] == 0 and r["launches"] == want for r in runs.values())
          and runs["device_loop"]["training_records"] == 1
          and split["params"] <= RESUME_PARAM_TOL and split["optimizer"] <= RESUME_OPT_TOL
          and not split["exact"])
    return {"runs": runs, "expected_launches": want, "param_rel_l2_max": split["params"],
            "optimizer_rel_l2_max": split["optimizer"],
            "exact_entries_differing": split["exact"], "entries_compared": len(diff),
            "state_bit_equal": all(v == 0.0 for v in diff.values()),
            "param_tol": RESUME_PARAM_TOL, "optimizer_tol": RESUME_OPT_TOL, "ok": ok}


def _device_loop_timing(config, state, host_batches: list, batches: list) -> dict:
    """Train-step time per step and in one chunk of the device loop, in turns
    (``StepTimer`` medians, the card waited for), the copy of a chunk's stack
    beside one batch's ``batch_to_device``, and each way's peak memory."""
    from sml_tpu_torch.train.evaluate import batch_to_device, stack_to_device
    from sml_tpu_torch.train.steps import make_epoch_loop, make_train_step
    from sml_tpu_torch.utils.profiling import StepTimer

    dev = torch.device("cuda")
    chunk = len(host_batches)
    stacked = stack_to_device(config, host_batches, dev)
    train_step = make_train_step(config, state.model)
    epoch_loop = make_epoch_loop(config, state.model)
    per_step, looped = StepTimer(warmup=chunk), StepTimer(warmup=1)
    peak = {}
    for turn in range(5):
        for name in ("per_step", "device_loop") if turn % 2 else ("device_loop", "per_step"):
            torch.cuda.reset_peak_memory_stats()
            if name == "per_step":
                for b in batches:
                    with per_step.step(block_on=dev):
                        train_step(state, b)
            else:
                with looped.step(block_on=dev):
                    epoch_loop(state, stacked)
            peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated() / 1e9)
    copy_ms = {"chunk": [], "batch": []}
    for _ in range(3):
        copy_ms["chunk"].append(_host_ms(lambda: stack_to_device(config, host_batches, dev)))
        copy_ms["batch"].append(_host_ms(lambda: batch_to_device(config, host_batches[0],
                                                                 dev)))
    return {"step_ms_per_step": per_step.stats()["p50_ms"],
            "step_ms_device_loop": looped.stats()["p50_ms"] / chunk,
            "steps_timed": {"per_step": per_step.stats()["steps"],
                            "device_loop_chunks": looped.stats()["steps"]},
            "chunk_steps": chunk, "h2d_ms_per_chunk": statistics.median(copy_ms["chunk"]),
            "h2d_ms_per_batch": statistics.median(copy_ms["batch"]), "h2d_ms": copy_ms,
            "chunk_mb": sum(t.numel() * t.element_size() for t in stacked.values()) / 1e6,
            "peak_mem_gb": peak}


def _return_attn_checks() -> dict:
    """Phase 20's second part: each RETURN_ATTN attention with ``return_attn``
    (the formed chains) against its default route through the kernels."""
    import functools

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {}
    for path, name in RETURN_ATTN:
        config = Config(**_flags(path, fixdim=MAIN_FIXDIM))
        model = define_net(config, "cuda")
        attn = functools.reduce(getattr, name.split("."), model).attn
        g = torch.Generator(device="cuda").manual_seed(20)
        x = torch.randn(config.batch_size, MAIN_FIXDIM + 1, attn.to_qkv.in_features,
                        device="cuda", generator=g)
        with torch.inference_mode():
            reset_launch_counts()
            kernel_out = attn(x)
            torch.cuda.synchronize()
            kernel_launches = {k: v for k, v in launch_counts().items() if v}
            reset_launch_counts()
            formed_out, matrix = attn(x, return_attn=True)
            torch.cuda.synchronize()
            formed_launches = {k: v for k, v in launch_counts().items() if v}
        n_pad = -(-x.shape[1] // attn.num_landmarks) * attn.num_landmarks
        shape = (config.batch_size, attn.heads, n_pad, n_pad)
        tol = SLICE_TOL[config.compute_dtype]
        cmp = _compare(formed_out, kernel_out, tol)
        finite = bool(torch.isfinite(matrix.float()).all())
        out[path] = {"dtype": config.compute_dtype, "dh": attn.dim_head, "tokens": x.shape[1],
                     "attn_shape": list(matrix.shape), "attn_finite": finite,
                     "out_vs_kernel_route": cmp, "tol": tol,
                     "launches_kernel_route": kernel_launches,
                     "launches_return_attn": formed_launches,
                     "ok": (cmp["ok"] and tuple(matrix.shape) == shape and finite
                            and not formed_launches and bool(kernel_launches))}
        del model, attn, x, kernel_out, formed_out, matrix
        torch.cuda.empty_cache()
    return out


def _trace_kernels(config, state, batch) -> dict:
    """One train step under ``profiling.trace``: the count of each
    TRACE_KERNELS function among the trace's kernel events."""
    import tempfile

    from sml_tpu_torch.train.steps import make_train_step
    from sml_tpu_torch.utils import profiling

    train_step = make_train_step(config, state.model)
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir) as path:
            with profiling.annotate("train_step"):
                train_step(state, batch)
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"]
    found = {k: sum(k in name for name in kernels) for k in TRACE_KERNELS}
    return {"kernel_events": len(kernels), "found": found,
            "annotated": any(e.get("name") == "train_step" for e in events),
            "ok": all(found.values())}


def _flops_lines(entries: dict) -> dict:
    """``deformpathomic_flops`` at S2500 / S4096, train and eval, each with the
    time it takes at the bf16 peak and, at S2500, phase 4's measured time of
    the kernels that count covers (launches per step x ms)."""
    from sml_tpu_torch.utils.flops import deformpathomic_flops

    per_step = {True: {"cpb_bias": 2, "cpb_bias_bwd": 2, "deform_attention_fwd_dropout": 2,
                       "deform_attention_bwd": 2},
                False: {"cpb_bias": 2, "deform_attention_fwd": 2}}
    out = {}
    for fixdim in SHAPES:
        for training in (True, False):
            flops = deformpathomic_flops(8, fixdim, training=training)
            at_peak_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            kernel_ms = None
            if fixdim == MAIN_FIXDIM:
                kernel_ms = sum(n * entries[k]["ms"] for k, n in per_step[training].items())
            out[f"S{fixdim}_{'train' if training else 'eval'}"] = {
                "flops": flops, "at_bf16_peak_ms": at_peak_ms,
                "kernels_measured_ms": kernel_ms,
                "achieved_tflops": None if kernel_ms is None else flops / kernel_ms / 1e9}
    return out


def _converter_check(config, batch) -> dict:
    """A reference state dict of a deformpathomic model's weights loaded by
    ``load_reference_state_dict`` into a model of another seed on the card,
    then one eval step."""
    from sml_tpu_torch.bridge import export_flax_batch_stats, export_flax_params
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.train.steps import make_eval_step
    from sml_tpu_torch.utils.torch_compat import load_reference_state_dict, reference_mode

    source = define_net(config, "cuda")
    sd = reference_state_dict({"params": export_flax_params(source),
                               "batch_stats": export_flax_batch_stats(source)},
                              reference_mode(config), config.attn_dim)
    loaded = define_net(config, "cuda", seed=config.seed + 1)
    load_reference_state_dict(loaded, {k: torch.from_numpy(v) for k, v in sd.items()}, config)
    same = all(torch.equal(a, b) for a, b in zip(source.state_dict().values(),
                                                  loaded.state_dict().values()))
    eval_batch = dict(batch, sample_mask=torch.ones(config.batch_size, device="cuda"))
    got = make_eval_step(config, loaded)(eval_batch)
    want = make_eval_step(config, source)(eval_batch)
    return {"reference_keys": len(sd), "weights_equal_source": same,
            "eval_finite": _finite(got),
            "eval_max_abs_diff_vs_source": max(float((got[k] - want[k]).abs().max())
                                               for k in got),
            "ok": same and _finite(got)}


def phase_device_loop(card: dict, entries: dict) -> None:
    """20. The device loop, and the utilities of the last slice on the card:
    deformpathomic at S2500 (B = 8, bf16, dropout 0.1, gradient modulation,
    batch-similarity loss, Adam) trains one epoch of DEVICE_LOOP_STEPS steps
    from one seed through ``main.main``, per step and with ``--device_loop true
    --device_loop_chunk`` DEVICE_LOOP_CHUNK (a chunk and a remainder): the
    final parameters within RESUME_PARAM_TOL and Adam's moments within
    RESUME_OPT_TOL (relative L2 per tensor; ``F.grid_sample``'s backward adds
    with atomics, so bit equality is reported, not required), the rest of the
    state exactly, #1-#4 launched twice per step in both runs, one
    ``training`` record in the device loop's ``metrics.jsonl``; the median
    step time both ways (``StepTimer``), the stacked copy of a chunk and the
    peak memory.  Then ``return_attn`` of RETURN_ATTN's attentions against
    their kernel route (``SLICE_TOL``; no launch with ``return_attn``, the
    attention finite and (b, h, n_pad, n_pad)); ``profiling.trace`` around a
    train step naming every TRACE_KERNELS function; ``deformpathomic_flops``
    beside the kernel time it implies; and ``load_reference_state_dict`` into
    a model on the card, then an eval step."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets
    from sml_tpu_torch.models.factory import define_net, define_optimizer
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.state import TrainState

    t_phase = time.perf_counter()
    fields = _device_loop_runs()
    config = Config(**_flags("deformpathomic", synthetic_size=8 * DEVICE_LOOP_STEPS,
                             fixdim=MAIN_FIXDIM))
    host = list(Loader(build_datasets(config, "Train"), config.batch_size, shuffle=True,
                       drop_last=True, seed=config.seed))[:DEVICE_LOOP_CHUNK]
    for b in host:
        b.pop("sample_mask")
    dev = torch.device("cuda")
    model = define_net(config, dev, train=True)
    state = TrainState(model, *define_optimizer(config, model, DEVICE_LOOP_STEPS),
                       DropoutRNG.from_seed(1, dev))
    batches = [batch_to_device(config, b, dev) for b in host]
    timing = _device_loop_timing(config, state, host, batches)
    trace = _trace_kernels(config, state, batches[0])
    converter = _converter_check(config, batches[0])
    del state, model, batches
    torch.cuda.empty_cache()
    return_attn = _return_attn_checks()
    ok = (fields["ok"] and trace["ok"] and converter["ok"]
          and all(r["ok"] for r in return_attn.values()))
    _line("device-loop", fixdim=MAIN_FIXDIM, batch=config.batch_size,
          dtype=config.compute_dtype, steps=DEVICE_LOOP_STEPS, chunk=DEVICE_LOOP_CHUNK,
          **fields, timing=timing, return_attn=return_attn, trace=trace,
          flops=_flops_lines(entries), converter=converter,
          wall_s=round(time.perf_counter() - t_phase, 1), card=card["nvidia_smi"])
    if not ok:
        raise AssertionError("device-loop: see the line above")
    torch.cuda.empty_cache()


# phase 21: the ranks of the parallel runs (children of this script, sharing the
# card over gloo), and what each holds against the one-process run
PARALLEL_DP_STEPS, PARALLEL_TIMED = 3, 5
PARALLEL_FLAGS = {
    "dp": _flags("deformpathomic", synthetic_size=24, fixdim=MAIN_FIXDIM, dropout_rate=0.0),
    "dp_f32": _flags("deformpathomic", synthetic_size=24, fixdim=MAIN_FIXDIM, dropout_rate=0.0,
                     compute_dtype="float32"),
    "seq_deform": _flags("deformpathomic", synthetic_size=8, fixdim=4096, dropout_rate=0.0,
                         seq_devices=2),
    "seq_transmil": _flags("transmil", synthetic_size=8, fixdim=4096, seq_devices=2),
}
PARALLEL_TIMEOUT_S = 300
# the launches of each wrapper per rank: the data-parallel steps (4 bags a rank),
# the seq-sharded deformable step (each rank its 32 of 64 query rows) and the
# seq-sharded TransMIL's eval batch and train step (chain 1 on each rank's rows)
_STEP_LAUNCHES = {k: v for k, v in TRAIN_LAUNCHES["deformpathomic"].items()
                  if k != "deform_attention_fwd_dropout"}
PARALLEL_LAUNCHES = {
    "dp": {k: v * PARALLEL_DP_STEPS for k, v in _STEP_LAUNCHES.items()},
    "dp_f32": {**_STEP_LAUNCHES, **F32_LAUNCHES["deformpathomic"]},
    "seq_deform": _STEP_LAUNCHES,
    "seq_transmil": {"deform_attention_fwd": 4, "deform_attention_fwd_nobias": 4,
                     "deform_attention_bwd": 2, "deform_attention_bwd_nobias": 2},
}


@contextlib.contextmanager
def _kernel_shapes(shapes: dict):
    """Record into ``shapes`` the operand shapes of each kernel's first call,
    at the autograd Functions that call the wrappers (the wrappers and their
    launch counts stay as they are): the CPB's dx, dy (forward) and dbias
    (backward); the attention's q, k, v, bias and span (forward) and dout
    (backward)."""
    import importlib

    cpb = importlib.import_module("sml_tpu_torch.ops.kernels.cpb_bias")
    attn = importlib.import_module("sml_tpu_torch.ops.kernels.deform_attn")

    def shape(t):
        return list(t.shape) if torch.is_tensor(t) else t

    def recorder(cls, method, name, n_args):
        fn = getattr(cls, method)

        def call(ctx, *args):
            shapes.setdefault(name, [shape(a) for a in args[:n_args]])
            return fn(ctx, *args)
        return mock.patch.object(cls, method, staticmethod(call))

    with recorder(cpb.CPBBiasTrainable, "forward", "cpb_bias", 2), \
            recorder(cpb.CPBBiasTrainable, "backward", "cpb_bias_bwd", 1), \
            recorder(attn.DeformAttentionTrainable, "forward", "deform_attention_fwd", 4), \
            recorder(attn.DeformAttentionTrainable, "backward", "deform_attention_bwd", 1):
        yield


def _parallel_batches(flags: dict, n: int) -> list:
    """The first ``n`` global train batches of ``flags`` (numpy, no sample_mask)."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data.loader import Loader, build_datasets

    config = Config(**flags)
    loader = Loader(build_datasets(config, "Train"), config.batch_size, shuffle=True,
                    drop_last=True, seed=config.seed)
    batches = []
    for b in loader:
        b.pop("sample_mask")
        batches.append(b)
        if len(batches) == n:
            return batches
    raise AssertionError(f"only {len(batches)} train batches")


def _parallel_train(flags: dict, batches: list, timed: int = 0) -> dict:
    """Train steps of ``flags``'s model from its seeded init on ``batches`` (each
    global; this rank takes its data rows) on the grid of ``seq_devices``: each
    step's loss, the first step's gradients, the final parameters, whether the
    ranks' states were bit-equal after every step, then ``timed`` more steps'
    host times (the card waited for)."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.models.factory import define_net, define_optimizer
    from sml_tpu_torch.ops.common import DropoutRNG
    from sml_tpu_torch.parallel.collectives import fold_seed
    from sml_tpu_torch.parallel.mesh import make_grid, replicas_equal, shard_batch
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.state import TrainState
    from sml_tpu_torch.train.steps import make_train_step

    config, dev = Config(**flags), torch.device("cuda")
    grid = make_grid(config.seq_devices)
    model = define_net(config, dev, train=True)
    optimizer, scheduler = define_optimizer(config, model, len(batches))
    state = TrainState(model, optimizer, scheduler,
                       DropoutRNG.from_seed(fold_seed(config.seed, grid.data_index), dev))
    step = make_train_step(config, model)
    local = [batch_to_device(config, shard_batch(b, grid), dev) for b in batches]
    losses, equal, grads = [], [], None
    for i, b in enumerate(local):
        losses.append(step(state, b)["loss"].float().item())
        if i == 0:
            grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
        equal.append(replicas_equal(state, grid))
    times = [_host_ms(lambda: step(state, local[0])) for _ in range(timed)]
    return {"losses": losses, "grads": grads, "equal": equal, "step_ms": times,
            "params": {n: p.detach().float().cpu() for n, p in model.named_parameters()}}


def _halves_grads(flags: dict, batch: dict) -> dict:
    """The first train step's (modulated) gradients of ``flags``'s model from
    its seeded init, in one process, with the model run on the batch's two
    halves and the loss taken over their outputs together."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.models.factory import define_net, model_inputs
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import compute_mode_loss, modulate_classifier_grads

    config, dev = Config(**flags), torch.device("cuda")
    model = define_net(config, dev, train=True)
    b = batch_to_device(config, batch, dev)
    half = len(b["labels"]) // 2
    outs = [model(**model_inputs(config, {k: v[i:i + half] for k, v in b.items()}))
            for i in (0, half)]
    out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    compute_mode_loss(config, out, b["labels"])[0].backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if config.gradient_modulate and config.fusion_type == "concat":
        with torch.no_grad():
            modulate_classifier_grads(config, model, out, b["labels"])
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def _parallel_eval(flags: dict, batch: dict, timed: int = 0) -> dict:
    """The eval step's outputs on one global batch on the grid of ``seq_devices`` (each
    data rank its rows, the outputs the global batch's), then ``timed`` more
    eval steps' host times."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.models.factory import define_net
    from sml_tpu_torch.parallel.mesh import make_grid, shard_batch
    from sml_tpu_torch.train.evaluate import batch_to_device
    from sml_tpu_torch.train.steps import make_eval_step

    config, dev = Config(**flags), torch.device("cuda")
    step = make_eval_step(config, define_net(config, dev))
    b = batch_to_device(config, shard_batch(batch, make_grid(config.seq_devices)), dev)
    out = {k: v.float().cpu() for k, v in step(b).items()}
    out["step_ms"] = [_host_ms(lambda: step(b)) for _ in range(timed)]
    return out


def _parallel_runs() -> dict:
    """A rank's part of phase 21 on the current process group: the data-parallel
    deformpathomic steps, then on a (1, 2) grid the seq-sharded deformable
    step (dropout off, then on) and the seq-sharded TransMIL eval batch and
    train step; each with its launches and the kernels' shapes, and apart
    from them the step times."""
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {}

    def counted(name, fn):
        shapes = {}
        reset_launch_counts()
        with _kernel_shapes(shapes):
            result = fn()
        torch.cuda.synchronize()
        result.update(launches=launch_counts(), shapes=shapes)
        out[name] = result

    dp_flags = PARALLEL_FLAGS["dp"]
    dp_batches = _parallel_batches(dp_flags, PARALLEL_DP_STEPS)
    counted("dp", lambda: _parallel_train(dp_flags, dp_batches))
    out["dp"]["step_ms"] = _parallel_train(dp_flags, dp_batches[:1],
                                           PARALLEL_TIMED)["step_ms"]
    counted("dp_f32", lambda: _parallel_train(PARALLEL_FLAGS["dp_f32"], dp_batches[:1]))
    seq_flags = PARALLEL_FLAGS["seq_deform"]
    seq_batch = _parallel_batches(seq_flags, 1)
    counted("seq_deform", lambda: _parallel_train(seq_flags, seq_batch))
    drop_flags = dict(seq_flags, dropout_rate=0.1)
    counted("seq_deform_dropout", lambda: _parallel_train(drop_flags, seq_batch))
    out["seq_deform_dropout"]["step_ms"] = _parallel_train(drop_flags, seq_batch,
                                                           PARALLEL_TIMED)["step_ms"]
    tm_flags = PARALLEL_FLAGS["seq_transmil"]
    tm_batch = _parallel_batches(tm_flags, 1)

    def transmil():
        result = _parallel_eval(tm_flags, tm_batch[0])
        result["train"] = _parallel_train(tm_flags, tm_batch)
        return result

    counted("seq_transmil", transmil)
    out["seq_transmil"]["step_ms"] = _parallel_eval(tm_flags, tm_batch[0],
                                                    PARALLEL_TIMED)["step_ms"]
    return out


def _nccl_w1_run() -> dict:
    """One deformpathomic train step (S2500, dropout off) without a process
    group, then the same step in a one-rank NCCL group (the path of a machine
    with a card per rank): both steps' losses and parameters."""
    from sml_tpu_torch.config import Config
    from sml_tpu_torch.parallel import distributed

    flags = PARALLEL_FLAGS["dp"]
    batches = _parallel_batches(flags, 1)
    alone = _parallel_train(flags, batches)
    again = _parallel_train(flags, batches)
    port = _free_port()
    config = Config(**flags, num_processes=1, process_id=0,
                    coordinator_address=f"127.0.0.1:{port}")
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        distributed.initialize(config, "cuda")
    try:
        grouped = _parallel_train(flags, batches)
    finally:
        distributed.shutdown()
    return {"alone": alone, "again": again, "nccl": grouped,
            "printed": captured.getvalue().strip()}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_child(spec_path: str, rank: int) -> int:
    """Body of a phase-21 rank (``chip_smoke.py --parallel-child SPEC RANK``)."""
    import os

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["kind"] == "nccl_w1":
        result = _nccl_w1_run()
    else:
        config = Config(num_processes=spec["world"], process_id=rank,
                        coordinator_address=f"127.0.0.1:{spec['port']}")
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            distributed.initialize(config, "cuda")
        try:
            result = _parallel_runs()
        finally:
            distributed.shutdown()
        result["printed"] = captured.getvalue().strip()
    torch.save(result, os.path.join(spec["dir"], f"{spec['kind']}_rank{rank}.pt"))
    return 0


def _spawn_ranks(kind: str, world: int, root: str) -> list:
    """Run ``world`` ranks of ``kind`` as children of this script; their results."""
    import os

    spec = {"kind": kind, "world": world, "port": _free_port(), "dir": root}
    path = os.path.join(root, f"{kind}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-child",
                               path, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PARALLEL_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"parallel rank {r} of {kind} exited {p.returncode}:\n"
                                 f"{log[-6000:]}")
    return [torch.load(os.path.join(root, f"{kind}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rel_l2(got: dict, want: dict) -> dict:
    """Each tensor's ||got - want|| / ||want||, a tensor under 1e-3 of the
    largest norm against that floor (as in phase 6)."""
    floor = 1e-3 * max(t.norm().item() for t in want.values())
    return {n: (got[n] - want[n]).norm().item() / max(want[n].norm().item(), floor)
            for n in want}


def _top(d: dict, n: int = 3) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])


def phase_parallel(card: dict) -> dict:
    """21. Two ranks as children of this script sharing the card over gloo (the
    port's backend choice: fewer cards than ranks): deformpathomic at S2500
    data-parallel (bf16, global B = 8, 4 a rank, dropout off, 3 train steps;
    one step in f32), deformpathomic at S4096 seq-parallel on a (1, 2) grid (one train step
    with dropout off, held; one with dropout on, the Philox form on each
    rank's rows), TransMIL at S4096 seq-parallel (an eval batch and a train
    step, chain 1 of each rank's rows on #3 / #4); then one rank in an NCCL
    group against the same step without a group.  Each is held against this
    process's run without ranks: the first step's loss and gradients within
    TRAIN_TOL (the later losses and the parameters reported; the bf16
    data-parallel gradients against the one process run on each rank's half
    of the batch, beside the whole batch's, the f32 step against the whole
    batch's), serving outputs within SLICE_TOL; the ranks' states bit-equal after every step; each
    rank's launches of #1-#4 and their shapes; median step times.  The NCCL
    step is reported bit for bit against the one without a group, and held
    to RESUME_PARAM_TOL only where that step does not repeat itself bit for
    bit (``F.grid_sample``'s CUDA backward adds with atomics)."""
    import tempfile

    # the children compute as the CLIs do, in full f32 (no TF32); so must this
    # process, also when the phase runs alone
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    lt, gt = TRAIN_TOL["bfloat16"]
    dp_batches = _parallel_batches(PARALLEL_FLAGS["dp"], PARALLEL_DP_STEPS)
    want = {"dp": _parallel_train(PARALLEL_FLAGS["dp"], dp_batches),
            "dp_f32": _parallel_train(PARALLEL_FLAGS["dp_f32"], dp_batches[:1])}
    # the one-process step that runs the model on each rank's half of the
    # batch, as the ranks do, then the loss over both: the bf16 reference of
    # the ranks' arithmetic (a bf16 product or convolution rounds otherwise
    # at another batch size)
    halves = _halves_grads(PARALLEL_FLAGS["dp"], dp_batches[0])
    seq_flags = {k: v for k, v in PARALLEL_FLAGS["seq_deform"].items() if k != "seq_devices"}
    want["seq_deform"] = _parallel_train(seq_flags, _parallel_batches(seq_flags, 1))
    tm_flags = {k: v for k, v in PARALLEL_FLAGS["seq_transmil"].items() if k != "seq_devices"}
    tm_batch = _parallel_batches(tm_flags, 1)
    want["seq_transmil"] = _parallel_eval(tm_flags, tm_batch[0])
    want["seq_transmil_train"] = _parallel_train(tm_flags, tm_batch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ranks = _spawn_ranks("grid2", 2, root)
        nccl = _spawn_ranks("nccl_w1", 1, root)[0]
    runs, ok = {}, True

    def train_fields(got, ref, tol=(lt, gt), grads_ref=None):
        # held: the first step's loss and summed gradients (against
        # ``grads_ref`` where given); reported: the later steps' losses and the
        # parameters, which Adam moves by about +-lr wherever a gradient lies
        # under its eps, by the sign of rounding noise
        loss_err = [abs(a - b) for a, b in zip(got["losses"], ref["losses"])]
        grad = _rel_l2(got["grads"], ref["grads"])
        held = grad if grads_ref is None else _rel_l2(got["grads"], grads_ref)
        param = _rel_l2(got["params"], ref["params"])
        good = loss_err[0] <= tol[0] and max(held.values()) <= tol[1] and all(got["equal"])
        fields = {"loss_abs_err": loss_err, "grad_rel_l2_top": _top(grad),
                  "param_rel_l2_top": _top(param), "bit_equal_each_step": got["equal"]}
        if grads_ref is not None:
            fields["grad_rel_l2_halves_top"] = _top(held)
        return good, fields

    for name in ("dp", "dp_f32", "seq_deform", "seq_deform_dropout", "seq_transmil"):
        per_rank = []
        for r, res in enumerate(ranks):
            got = res[name]
            launches = {k: v for k, v in got["launches"].items() if v}
            expect = PARALLEL_LAUNCHES.get(name)
            good = expect is None or launches == expect
            fields = {"launches": launches, "shapes": got["shapes"]}
            if name in ("dp", "dp_f32", "seq_deform"):
                g, f = train_fields(got, want[name],
                                    TRAIN_TOL["float32"] if name == "dp_f32" else (lt, gt),
                                    halves if name == "dp" else None)
                good &= g
                fields.update(f, step_ms_median=statistics.median(got["step_ms"] or [math.nan]))
            elif name == "seq_deform_dropout":
                good &= (all(got["equal"]) and all(math.isfinite(v) for v in got["losses"])
                         and launches.get("deform_attention_fwd_dropout") == 2)
                fields.update(losses=got["losses"], bit_equal_each_step=got["equal"],
                              step_ms_median=statistics.median(got["step_ms"]))
            else:
                cmp = {k: _compare(got[k], want["seq_transmil"][k], SLICE_TOL["bfloat16"])
                       for k in ("probs", "loss")}
                g, f = train_fields(got["train"], want["seq_transmil_train"])
                good &= g and all(c["ok"] for c in cmp.values())
                fields.update({"eval_max_abs_err": {k: c["max_abs_err"] for k, c in cmp.items()},
                               "eval_step_ms_median": statistics.median(got["step_ms"]),
                               "train": f})
            fields["ok"] = bool(good)
            ok &= bool(good)
            per_rank.append(fields)
        runs[name] = per_rank
    # ranks of one run hold one state: their final parameters bit-equal
    for name in ("dp", "seq_deform", "seq_deform_dropout"):
        same = all(torch.equal(ranks[0][name]["params"][n], ranks[1][name]["params"][n])
                   for n in ranks[0][name]["params"])
        runs[f"{name}_ranks_bit_equal"] = same
        ok &= same
    nccl_bit = (nccl["nccl"]["losses"] == nccl["alone"]["losses"]
                and all(torch.equal(nccl["nccl"]["params"][n], nccl["alone"]["params"][n])
                        for n in nccl["alone"]["params"]))
    repeat_bit = all(torch.equal(nccl["again"]["params"][n], nccl["alone"]["params"][n])
                     for n in nccl["alone"]["params"])
    nccl_param = max(_rel_l2(nccl["nccl"]["params"], nccl["alone"]["params"]).values())
    nccl_ok = "backend nccl" in nccl["printed"] and (nccl_bit or (
        not repeat_bit and nccl_param <= RESUME_PARAM_TOL))
    ok &= nccl_ok
    _line("parallel", backend=ranks[0]["printed"], runs=runs,
          nccl_w1={"printed": nccl["printed"], "bit_equal": nccl_bit,
                   "alone_repeats_bit_equal": repeat_bit, "param_rel_l2_max": nccl_param,
                   "ok": nccl_ok},
          loss_tol=lt, grad_tol=gt, slice_tol=SLICE_TOL["bfloat16"],
          wall_s=round(time.perf_counter() - t_phase, 1), card=card["nvidia_smi"])
    if not ok:
        raise AssertionError("parallel: see the line above")
    launches = {}
    for name in ("dp", "seq_deform", "seq_deform_dropout", "seq_transmil"):
        counts = dict(ranks[0][name]["launches"])
        counts["deform_attention_fwd_eval"] = (counts["deform_attention_fwd"]
                                               - counts["deform_attention_fwd_dropout"])
        launches[name] = counts
    return launches


# phase 22: the raw patch reader (if_end2end) on the card.  Two TCGA slides of
# copies of the committed 224 x 224 fixtures, one listing RAW_SUBSAMPLE
# coordinates (the uniform subsample to MAIN_FIXDIM) and one RAW_REPEAT (the
# repetition); the kernel timed at RAW_TIMED distinct 4:2:0 patches
JPEG_FIXTURES = "tests/data/jpeg"
RAW_SUBSAMPLE, RAW_REPEAT, RAW_TIMED = 3000, 1000, 2500
# integer operations the pixel stage does, for its bound on the CUDA cores:
# dequantise and the IDCT's two passes per coefficient, upsampling and colour
# per output value
JPEG_OPS_PER_COEF, JPEG_OPS_PER_VALUE = 12, 10


def _as_440(data: bytes) -> bytes:
    """A 4:4:0 file (luma 1x2) from a square 4:2:2 one (luma 2x1): the MCUs hold
    the same blocks, so re-marking the luma's sampling byte in SOF0 gives a
    valid file of shuffled blocks."""
    out = bytearray(data)
    at = out.index(b"\xff\xc0") + 11
    if out[at] != 0x21:
        raise AssertionError("the 4:2:2 fixture's luma is not 2x1")
    out[at] = 0x12
    return bytes(out)


def _jpeg_bound(coef_bytes: int, rows: int, pixels: int, coefs: int) -> tuple:
    """(bound ms, what bounds it) of the pixel stage: the coefficients read
    once and the f32 bag written once at HBM_BYTES_PER_S, against its integer
    operations at the CUDA cores' f32 rate (no int32 peak is published)."""
    n_bytes = coef_bytes + rows * pixels * 3 * 4
    ops = coefs * JPEG_OPS_PER_COEF + rows * pixels * 3 * JPEG_OPS_PER_VALUE
    return _bound(n_bytes, ops, torch.float32)


def phase_raw_patches(card: dict) -> dict:
    """22. The raw patch reader, ``RawPatchReader`` and ``if_end2end``, on the
    card.  ``jpeg_pixels`` against ``jpeg_pixels_plain`` bit for bit on every
    committed fixture (and a 4:4:0 file made from the 4:2:2 one), uint8 and
    f32, then at RAW_TIMED distinct 4:2:0 patches, both timed (the plain
    version on the card too) beside the bound.  A fake TCGA raw cohort beside
    phase 19's (``write_cohort``), two Train slides of RAW_SUBSAMPLE and
    RAW_REPEAT coordinates, read at fixdim MAIN_FIXDIM by ``TCGADataset("Train",
    config, if_end2end=True)`` on cuda through a ``Loader`` of batch 2 with 2
    workers (the reader on the loader's thread): one launch per slide and no
    other, each ``x_path`` bit-equal to the CPU reading of its slide; per
    slide the host entropy stage's ms and patches/s, the kernel's ms and bound,
    the bytes copied to the card; the peak memory."""
    import os
    import tempfile

    import numpy as np

    from sml_tpu_torch.config import Config
    from sml_tpu_torch.data import jpeg
    from sml_tpu_torch.data.datasets import RawPatchReader, TCGADataset, bag_rows
    from sml_tpu_torch.data.loader import Loader
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sml_tpu_torch.ops.kernels.jpeg import jpeg_pixels, jpeg_pixels_plain

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    fixtures = {n[:-4]: open(os.path.join(root, JPEG_FIXTURES, n), "rb").read()
                for n in sorted(os.listdir(os.path.join(root, JPEG_FIXTURES)))
                if n.endswith(".jpg")}
    fixtures["q75_440"] = _as_440(fixtures["q75_422"])
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in fixtures.items():
            with open(f"{tmp}/{name}.jpg", "wb") as f:
                f.write(data)

        # 1) the kernel against its plain version on every fixture, by size
        _, hdr, _ = jpeg.read([f"{tmp}/{n}.jpg" for n in fixtures])
        sizes = {}
        for name, h in zip(fixtures, hdr.tolist()):
            sizes.setdefault((h[1], h[0]), []).append(name)
        equal = {}
        for (height, width), names in sizes.items():
            coef, hdr_s, offsets = jpeg.read([f"{tmp}/{n}.jpg" for n in names], pin=True)
            index = torch.arange(len(names))
            for dtype in (torch.uint8, torch.float32):
                want = jpeg_pixels_plain(coef, hdr_s, offsets, index,
                                         torch.empty((len(names), height, width, 3),
                                                     dtype=dtype))
                got = jpeg_pixels(coef.to(dev), hdr_s, offsets, index,
                                  torch.empty((len(names), height, width, 3), dtype=dtype,
                                              device=dev)).cpu()
                for k, name in enumerate(names):
                    equal[f"{name}/{str(dtype)[6:]}"] = bool(torch.equal(got[k], want[k]))
        _line("raw-patches", step="fixtures", layouts=sorted(fixtures), equal=equal,
              ok=all(equal.values()))
        if not all(equal.values()):
            raise AssertionError(f"jpeg_pixels differs from its plain version: {equal}")

        # 2) at RAW_TIMED distinct 4:2:0 patches: one fixture's coefficients
        # tiled (the kernel transforms each copy), against the plain version
        coef1, hdr1, _ = jpeg.read([f"{tmp}/q75_420.jpg"])
        n_coef = coef1.numel()
        coef = coef1.repeat(RAW_TIMED).to(dev)
        hdr_t = hdr1.repeat(RAW_TIMED, 1)
        offsets = torch.arange(RAW_TIMED, dtype=torch.int64) * n_coef
        index = torch.arange(RAW_TIMED)
        out = torch.empty((RAW_TIMED, 224, 224, 3), device=dev)
        plain = torch.empty_like(out)
        run = lambda: jpeg_pixels(coef, hdr_t, offsets, index, out)   # noqa: E731
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: jpeg_pixels_plain(coef, hdr_t, offsets, index, plain),
                            iters=3, warmup=1)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        bound_ms, bound_by = _jpeg_bound(coef.numel() * 2, RAW_TIMED, 224 * 224,
                                         coef.numel())
        timed = {"name": "jpeg_pixels", "shape": f"{RAW_TIMED} distinct 224x224 4:2:0 "
                 "patches -> f32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                 "coef_mb": coef.numel() * 2 / 1e6, "out_mb": out.numel() * 4 / 1e6}
        _line("raw-patches", step="kernel", **timed, ok=err == 0.0, card=card["nvidia_smi"])
        if err != 0.0:
            raise AssertionError(f"jpeg_pixels at {RAW_TIMED} patches: max error {err}")
        del coef, out, plain

        # 3) the main path: two slides through TCGADataset(if_end2end) on cuda
        data = f"{tmp}/data/"
        write_cohort(data, MAIN_FIXDIM)
        config = Config(dataset="TCGA", dataDir=data, fixdim=MAIN_FIXDIM)
        dataset = TCGADataset("Train", config, if_end2end=True)
        dataset.rows = dataset.rows[:2]          # one slide of each branch
        bag_layouts = [n for n in sorted(sizes[(224, 224)]) if n in fixtures]
        slides = {}
        for row, count in zip(dataset.rows, (RAW_SUBSAMPLE, RAW_REPEAT)):
            slide = row[1]
            sdir = f"{data}TCGA/wsi/{slide}"
            os.makedirs(sdir)
            os.makedirs(f"{data}TCGA/read_details", exist_ok=True)
            coords = np.array([[37 * i, 11 * i + 5] for i in range(count)], dtype=object)
            np.save(f"{data}TCGA/read_details/{slide}.npy",
                    np.array([coords], dtype=object), allow_pickle=True)
            for i, (x, y) in enumerate(coords):
                with open(f"{sdir}/{x}_{y}.jpg", "wb") as f:
                    f.write(fixtures[bag_layouts[i % len(bag_layouts)]])
            names = [f"{sdir}/{coords[i][0]}_{coords[i][1]}.jpg"
                     for i in bag_rows(count, MAIN_FIXDIM)]
            slides[slide] = {"coordinates": count, "distinct": len(set(names)),
                             "paths": list(dict.fromkeys(names)), "names": names}
        loader = Loader(dataset, 2, workers=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        batches = list(loader)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(batches) != 1:
            raise AssertionError(f"expected one batch of 2 slides, got {len(batches)}")
        x_path = batches[0]["x_path"]
        cpu_reader = RawPatchReader(f"{data}TCGA", f"{data}TCGA/wsi", MAIN_FIXDIM,
                                    device="cpu")
        per_slide, ok = [], (x_path.device.type == "cuda"
                             and tuple(x_path.shape) == (2, MAIN_FIXDIM, 224 * 224 * 3))
        for k, (slide, info) in enumerate(slides.items()):
            t0 = time.perf_counter()
            want = cpu_reader(slide)
            cpu_s = time.perf_counter() - t0
            same = bool(torch.equal(x_path[k].cpu(), want))
            # the slide's two stages apart: the host entropy stage, then the kernel
            t0 = time.perf_counter()
            coef, hdr_s, offsets = jpeg.read(info["paths"], pin=True)
            host_ms = (time.perf_counter() - t0) * 1e3
            pos = {p: i for i, p in enumerate(info["paths"])}
            index = torch.tensor([pos[n] for n in info["names"]])
            coef_d = coef.to(dev)
            out = torch.empty((MAIN_FIXDIM, 224, 224, 3), device=dev)
            kernel_ms = _time_ms(lambda: jpeg_pixels(coef_d, hdr_s, offsets, index, out),
                                 iters=10)
            bound_ms, bound_by = _jpeg_bound(coef.numel() * 2, MAIN_FIXDIM, 224 * 224,
                                             coef.numel())
            h2d = coef.numel() * 2 + (hdr_s.numel() + 2 * offsets.numel()
                                      + 2 * index.numel()) * 4
            per_slide.append({
                "slide": slide, "coordinates": info["coordinates"],
                "branch": "subsample" if info["coordinates"] > MAIN_FIXDIM else "repeat",
                "distinct_patches": info["distinct"], "equal_to_cpu_reading": same,
                "host_entropy_ms": host_ms, "threads": jpeg.THREADS,
                "patches_per_s": info["distinct"] / host_ms * 1e3,
                "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "h2d_bytes": h2d, "cpu_reading_s": round(cpu_s, 2)})
            ok &= same
            del coef_d, out
        want_launches = {k: 2 if k == "jpeg_pixels" else 0 for k in launches}
        ok &= launches == want_launches
        _line("raw-patches", step="slides", slides=per_slide, loader_wall_s=round(wall_s, 3),
              loader_patches_per_s=sum(s["distinct"] for s in slides.values()) / wall_s,
              launches=launches, expected_launches=want_launches, peak_gb=peak_gb,
              ok=ok, card=card["nvidia_smi"])
        if not ok:
            raise AssertionError("raw-patches: see the line above")
    _line("raw-patches", step="phase", wall_s=round(time.perf_counter() - t_phase, 1))
    return dict(timed, launches=launches["jpeg_pixels"])


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
# the TransMIL forms: (entry name, source, replaces, launch-count key, the run whose
# counts they report: the TransMIL train run or the bucketed one)
CHAIN_KERNELS = (
    ("deform_attention_fwd_nobias", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:902",
     "deform_attention_fwd_nobias", "tm-train"),
    ("deform_attention_fwd_span", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:843",
     "deform_attention_fwd_span", "bucketed"),
    ("deform_attention_bwd_nobias", "sml_tpu_torch/csrc/deform_attn_bwd.cu",
     f"{PALLAS}:926", "deform_attention_bwd_nobias", "tm-train"),
    ("deform_attention_bwd_span", "sml_tpu_torch/csrc/deform_attn_bwd.cu", f"{PALLAS}:958",
     "deform_attention_bwd_span", "bucketed"),
)
# the f32-bias forms of the 1-D path: (entry name, source, replaces, launch-count
# key, the run whose counts they report: the deform-1d train run)
F32_BIAS_KERNELS = (
    ("deform_attention_fwd_f32bias", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:1016",
     "deform_attention_fwd_f32bias", "deform-1d"),
    ("deform_attention_bwd_f32bias", "sml_tpu_torch/csrc/deform_attn_bwd.cu",
     f"{PALLAS}:1044", "deform_attention_bwd_f32bias", "deform-1d"),
)
# the dh = 32 forms of CMTA's chains: (entry name, source, replaces, launch-count
# key, design; the run whose counts they report is the cmta train run).  Both
# run on the tf32 tensor cores, three products for each f32 one
DH32_KERNELS = (
    ("deform_attention_fwd_dh32", "sml_tpu_torch/csrc/deform_attn.cu", f"{PALLAS}:1016",
     "deform_attention_fwd_dh32", "3xTF32 mma.sync"),
    ("deform_attention_bwd_dh32", "sml_tpu_torch/csrc/deform_attn_bwd.cu", f"{PALLAS}:1044",
     "deform_attention_bwd_dh32", "3xTF32 mma.sync"),
)
_TIMES = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
_DH32 = ("parts_ms", "bound_3xtf32_ms", "max_err_of_scale", "max_err_of_scale_f64",
         "max_err_f64", "plain_err_f64", "lse_equal_bwd")
# the bf16 entries run on the tensor cores (csrc/mma.cuh)
DESIGN_BF16 = "mma.sync"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    phase_build()
    phase_ragged()
    phase_cpb_ragged()
    entries = phase_kernels()
    serving = {fixdim: phase_slice(fixdim, card) for fixdim in SHAPES}
    launches = phase_train(card)
    # the train entry point's run: forward launches split into eval form and dropout
    launches["deform_attention_fwd_eval"] = (launches["deform_attention_fwd"]
                                             - launches["deform_attention_fwd_dropout"])
    chains = phase_chains()
    tm_serving = {fixdim: phase_slice(fixdim, card, "transmil") for fixdim in SHAPES}
    runs = {"tm-train": phase_train(card, "transmil"), "bucketed": phase_bucketed(card)}
    # 10b. f32-train: deformpathomic and TransMIL at the default compute dtype
    f32_runs = phase_f32_train(card)
    # 11. deform-masked: bucketed bags (J = 64 / 144), then a non-square fixdim
    # (2000 patches padded to 45 x 45, J = 121)
    phase_bucketed(card, "deformpathomic", "deform-masked")
    phase_slice(2000, card, label="deform-masked")
    # 12. deform-1d: attn_dim 1 at 2500 patches (N = 2501, J = 625)
    d1_serving = phase_slice(MAIN_FIXDIM, card, "deform1d")
    runs["deform-1d"] = phase_train(card, "deform1d")
    # 13. deform-fusion: BilinearFusion and its BatchNorm statistics
    phase_train(card, extra={"fusion_type": "pofusion"}, label="deform-fusion")
    # 14. modes: the modes that run no kernel
    phase_modes(card)
    # 15. cmta-kernels, 16. cmta: the f32 dh = 32 forms, then CMTA in f32 and bf16
    dh32 = phase_cmta_kernels()
    cmta_serving = phase_slice(MAIN_FIXDIM, card, "cmta")
    runs["cmta"] = phase_train(card, "cmta")
    phase_modes(card, CMTA_BF16, label="cmta")
    # 17. resume, 18. remat: the rest of a training run
    phase_resume(card)
    phase_remat(card)
    # 19. cohort: the real-data workflow (readers, packed files, attribution)
    phase_cohort(card)
    # 20. device-loop: the device loop, return_attn, the profiler, FLOPs, the converter
    phase_device_loop(card, entries)
    # 21. parallel: data- and sequence-parallel ranks against the one-process runs
    parallel = phase_parallel(card)
    # 22. raw-patches: RawPatchReader and if_end2end, the JPEG pixel stage's kernel
    raw = phase_raw_patches(card)
    kernels = []
    for name, source, replaces, count in JSON_KERNELS:
        e = entries[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[count],
                        **{k: e[k] for k in _TIMES},
                        "design": DESIGN_BF16,
                        "launches_serving_s2500": serving[MAIN_FIXDIM].get(name, 0),
                        "launches_parallel_rank0": {run: c[count]
                                                    for run, c in parallel.items()},
                        "shape": f"BG={BG} N={e['n']} J={e['j']} bf16"})
    for name, source, replaces, count, run in CHAIN_KERNELS:
        e, e1 = chains[(name, "chain3")], chains[(name, "chain1")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": runs[run][count],
                        "launches_run": run, **{k: e[k] for k in _TIMES},
                        "design": DESIGN_BF16,
                        "launches_tm_serving_s2500": tm_serving[MAIN_FIXDIM].get(count, 0),
                        "launches_parallel_rank0": {run: c[count]
                                                    for run, c in parallel.items()},
                        "shape": f"chain 3: BG={BG} N={e['n']} J={e['j']} bf16",
                        "chain1": {"shape": f"BG={BG} N={e1['n']} J={e1['j']} bf16",
                                   **{k: e1[k] for k in _TIMES}}})
    for name, source, replaces, count, run in F32_BIAS_KERNELS:
        e = entries[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": runs[run][count],
                        "launches_run": run, **{k: e[k] for k in _TIMES},
                        "design": DESIGN_BF16,
                        "launches_serving_1d": d1_serving.get(count, 0),
                        "shape": f"BG={BG} N={e['n']} J={e['j']} bf16, bias f32"})
    # the f32 dh = 64 forward and backward (the default compute dtype's): phase
    # 4's bias form with dropout at S2500, phase 7's f32 chains, the f32-train
    # launches
    for name, source, replaces, extra in (
            ("deform_attention_fwd_f32", "sml_tpu_torch/csrc/deform_attn.cu",
             f"{PALLAS}:1016", ("max_err_f64", "plain_err_f64", "lse_equal_bwd")),
            ("deform_attention_bwd_f32", "sml_tpu_torch/csrc/deform_attn_bwd.cu",
             f"{PALLAS}:1044", ())):
        e = entries[name]
        chain = {c: chains[(name.replace("_f32", "_nobias_f32"), c)]
                 for c in ("chain3", "chain1")}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": f32_runs["deformpathomic"][name],
                        "launches_run": "f32-train", **{k: e[k] for k in _TIMES + extra},
                        "bound_3xtf32_ms": e["bound_3xtf32_ms"], "design": "3xTF32 mma.sync",
                        "launches_transmil_f32": f32_runs["transmil"][name],
                        "shape": f"f32 dh=64, BG={BG} N={e['n']} J={e['j']}, bias, dropout",
                        **{c: {"shape": f"f32 dh=64, bias-less, BG={BG} N={x['n']} J={x['j']}",
                               **{k: x[k] for k in _TIMES + ("bound_3xtf32_ms",) + extra}}
                           for c, x in chain.items()}})
    # the f32 CPB forward and backward (the default compute dtype's): phase 4 at
    # S2500, the f32-train launches
    for name, source, replaces, _ in JSON_KERNELS[:2]:
        e = entries[name + "_f32"]
        kernels.append({"name": name + "_f32", "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": f32_runs["deformpathomic"][name + "_f32"],
                        "launches_run": "f32-train", **{k: e[k] for k in _TIMES},
                        "bound_3xtf32_ms": e["bound_3xtf32_ms"], "design": "3xTF32 mma.sync",
                        **{k: e[k] for k in ("max_rel_l2_err", "rel_l2_f64", "plain_rel_l2_f64",
                                             "max_abs_err_f64", "plain_max_abs_err_f64")
                           if k in e},
                        "shape": f"f32, BG={BG} N={e['n']} J={e['j']} dm={DM}"})
    for name, source, replaces, count, design in DH32_KERNELS:
        e, e1 = dh32[(name, "chain3")], dh32[(name, "chain1")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": runs["cmta"][count],
                        "launches_run": "cmta", **{k: e[k] for k in _TIMES},
                        "design": design,
                        "launches_cmta_serving": cmta_serving.get(count, 0),
                        "shape": f"f32 dh=32, chain 3: BG={BG} N={e['n']} J={e['j']}",
                        **{k: e[k] for k in _DH32 if k in e},
                        "chain1": {"shape": f"f32 dh=32, BG={BG} N={e1['n']} J={e1['j']}",
                                   **{k: e1[k] for k in _TIMES + _DH32 if k in e1}}})
    kernels.append({"name": "jpeg_pixels", "route": "cuda",
                    "source": "sml_tpu_torch/csrc/jpeg_pixels.cu",
                    "replaces": "sml_tpu/data/datasets.py:109 (PIL's decode; no Pallas kernel)",
                    "launches": raw["launches"], "launches_run": "raw-patches",
                    **{k: raw[k] for k in _TIMES}, "design": "CUDA cores, int32",
                    "shape": raw["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
