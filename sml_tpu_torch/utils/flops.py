"""Analytic FLOP counts of the deformpathomic kernels (counterpart of
``sml_tpu/utils/flops.py``, its arithmetic unchanged).

A profiler sees the hand-written kernels' time but not their arithmetic, so a
share of peak needs the model FLOPs they execute counted by hand.  Counting
convention: useful model FLOPs only (the standard MFU convention); a kernel's
padding is not counted.

Reference geometry (reference ``models/DeformableAttention2D.py:186-213``,
``models/DeformCrossTransMIL.py:79-160``): dim=128, heads=groups=8,
dim_head=64, CPB MLP width dm=dim//4=32, offset conv kernel 6 / stride 4 /
pad 1, two branches (tumor/immune).
"""

from __future__ import annotations

import math
from typing import Dict

DIM, HEADS, DIM_HEAD, BRANCHES = 128, 8, 64, 2    # the reference geometry above


def deform_grid(n: int, downsample: int = 4, kernel: int = 6) -> Dict[str, int]:
    """Query/kv grid sizes for an N-token bag (model pads N to side**2)."""
    side = int(math.ceil(math.sqrt(n)))
    pad = (kernel - downsample) // 2
    kv_side = (side + 2 * pad - kernel) // downsample + 1
    return {"side": side, "n_grid": side * side, "j": kv_side * kv_side}


def _cpb_per_pair(dm: int, training: bool, executed: bool) -> float:
    """FLOPs per (query position, kv position) displacement pair.

    Forward: h1 = relu(u + v_rep) [2*dm]; layer-2 matmul w1^T @ h1 [2*dm*dm] +
    bias + relu [2*dm]; layer-3 w2 @ h2 [2*dm] + b2 [1].  (The layer-1 2->dm
    projection is folded into the u/v factor tables built outside the kernel,
    not counted here.)

    Backward model math: dw2 [2*dm]; db2 [1]; dh2 outer [2*dm]; relu mask [dm];
    dw1 contraction [2*dm*dm]; db1 [dm]; dh1 = w1 @ dz2 [2*dm*dm]; relu masks
    [2*dm]; du += [dm]; dv fold [dm].  ``executed=True`` adds the recompute of
    h1/z2/h2 [2*dm*dm + 4*dm] the backward kernel runs (it keeps no
    residuals); the MFU convention excludes rematerialisation, so
    ``executed=False`` is what a share of peak reads.
    """
    fwd = 2 * dm * dm + 6 * dm + 1
    bwd = 4 * dm * dm + 9 * dm + 1
    if executed:
        bwd += 2 * dm * dm + 4 * dm
    return fwd + (bwd if training else 0)


def _epilogue_per_pair(dh: int, training: bool, executed: bool) -> float:
    """FLOPs per (query token, kv position) pair of the fused attention.

    Forward: q @ k^T [2*dh]; bias add [1]; softmax (max, sub, exp, sum, div)
    [~5]; dropout mult [1]; attn @ v [2*dh].
    Backward model math: dv = p^T @ dout [2*dh]; dp = dout @ v^T [2*dh];
    softmax backward [~4]; dq = ds @ k [2*dh]; dk = ds^T @ q [2*dh].
    ``executed=True`` adds the in-kernel forward recompute [2*dh + 7].
    """
    fwd = 4 * dh + 7
    bwd = 8 * dh + 4
    if executed:
        bwd += 2 * dh + 7
    return fwd + (bwd if training else 0)


def deformpathomic_flops(batch_size: int, fixdim: int, *, training: bool = True,
                         executed: bool = False) -> float:
    """Per-step FLOPs inside the CPB and attention kernels of deformpathomic
    (counterpart of ``deformpathomic_pallas_flops``), counted by the port's
    routing: on the card every CPB and every attention of the model runs in
    its kernel (offset groups = heads, as the model requires), in training and
    in eval, with no shape gate.  The JAX count keeps each term only where its
    TPU gates (``pallas_cpb_supported``, ``fused_attention_padding``: VMEM
    tilings, and on the serving path no padded rows) send the shape to a
    Pallas kernel, so the two counts are equal where those gates admit the
    shape and differ by exactly the refused kernel's term where they do not.

    ``executed=False`` (default) counts model FLOPs, the MFU convention that
    leaves out the backward's recompute; ``executed=True`` counts what the
    card runs, recompute included.
    """
    g = deform_grid(fixdim)
    pairs = batch_size * HEADS * g["n_grid"] * g["j"]     # per branch, both kernels
    return float(BRANCHES * pairs * (_cpb_per_pair(DIM // 4, training, executed)
                                     + _epilogue_per_pair(DIM_HEAD, training, executed)))


def a100_roofline_bags_per_sec(batch_size: int, fixdim: int) -> Dict[str, float]:
    """Bytes-roofline bound on the PyTorch reference's A100 train-step rate at
    this shape, at the A100's 1.7 TB/s — deliberately optimistic for the reference (perfect bandwidth,
    zero launch overhead, CPB traffic only).  Full byte accounting in
    ``benchmarks/a100_roofline.md``; anchor: 154 GB/step at B=8 x N=2500
    (23.04M displacement pairs per branch), scaled by the pair count.

    Returns the perfect-bandwidth bound and the realistic band (56-80% of
    perfect: unfused elementwise chains sustain 60-80% of peak bandwidth and
    non-CPB work adds ~20%).
    """
    g = deform_grid(fixdim)
    pairs = batch_size * 8 * g["n_grid"] * g["j"]          # per branch
    anchor_pairs = 8 * 8 * 2500 * 144                      # B=8, N=2500
    bytes_per_step = 154e9 * pairs / anchor_pairs
    perfect = batch_size / (bytes_per_step / 1.7e12)
    return {"perfect": perfect,
            "realistic_lo": 0.565 * perfect,
            "realistic_hi": 0.80 * perfect}
