"""Kernel A: the CPB bias forward (``csrc/cpb_bias.cu``, CUDA C++ for sm_90a).

Replaces the Pallas kernel ``fused_cpb_bias``
(``sml_tpu/ops/pallas/deform_attn.py:335``, body ``_fwd_kernel`` at ``:247``):
``bias[bg, y, x*J + j] = w2 . relu(w1^T relu(w0x dx[bg, x*J+j] + w0y dy[bg, y, j]
+ b0) + b1) + b2`` for every query row y, query column x and kv point j.

What bounds it on the H100: operations.  Each (query, kv) pair runs the
2 -> dm -> dm -> 1 MLP, 2*dm^2 + 6*dm + 1 = 2241 FLOP at dm=32, and writes
2 bytes of bf16 bias: about 1100 FLOP per byte, far above the card's ridge of
about 295 bf16 FLOP per byte.  At the 2500-patch shape (BG=64, 50x50 queries,
J=144) one branch is 23.0 M pairs, 51.6 GFLOP: 52 us at the 989 TFLOP/s bf16
tensor-core peak, against 46 MB of output, 14 us at 3.35 TB/s.

What the design does about it: the (BG, N, J, dm) activations never reach
device memory.  Layer 1 is built in registers from the thin dx / dy
displacement tables; one block per (bg, query row) keeps the weights and the
row's dy in shared memory; each thread runs the whole per-pair MLP in f32
registers for two lanes at a time, so each broadcast weight load feeds two
FMAs.  Layer 2 runs on the CUDA cores (67 TFLOP/s f32), not the tensor cores,
so this first kernel lands well short of the bound; moving layer 2 onto
``wgmma`` is later work.

``cpb_bias_plain`` is the same function in plain PyTorch.  ``cpb_bias`` takes
it only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sml_tpu_torch.ops.kernels import _build

KERNEL_DMS = (8, 16, 32)     # dm instantiated in the kernel (csrc/cpb_bias.cu)
MAX_J = 8192                 # the row's dy stays under 48 KB of shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("cpb_bias")
        lib.cpb_bias_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.cpb_bias_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(dx, dy, weights):
    """Validate shapes / dtypes / devices; returns (bg, h, w, j, dm)."""
    if dx.dim() != 2 or dy.dim() != 3:
        raise ValueError(f"dx must be (BG, W*J) and dy (BG, H, J); got "
                         f"{tuple(dx.shape)} and {tuple(dy.shape)}")
    bg, wj = dx.shape
    _, h, j = dy.shape
    if dy.shape[0] != bg or wj % j:
        raise ValueError(f"dx {tuple(dx.shape)} does not match dy {tuple(dy.shape)}")
    if dx.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError("dx and dy must be float32")
    w0x, w0y, b0, w1, b1, w2, b2 = weights
    dm = w1.shape[0]
    shapes = [(dm,), (dm,), (dm,), (dm, dm), (dm,), (dm, 1), (1,)]
    for t, shape in zip(weights, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"CPB weight shape {tuple(t.shape)} != {shape}")
        if t.dtype != w1.dtype:
            raise TypeError("CPB weights must share one dtype")
    if w1.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {w1.dtype} is not float32 or bfloat16")
    for t in (dy, *weights):
        if t.device != dx.device:
            raise ValueError("all inputs must be on one device")
    for t in (dx, dy, *weights):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return bg, h, wj // j, j, dm


def cpb_bias_plain(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """(BG, H, W*J) bias in the weights' dtype, computed in f32, rows in chunks
    so the (BG, rows, W, J, dm) activations stay under 2**26 elements."""
    bg, wj = dx.shape
    _, h, j = dy.shape
    w = wj // j
    dm = w1.shape[0]
    out = torch.empty((bg, h, wj), dtype=w1.dtype, device=dx.device)
    w0x, w0y, b0, w1, b1, w2, b2 = (t.float() for t in (w0x, w0y, b0, w1, b1, w2, b2))
    u = dx.reshape(bg, 1, w, j, 1) * w0x                           # (BG, 1, W, J, dm)
    rows = max(1, (1 << 26) // (bg * wj * dm))
    for y0 in range(0, h, rows):
        v = dy[:, y0:y0 + rows, None, :, None] * w0y + b0          # (BG, r, 1, J, dm)
        h2 = torch.relu(torch.relu(u + v) @ w1 + b1)
        bias = (h2 @ w2)[..., 0] + b2                              # (BG, r, W, J)
        out[:, y0:y0 + rows] = bias.reshape(bg, -1, wj)
    return out


def cpb_bias(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """(BG, H, W*J) CPB bias, lane order x*J + j, in the weights' dtype.

    dx (BG, W*J) f32 and dy (BG, H, J) f32 are the signed-log displacement
    tables; w0x, w0y, b0, b1 (dm,), w1 (dm, dm), w2 (dm, 1), b2 (1,) share the
    compute dtype (float32 or bfloat16).  CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    weights = (w0x, w0y, b0, w1, b1, w2, b2)
    bg, h, w, j, dm = _check(dx, dy, weights)
    if dx.device.type == "cpu":
        return cpb_bias_plain(dx, dy, *weights)
    if dx.device.type != "cuda":
        raise ValueError(f"cpb_bias runs on cpu or cuda, not {dx.device}")
    if dm not in KERNEL_DMS:
        raise ValueError(f"cpb_bias kernel has dm in {KERNEL_DMS}, not {dm}")
    if j > MAX_J:
        raise ValueError(f"cpb_bias kernel takes J <= {MAX_J}, not {j}")
    out = torch.empty((bg, h, w * j), dtype=w1.dtype, device=dx.device)
    lib = _library()
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cpb_bias_fwd(_DTYPE_CODE[w1.dtype], dx.data_ptr(), dy.data_ptr(),
                              *(t.data_ptr() for t in weights), out.data_ptr(),
                              bg, h, w, j, dm, dx.device.index, stream)
    _build.check(rc, "cpb_bias")
    cpb_bias.launches += 1
    return out


cpb_bias.launches = 0
