"""Kernels A and C: the CPB bias forward (``csrc/cpb_bias.cu``) and its
recompute backward (``csrc/cpb_bias_bwd.cu``), CUDA C++ for sm_90a, and the
``torch.autograd.Function`` around them.

Replaces the Pallas kernels ``fused_cpb_bias``
(``sml_tpu/ops/pallas/deform_attn.py:335``, body ``_fwd_kernel`` at ``:247``)
and ``_cpb_bwd_call`` (``:587``, body ``_bwd_kernel`` at ``:417``), reached
through the custom VJP ``cpb_bias_trainable`` (``:733``):
``bias[bg, y, x*J + j] = w2 . relu(w1^T relu(w0x dx[bg, x*J+j] + w0y dy[bg, y, j]
+ b0) + b1) + b2`` for every query row y, query column x and kv point j.

What bounds them on the H100: operations.  Each (query, kv) pair runs the
2 -> dm -> dm -> 1 MLP, 2*dm^2 + 6*dm + 1 = 2241 FLOP at dm=32, and writes
2 bytes of bf16 bias: about 1100 FLOP per byte, far above the card's ridge of
about 295 bf16 FLOP per byte.  At the 2500-patch shape (BG=64, 50x50 queries,
J=144) one branch is 23.0 M pairs, 51.6 GFLOP: 52 us at the 989 TFLOP/s bf16
tensor-core peak, against 46 MB of output, 14 us at 3.35 TB/s.  The backward
recomputes the MLP and adds two more dm x dm products per pair, about
6*dm^2 + 16*dm FLOP, against 2 bytes of dbias.

What the designs do about it: the (BG, N, J, dm) activations never reach
device memory in either direction.  Layer 1 is built in registers from the
thin dx / dy displacement tables.  The forward runs one block per (bg, query
row) with the weights and the row's dy in shared memory.  Its bf16 form
(``tc::cpb_bias_fwd_tc``) runs layer 2 on the tensor cores (``mma.sync``,
``csrc/mma.cuh``), 16 pairs per warp step, with layers 1 and 3 (9% of the
FLOP, and most of the instructions) in f32 on the CUDA cores; its f32 form
(``tf32::cpb_bias_fwd_tf32``) on the tf32 tensor cores as 3xTF32, 32 pairs per
warp step.  The backward
runs one block per (bg, tile of 512 lanes) over all rows: d_dx stays on chip,
d_dy and the weight gradients leave as small per-block partials that the
wrapper sums, in a fixed order with no atomics, so it repeats bit for bit.
Its bf16 form runs the three dm x dm products per pair on the tensor cores,
its f32 form (``tf32::cpb_bias_bwd_tf32``) on the tf32 tensor cores as
3xTF32 (three tf32 products for each f32 one).  In each dtype the forward
and the backward compute layers 1 and 2 with one piece of code
(``csrc/cpb_common.cuh``: ``cpb`` in bf16, ``cpb::tf32`` in f32), so the
backward's recomputed z2, and its layer-2 ReLU mask, are the forward's bit for
bit.  ``wgmma`` is later work.

Rounding points of the bf16 forms, each one where the Pallas kernels round
too: h1 to bf16 before layer 2 (forward and backward), dz2 to bf16 before its
products with w1, dx and dy to bf16 in dw0x and dw0y; every sum, z2, h2 and
layer 3 in f32; each output rounded once.  (Pallas also runs layer 1 in bf16;
the port keeps it in f32.)  The plain versions round at the same points, so they
specify what the kernels compute.

On CPU tensors the wrappers take the plain versions; on CUDA tensors they
launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sml_tpu_torch.ops.kernels import _build

KERNEL_DMS = (8, 16, 32)     # dm instantiated in the kernel (csrc/cpb_bias.cu)
MAX_J = 8192                 # the row's dy stays under 48 KB of shared memory
BWD_TILE = 512               # lanes per backward block (kTile in csrc/cpb_bias_bwd.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "cpb_bias":
            lib.cpb_bias_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            lib.cpb_bias_fwd.restype = ctypes.c_int
        else:
            lib.cpb_bias_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                                         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            lib.cpb_bias_bwd.restype = ctypes.c_int
        _libs[name] = lib
    return lib


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


def _rounder(dtype):
    """x -> x rounded to bf16 and back for bf16 weights, else x unchanged."""
    return (lambda t: t.bfloat16().float()) if dtype == torch.bfloat16 else (lambda t: t)


def _layer1(dx, dy, w0x, w0y, b0, y0, rows):
    """(BG, r, W, J, dm) pre-activation a = w0x dx + (w0y dy + b0) of rows
    [y0, y0 + rows), in f32."""
    bg, wj = dx.shape
    j = dy.shape[-1]
    u = dx.reshape(bg, 1, wj // j, j, 1) * w0x
    return u + (dy[:, y0:y0 + rows, None, :, None] * w0y + b0)


def cpb_bias_plain(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """(BG, H, W*J) bias in the weights' dtype, computed in f32, rows in chunks
    so the (BG, rows, W, J, dm) activations stay under 2**26 elements.  With
    bf16 weights h1 is rounded to bf16 before layer 2, where the Pallas kernel
    and the tensor-core kernel round it; z2, h2 and layer 3 stay f32."""
    bg, wj = dx.shape
    _, h, j = dy.shape
    dm = w1.shape[0]
    out = torch.empty((bg, h, wj), dtype=w1.dtype, device=dx.device)
    rnd = _rounder(w1.dtype)
    w0x, w0y, b0, w1, b1, w2, b2 = (t.float() for t in (w0x, w0y, b0, w1, b1, w2, b2))
    rows = max(1, (1 << 26) // (bg * wj * dm))
    for y0 in range(0, h, rows):
        h1 = rnd(torch.relu(_layer1(dx, dy, w0x, w0y, b0, y0, rows)))
        h2 = torch.relu(h1 @ w1 + b1)
        bias = (h2 @ w2)[..., 0] + b2                              # (BG, r, W, J)
        out[:, y0:y0 + rows] = bias.reshape(bg, -1, wj)
    return out


def cpb_bias(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """(BG, H, W*J) CPB bias, lane order x*J + j, in the weights' dtype.

    dx (BG, W*J) f32 and dy (BG, H, J) f32 are the signed-log displacement
    tables; w0x, w0y, b0, b1 (dm,), w1 (dm, dm), w2 (dm, 1), b2 (1,) share the
    compute dtype (float32 or bfloat16).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (bf16: the tensor-core kernel; f32: the
    3xTF32 kernel on the tf32 tensor cores, counted apart in ``f32_launches``
    too).
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
    lib = _library("cpb_bias")
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cpb_bias_fwd(_DTYPE_CODE[w1.dtype], dx.data_ptr(), dy.data_ptr(),
                              *(t.data_ptr() for t in weights), out.data_ptr(),
                              bg, h, w, j, dm, dx.device.index, stream)
    _build.check(rc, "cpb_bias")
    cpb_bias.launches += 1
    if w1.dtype == torch.float32:
        cpb_bias.f32_launches += 1
    return out


cpb_bias.launches = cpb_bias.f32_launches = 0


def cpb_bias_bwd_plain(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias):
    """Gradients of :func:`cpb_bias_plain` from ``dbias`` (BG, H, W*J): the
    formulas of ``_bwd_kernel`` written out in f32, rows in chunks so the
    (BG, rows, W, J, dm) activations stay under 2**26 elements.  With bf16
    weights it rounds where the Pallas kernel and the tensor-core kernel round:
    h1 and dz2 to bf16 before the products with w1 and before dw1, dx and dy to
    bf16 in dw0x and dw0y; every sum stays f32.  Returns (d_dx, d_dy, dw0x,
    dw0y, db0, dw1, db1, dw2, db2): d_dx, d_dy f32, the weight gradients in the
    weights' dtype."""
    bg, wj = dx.shape
    _, h, j = dy.shape
    w = wj // j
    dm = w1.shape[0]
    wdt = w1.dtype
    rnd = _rounder(wdt)
    w0x, w0y, b0, w1, b1, w2 = (t.float() for t in (w0x, w0y, b0, w1, b1, w2))
    ddx = torch.zeros((bg, w, j), dtype=torch.float32, device=dx.device)
    ddy = torch.empty((bg, h, j), dtype=torch.float32, device=dx.device)
    acc = {k: torch.zeros(s, dtype=torch.float32, device=dx.device)
           for k, s in (("w0x", dm), ("w0y", dm), ("b0", dm), ("w1", (dm, dm)),
                        ("b1", dm), ("w2", dm), ("b2", 1))}
    dxr = rnd(dx).reshape(bg, 1, w, j)
    rows = max(1, (1 << 26) // (bg * wj * dm))
    for y0 in range(0, h, rows):
        a = _layer1(dx, dy, w0x, w0y, b0, y0, rows)                 # (BG, r, W, J, dm)
        h1 = rnd(torch.relu(a))
        z2 = h1 @ w1 + b1
        g = dbias[:, y0:y0 + rows].float().reshape(bg, -1, w, j)    # (BG, r, W, J)
        acc["w2"] += torch.einsum("brxjm,brxj->m", torch.relu(z2), g)
        acc["b2"] += g.sum()
        dz2 = torch.where(z2 > 0, w2[:, 0] * g[..., None], 0.0)
        acc["b1"] += dz2.sum(dim=(0, 1, 2, 3))
        dz2 = rnd(dz2)
        acc["w1"] += torch.einsum("brxjk,brxjm->km", h1, dz2)
        dz1 = torch.where(a > 0, dz2 @ w1.T, 0.0)
        ddx += (dz1 @ w0x).sum(dim=1)
        ddy[:, y0:y0 + rows] = (dz1 @ w0y).sum(dim=2)
        acc["w0x"] += torch.einsum("brxjk,bxj->k", dz1, dxr[:, 0])
        dyr = rnd(dy[:, y0:y0 + rows, None, :])
        acc["w0y"] += torch.einsum("brxjk,brxj->k", dz1, dyr.expand_as(g))
        acc["b0"] += dz1.sum(dim=(0, 1, 2, 3))
    return (ddx.reshape(bg, wj), ddy, acc["w0x"].to(wdt), acc["w0y"].to(wdt),
            acc["b0"].to(wdt), acc["w1"].to(wdt), acc["b1"].to(wdt),
            acc["w2"].reshape(dm, 1).to(wdt), acc["b2"].to(wdt))


def cpb_bias_bwd(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias):
    """Gradients of :func:`cpb_bias` from ``dbias`` (BG, H, W*J) in the
    weights' dtype: (d_dx (BG, W*J) f32, d_dy (BG, H, J) f32, dw0x, dw0y, db0,
    dw1, db1, dw2, db2 in the weights' dtype), recomputed from the inputs.
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16:
    the tensor-core kernel; f32: the 3xTF32 kernel on the tf32 tensor cores,
    counted apart in ``f32_launches`` too), whose per-block partials of d_dy
    and the weight gradients are summed here."""
    weights = (w0x, w0y, b0, w1, b1, w2)
    bg, h, w, j, dm = _check(dx, dy, weights + (w2.new_zeros(1),))
    if tuple(dbias.shape) != (bg, h, w * j) or dbias.dtype != w1.dtype:
        raise ValueError(f"dbias {tuple(dbias.shape)} {dbias.dtype} does not match "
                         f"the bias ({bg}, {h}, {w * j}) {w1.dtype}")
    if dbias.device != dx.device or not dbias.is_contiguous():
        raise ValueError("dbias must be contiguous on the inputs' device")
    if dx.device.type == "cpu":
        return cpb_bias_bwd_plain(dx, dy, *weights, dbias)
    if dx.device.type != "cuda":
        raise ValueError(f"cpb_bias_bwd runs on cpu or cuda, not {dx.device}")
    if dm not in KERNEL_DMS:
        raise ValueError(f"cpb_bias_bwd kernel has dm in {KERNEL_DMS}, not {dm}")
    tiles = -(-(w * j) // BWD_TILE)
    f32 = dict(dtype=torch.float32, device=dx.device)
    ddx = torch.empty((bg, w * j), **f32)
    ddy_part = torch.empty((bg, tiles, h, j), **f32)
    wpart = torch.empty((bg, tiles, dm * dm + 5 * dm + 1), **f32)
    lib = _library("cpb_bias_bwd")
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cpb_bias_bwd(_DTYPE_CODE[w1.dtype], dx.data_ptr(), dy.data_ptr(),
                              *(t.data_ptr() for t in weights), dbias.data_ptr(),
                              ddx.data_ptr(), ddy_part.data_ptr(), wpart.data_ptr(),
                              bg, h, w, j, dm, dx.device.index, stream)
    _build.check(rc, "cpb_bias_bwd")
    cpb_bias_bwd.launches += 1
    if w1.dtype == torch.float32:
        cpb_bias_bwd.f32_launches += 1
    wsum = wpart.sum(dim=(0, 1)).to(w1.dtype)
    dw1, rest = wsum[:dm * dm].reshape(dm, dm), wsum[dm * dm:]
    dw0x, dw0y, db0, db1, dw2 = rest[:5 * dm].reshape(5, dm)
    return (ddx, ddy_part.sum(dim=1), dw0x, dw0y, db0, dw1, db1, dw2.reshape(dm, 1),
            rest[5 * dm:])


cpb_bias_bwd.launches = cpb_bias_bwd.f32_launches = 0


class CPBBiasTrainable(torch.autograd.Function):
    """Forward kernel + recompute backward kernel; saves only the inputs."""

    @staticmethod
    def forward(ctx, dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
        ctx.save_for_backward(dx, dy, w0x, w0y, b0, w1, b1, w2)
        return cpb_bias(dx, dy, w0x, w0y, b0, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dbias):
        return cpb_bias_bwd(*ctx.saved_tensors, dbias.contiguous())


def cpb_bias_trainable(dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
    """Differentiable :func:`cpb_bias` (the counterpart of the custom VJP
    ``cpb_bias_trainable``): gradients for all nine inputs."""
    return CPBBiasTrainable.apply(dx, dy, w0x, w0y, b0, w1, b1, w2, b2)
