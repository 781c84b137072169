"""Kernels B and D: the deformable-attention forward (``csrc/deform_attn.cu``) and
its recompute backward (``csrc/deform_attn_bwd.cu``), CUDA C++ for sm_90a, and
the ``torch.autograd.Function`` around them.

Replaces the Pallas kernels ``_fused_attn_fwd_call``
(``sml_tpu/ops/pallas/deform_attn.py:1016``, body ``_attn_fwd_kernel`` at
``:894``, dropout ``_dropout_mult`` at ``:877``) and ``_fused_attn_bwd_call``
(``:1044``, body ``_attn_bwd_kernel`` at ``:918``), reached through the custom
VJP ``deform_attention_trainable`` (``:1099``), with a bias and no span mask:
``out = dropout(softmax(q k^T + bias - rowmax)) @ v``.

Dropout draws its keep mask inside the kernels from Philox4x32-10 on (seed,
bg, row, col) (``philox.py``); the forward, the backward and the plain
versions (through ``philox_keep_mask``) draw the same mask, and no mask
reaches device memory.  The plain versions also take an explicit {0, 1}
``keep`` tensor, which is how the tests hand them the mask of the JAX kernel's
``mask`` operand.

What bounds both on the H100: bytes.  Forward: about 4*dh + 7 = 263 FLOP per
(query, key) pair against 2 bytes of bf16 bias, about 130 FLOP per byte,
under the card's ridge of about 295; at the 2500-patch shape (BG=64, N=2500,
J=144, dh=64, bf16) one branch moves about 89 MB: 27 us at 3.35 TB/s.
Backward: about 10*dh FLOP per pair against the bias and dbias streams (4
bytes per pair) and q, dout, dq, dk, dv once: about 155 MB per branch.

What the designs do about it: every input byte is read once and the
(BG, N, J) chain never leaves the SM in either direction.  The forward runs
one block per (bg, 64 query rows), K and V in shared memory, one warp per
row; the backward splits into a rows kernel (dq, dbias and the row's
log-sum-exp) and a keys kernel that sums dk and dv over all rows inside one
block, so it needs no atomics and no partial sums (see the source note).  The
ragged last row tile (2500 = 39*64 + 4) is masked in the kernels.  All
products run on the CUDA cores; tensor-core products are later work.

On CPU tensors the wrappers take the plain versions; on CUDA tensors they
launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sml_tpu_torch.ops.kernels import _build
from sml_tpu_torch.ops.kernels.philox import philox_keep_mask

KERNEL_DH = 64
_WARPS = 8                   # kThreads / 32 in csrc/deform_attn*.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "deform_attn":
            lib.deform_attn_fwd.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p])
            lib.deform_attn_fwd.restype = ctypes.c_int
        else:
            lib.deform_attn_bwd.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p])
            lib.deform_attn_bwd.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def smem_bytes(j: int, dtype: torch.dtype, backward: bool = False) -> int:
    """Dynamic shared memory of one forward (or backward rows) block: padded K
    and V rows + one (two for the backward) per-warp f32 rows of J."""
    size = torch.finfo(dtype).bits // 8
    row = KERNEL_DH + 16 // size
    return 2 * j * row * size + (2 if backward else 1) * _WARPS * j * 4


def _check(q, k, v, bias):
    """Validate shapes / dtypes / devices; returns (bg, n, j, dh)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 3:
        raise ValueError("q (BG, N, dh), k / v (BG, J, dh), bias (BG, N, J) expected")
    bg, n, dh = q.shape
    j = k.shape[1]
    if tuple(k.shape) != (bg, j, dh) or tuple(v.shape) != (bg, j, dh):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if tuple(bias.shape) != (bg, n, j):
        raise ValueError(f"bias {tuple(bias.shape)} != {(bg, n, j)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share float32 or bfloat16")
    if bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"bias dtype {bias.dtype} is not float32 or bfloat16")
    for t in (k, v, bias):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    for t in (q, k, v, bias):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return bg, n, j, dh


def _check_dropout(keep_prob: float, seed: int) -> None:
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob {keep_prob} is not in (0, 1]")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")


def _check_kernel(name, q, j, backward=False):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.shape[-1] != KERNEL_DH:
        raise ValueError(f"{name} kernel takes dh={KERNEL_DH}, not {q.shape[-1]}")
    if smem_bytes(j, q.dtype, backward) > _build.SMEM_LIMIT:
        raise ValueError(f"J={j} does not fit the {name} kernel's shared memory")


def _keep_mask(keep_prob, seed, bg, n, j, device):
    if keep_prob >= 1.0:
        return None
    return philox_keep_mask(seed, bg, n, j, keep_prob, device=device)


def _probs(q, k, bias):
    """(BG, N, J) softmax(q k^T + bias) in f32, max-shifted."""
    sim = torch.einsum("bnd,bjd->bnj", q.float(), k.float()) + bias.float()
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    return p / p.sum(dim=-1, keepdim=True)


def _multiplier(keep, keep_prob):
    """{0, 1/keep_prob} dropout multiplier from a {0, 1} keep tensor, or None."""
    if keep is None:
        return None
    return keep.float() * (1.0 / keep_prob)


def deform_attention_fwd_plain(q, k, v, bias, keep=None, keep_prob=1.0):
    """(BG, N, dh) in q's dtype; the chain in f32.  ``keep`` (BG, N, J) is an
    explicit {0, 1} mask of kept probabilities (None: no dropout)."""
    p = _probs(q, k, bias)
    mult = _multiplier(keep, keep_prob)
    if mult is not None:
        p = p * mult
    return torch.einsum("bnj,bjd->bnd", p, v.float()).to(q.dtype)


def deform_attention_fwd(q, k, v, bias, keep_prob=1.0, seed=0):
    """out (BG, N, dh) = dropout(softmax(q k^T + bias)) @ v, in q's dtype.

    q (BG, N, dh) already scaled; k, v (BG, J, dh) in q's dtype (float32 or
    bfloat16); bias (BG, N, J) float32 or bfloat16, upcast to f32.  With
    ``keep_prob < 1`` each probability is kept with that probability (by
    Philox on ``seed``) and scaled by 1/keep_prob.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    bg, n, j, dh = _check(q, k, v, bias)
    _check_dropout(keep_prob, seed)
    if q.device.type == "cpu":
        return deform_attention_fwd_plain(
            q, k, v, bias, _keep_mask(keep_prob, seed, bg, n, j, q.device), keep_prob)
    _check_kernel("deform_attention_fwd", q, j)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _library("deform_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deform_attn_fwd(_DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype],
                                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), bg, n, j, dh,
                                 keep_prob, 1.0 / keep_prob, seed, q.device.index,
                                 stream)
    _build.check(rc, "deform_attention_fwd")
    deform_attention_fwd.launches += 1
    if keep_prob < 1.0:
        deform_attention_fwd.dropout_launches += 1
    return out


deform_attention_fwd.launches = 0
deform_attention_fwd.dropout_launches = 0


def deform_attention_bwd_plain(q, k, v, bias, dout, keep=None, keep_prob=1.0):
    """(dq, dk, dv, dbias) of :func:`deform_attention_fwd_plain`, the chain in
    f32, rounded where ``_attn_bwd_kernel`` rounds: ds to q's dtype before dq
    and dk, the kept probabilities to v's dtype before dv.  dq, dk, dv come in
    their inputs' dtypes, dbias in the bias's."""
    p = _probs(q, k, bias)
    mult = _multiplier(keep, keep_prob)
    pd = p if mult is None else p * mult
    dof = dout.float()
    dv = torch.einsum("bnj,bnd->bjd", pd.to(v.dtype).float(), dof)
    dp = torch.einsum("bnd,bjd->bnj", dof, v.float())
    if mult is not None:
        dp = dp * mult
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_c = ds.to(q.dtype).float()
    dq = torch.einsum("bnj,bjd->bnd", ds_c, k.float())
    dk = torch.einsum("bnj,bnd->bjd", ds_c, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.to(bias.dtype)


def deform_attention_bwd(q, k, v, bias, dout, keep_prob=1.0, seed=0):
    """(dq, dk, dv, dbias) of :func:`deform_attention_fwd` at the same
    ``keep_prob`` and ``seed``, recomputed from q, k, v and bias.  CPU tensors
    take the plain version; CUDA tensors launch the two backward kernels (one
    launch of the wrapper), which need the bias in q's dtype."""
    bg, n, j, dh = _check(q, k, v, bias)
    _check_dropout(keep_prob, seed)
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    if dout.device != q.device or not dout.is_contiguous():
        raise ValueError("dout must be contiguous on q's device")
    if q.device.type == "cpu":
        return deform_attention_bwd_plain(
            q, k, v, bias, dout, _keep_mask(keep_prob, seed, bg, n, j, q.device),
            keep_prob)
    _check_kernel("deform_attention_bwd", q, j, backward=True)
    if bias.dtype != q.dtype:
        raise TypeError("the backward kernel takes the bias in q's dtype")
    for t in (q, k, v, dout):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v, dout must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    lse = torch.empty((bg, n), dtype=torch.float32, device=q.device)
    lib = _library("deform_attn_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deform_attn_bwd(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 dbias.data_ptr(), lse.data_ptr(), bg, n, j, dh,
                                 keep_prob, 1.0 / keep_prob, seed, q.device.index,
                                 stream)
    _build.check(rc, "deform_attention_bwd")
    deform_attention_bwd.launches += 1
    return dq, dk, dv, dbias


deform_attention_bwd.launches = 0


class DeformAttentionTrainable(torch.autograd.Function):
    """Forward kernel + recompute backward kernel; saves q, k, v, bias and the
    seed (never a mask or a (BG, N, J) activation)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, keep_prob, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.keep_prob, ctx.seed = keep_prob, seed
        return deform_attention_fwd(q, k, v, bias, keep_prob, seed)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = deform_attention_bwd(q, k, v, bias,
                                                 dout.to(q.dtype).contiguous(),
                                                 ctx.keep_prob, ctx.seed)
        return dq, dk, dv, dbias, None, None


def deform_attention_trainable(q, k, v, bias, keep_prob=1.0, seed=0):
    """Differentiable :func:`deform_attention_fwd` (the counterpart of the
    custom VJP ``deform_attention_trainable``)."""
    return DeformAttentionTrainable.apply(q, k, v, bias, keep_prob, seed)
