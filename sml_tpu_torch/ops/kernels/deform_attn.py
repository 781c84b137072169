"""Kernels B and D: the attention forward (``csrc/deform_attn.cu``) and its
recompute backward (``csrc/deform_attn_bwd.cu``), CUDA C++ for sm_90a, and the
``torch.autograd.Function`` around them.

Replaces the Pallas kernels ``_fused_attn_fwd_call``
(``sml_tpu/ops/pallas/deform_attn.py:1016``, body ``_attn_fwd_kernel`` at
``:894``, dropout ``_dropout_mult`` at ``:877``) and ``_fused_attn_bwd_call``
(``:1044``, body ``_attn_bwd_kernel`` at ``:918``), reached through the custom
VJP ``deform_attention_trainable`` (``:1099``), in every compiled form:
``out = dropout(softmax(mask(q k^T + bias))) @ v`` with or without the bias
(the deformable attention has one; the Nystrom chains have none), with or
without the span mask, with or without dropout.  The bias comes in q's dtype,
or in f32 beside bf16 q, k, v: the 1-D deformable attention's, from its f32
``CPB1D`` (``sml_tpu/ops/deformable.py:687-691`` hands Pallas the same), in the
form without span and dropout that its path runs; dbias then comes in f32.
The head dim is 64, or 32 in f32 without a bias, span or dropout: CMTA's
Nystrom chains (8 heads of 32, 128 landmarks), which the JAX gate sends to
Pallas in f32 only (``sml_tpu/ops/nystrom.py:174-183``); in bf16 (64 bytes a
row) it never does, and the kernels refuse it.

``span`` (BG, 4) int32 holds per-bag ``[row_start, row_end, col_start,
col_end)`` over the unpadded rows and columns (``_span_valid`` ``:843``):
invalid columns take -f32max before the max, so their probability is exactly
0; an invalid row is uniform over all J columns; the cotangent is zeroed at
every masked pair, whole invalid rows included (``:856-874``, ``:958-963``).

Dropout draws its keep mask inside the kernels from Philox4x32-10 on (seed,
bg, row, col) (``philox.py``); the forward, the backward and the plain
versions (through ``philox_keep_mask``) draw the same mask, and no mask
reaches device memory.  The plain versions also take an explicit {0, 1}
``keep`` tensor, which is how the tests hand them the mask of the JAX kernel's
``mask`` operand.

What bounds both on the H100: at the deformable attention's bias form (BG=64,
N=2500, J=144, dh=64, bf16) bytes, the bias stream (the forward moves about
89 MB: 27 us at 3.35 TB/s); at the Nystrom chains (no bias, J or N of 2560 or
4352, or CMTA's 128 landmarks against 2560) operations, about 4*dh FLOP per
pair forward and 10*dh backward against q, k, v and out read or written once.

What the designs do about it: every input byte is read once and the
(BG, N, J) chain never leaves the SM in either direction.  K and V stream
through shared memory in key tiles, so J has no limit.  The forward runs one
block per (bg, 64 query rows) and walks the key tiles twice: each row's
log-sum-exp, then p = exp(s - lse) * m rounded to bf16 and out += p v; the
backward splits into a rows kernel (two passes over the key tiles: each row's
log-sum-exp and delta = sum_j p dp, then ds = p (dp - delta) for each pair,
dq and dbias) and a keys kernel that recomputes ds from them and sums dk and
dv over the rows, so it needs no atomics and no (BG, N, J) scratch (see the
source notes).  Ragged row and key tiles are masked in the kernels.  In bf16
every product of both runs on the tensor cores (warp-level ``mma.sync``,
``csrc/mma.cuh``), and the forward's first pass is the backward rows kernel's
own code (``csrc/attn_tc.cuh``), meant to give the same log-sum-exp (not
checked bit for bit on the card: the forward returns no lse).  Every f32
form, forward and backward, at both head dims (at dh = 64 in every form: the
default compute dtype's) runs on the tf32 tensor cores, each f32 product as
three tf32 products (3xTF32: operands split into hi + lo), the tensor-core
sums folded into f32 registers every tile (or, at dh = 64, every 32 keys or
16 rows), with one statistics walk for the forward and the backward's rows
kernel (``csrc/attn_tf32.cuh``), so the forward's log-sum-exp, which it
leaves in its scratch, is the backward's bit for bit; where one side is thin
(the Nystrom chains' landmarks, the deformable attention's keys) the long
axis is cut into segments whose partial sums go to an f32 scratch that this
wrapper allocates (``deform_attn_fwd_work`` / ``deform_attn_bwd_work`` give
its size) and are added in segment order, so the result still repeats bit
for bit.

On CPU tensors the wrappers take the plain versions; on CUDA tensors they
launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sml_tpu_torch.ops.kernels import _build
from sml_tpu_torch.ops.kernels.philox import philox_keep_mask

KERNEL_DH = 64
DH32 = 32            # the f32 form without bias, span or dropout (CMTA's chains)
NEG_MAX = -3.4028234663852886e38     # -finfo(f32).max, the masked-column fill
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "deform_attn":
            lib.deform_attn_fwd.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p])
            lib.deform_attn_fwd.restype = ctypes.c_int
            lib.deform_attn_fwd_work.argtypes = [ctypes.c_int] * 5
            lib.deform_attn_fwd_work.restype = ctypes.c_longlong
        else:
            lib.deform_attn_bwd.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p])
            lib.deform_attn_bwd.restype = ctypes.c_int
            lib.deform_attn_bwd_work.argtypes = [ctypes.c_int] * 5
            lib.deform_attn_bwd_work.restype = ctypes.c_longlong
        _libs[name] = lib
    return lib


def _check(q, k, v, bias, span):
    """Validate shapes / dtypes / devices; returns (bg, n, j, dh)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q (BG, N, dh), k / v (BG, J, dh) expected")
    bg, n, dh = q.shape
    j = k.shape[1]
    if tuple(k.shape) != (bg, j, dh) or tuple(v.shape) != (bg, j, dh):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share float32 or bfloat16")
    tensors = [q, k, v]
    if bias is not None:
        if tuple(bias.shape) != (bg, n, j):
            raise ValueError(f"bias {tuple(bias.shape)} != {(bg, n, j)}")
        if bias.dtype not in _DTYPE_CODE:
            raise TypeError(f"bias dtype {bias.dtype} is not float32 or bfloat16")
        tensors.append(bias)
    if span is not None:
        if tuple(span.shape) != (bg, 4) or span.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"span must be (BG, 4) int32, not {tuple(span.shape)} "
                             f"{span.dtype}")
        tensors.append(span)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return bg, n, j, dh


def _check_dropout(keep_prob: float, seed: int) -> None:
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob {keep_prob} is not in (0, 1]")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")


def _f32_bias(q, bias) -> bool:
    """Whether this is the form with an f32 bias beside bf16 q, k, v."""
    return bias is not None and bias.dtype == torch.float32 and q.dtype == torch.bfloat16


def _bias_code(q, bias) -> int:
    """The bias's dtype code for the C entries (q's without a bias)."""
    return _DTYPE_CODE[(q if bias is None else bias).dtype]


def _check_kernel(name, q, bias, span, keep_prob, tensors):
    if bias is not None and bias.dtype != q.dtype and not (
            _f32_bias(q, bias) and span is None and keep_prob >= 1.0):
        raise TypeError(f"the {name} kernel takes the bias in q's dtype, or in f32 beside "
                        "bf16 q without span and dropout")
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    dh = q.shape[-1]
    if dh == DH32:
        if q.dtype != torch.float32 or bias is not None or span is not None or \
                keep_prob < 1.0:
            raise ValueError(f"{name} kernel takes dh={DH32} only for float32 q, k, v "
                             "without bias, span or dropout")
    elif dh != KERNEL_DH:
        raise ValueError(f"{name} kernel takes dh={KERNEL_DH} (or {DH32} in float32), "
                         f"not {dh}")
    if span is not None and span.dtype != torch.int32:
        raise TypeError(f"the {name} kernel takes the span in int32")
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _keep_mask(keep_prob, seed, bg, n, j, device):
    if keep_prob >= 1.0:
        return None
    return philox_keep_mask(seed, bg, n, j, keep_prob, device=device)


def _span_valid(span, n, j):
    """(row_valid (BG, N, 1), col_valid (BG, 1, J)) bools of ``span``."""
    rows = torch.arange(n, device=span.device)[None, :]
    cols = torch.arange(j, device=span.device)[None, :]
    rv = (rows >= span[:, 0:1]) & (rows < span[:, 1:2])
    cv = (cols >= span[:, 2:3]) & (cols < span[:, 3:4])
    return rv[:, :, None], cv[:, None, :]


def _probs(q, k, bias, span):
    """(BG, N, J) softmax(mask(q k^T + bias)) in f32, max-shifted; with a span,
    invalid columns take -f32max and invalid rows 0 before the shift."""
    sim = torch.einsum("bnd,bjd->bnj", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()
    if span is not None:
        rv, cv = _span_valid(span, q.shape[1], k.shape[1])
        sim = torch.where(cv, sim, NEG_MAX)
        sim = torch.where(rv, sim, 0.0)
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    return p / p.sum(dim=-1, keepdim=True)


def _multiplier(keep, keep_prob):
    """{0, 1/keep_prob} dropout multiplier from a {0, 1} keep tensor, or None."""
    if keep is None:
        return None
    return keep.float() * (1.0 / keep_prob)


def deform_attention_fwd_plain(q, k, v, bias=None, keep=None, keep_prob=1.0, span=None):
    """(BG, N, dh) in q's dtype; the chain in f32, the kept probabilities
    rounded to v's dtype before the product with v, where ``_attn_fwd_kernel``
    rounds them.  ``keep`` (BG, N, J) is an explicit {0, 1} mask of kept
    probabilities (None: no dropout)."""
    p = _probs(q, k, bias, span)
    mult = _multiplier(keep, keep_prob)
    if mult is not None:
        p = p * mult
    return torch.einsum("bnj,bjd->bnd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def _count(fn, q, bias, span, keep_prob) -> None:
    fn.launches += 1
    if bias is None:
        fn.nobias_launches += 1
    if _f32_bias(q, bias):
        fn.f32bias_launches += 1
    if span is not None:
        fn.span_launches += 1
    if keep_prob < 1.0:
        fn.dropout_launches += 1
    if q.shape[-1] == DH32:
        fn.dh32_launches += 1
    elif q.dtype == torch.float32:
        fn.f32_launches += 1


def deform_attention_fwd(q, k, v, bias=None, keep_prob=1.0, seed=0, span=None):
    """out (BG, N, dh) = dropout(softmax(mask(q k^T + bias))) @ v, in q's dtype.

    q (BG, N, dh) already scaled; k, v (BG, J, dh) in q's dtype (float32 or
    bfloat16); bias (BG, N, J) float32 or bfloat16 (upcast to f32) or None;
    span (BG, 4) int32 per-bag validity intervals or None.  With
    ``keep_prob < 1`` each probability is kept with that probability (by
    Philox on ``seed``) and scaled by 1/keep_prob.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, which takes the bias in q's dtype,
    or in f32 beside bf16 q without span and dropout.
    """
    bg, n, j, dh = _check(q, k, v, bias, span)
    _check_dropout(keep_prob, seed)
    if q.device.type == "cpu":
        return deform_attention_fwd_plain(
            q, k, v, bias, _keep_mask(keep_prob, seed, bg, n, j, q.device), keep_prob,
            span)
    _check_kernel("deform_attention_fwd", q, bias, span, keep_prob, (q, k, v, bias, span))
    out = torch.empty_like(q)
    lib = _library("deform_attn")
    # the f32 kernels' lse and their partial sums over segments of the keys
    n_work = lib.deform_attn_fwd_work(_DTYPE_CODE[q.dtype], bg, n, j, dh)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device) if n_work else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deform_attn_fwd(_DTYPE_CODE[q.dtype], _bias_code(q, bias), q.data_ptr(),
                                 k.data_ptr(), v.data_ptr(), ptr(bias), ptr(span),
                                 out.data_ptr(), ptr(work),
                                 bg, n, j, dh, keep_prob, 1.0 / keep_prob, seed,
                                 q.device.index, stream)
    _build.check(rc, "deform_attention_fwd")
    _count(deform_attention_fwd, q, bias, span, keep_prob)
    return out


def deform_attention_bwd_plain(q, k, v, bias, dout, keep=None, keep_prob=1.0, span=None):
    """(dq, dk, dv, dbias) of :func:`deform_attention_fwd_plain`, the chain in
    f32, rounded where ``_attn_bwd_kernel`` rounds: ds to q's dtype before dq
    and dk, the kept probabilities to v's dtype before dv.  With a span, ds is
    zeroed at every masked pair.  dq, dk, dv come in their inputs' dtypes,
    dbias in the bias's (None without a bias)."""
    p = _probs(q, k, bias, span)
    mult = _multiplier(keep, keep_prob)
    pd = p if mult is None else p * mult
    dof = dout.float()
    dv = torch.einsum("bnj,bnd->bjd", pd.to(v.dtype).float(), dof)
    dp = torch.einsum("bnd,bjd->bnj", dof, v.float())
    if mult is not None:
        dp = dp * mult
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if span is not None:
        rv, cv = _span_valid(span, q.shape[1], k.shape[1])
        ds = torch.where(rv & cv, ds, 0.0)
    ds_c = ds.to(q.dtype).float()
    dq = torch.einsum("bnj,bjd->bnd", ds_c, k.float())
    dk = torch.einsum("bnj,bnd->bjd", ds_c, q.float())
    dbias = None if bias is None else ds.to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def deform_attention_bwd(q, k, v, bias, dout, keep_prob=1.0, seed=0, span=None):
    """(dq, dk, dv, dbias) of :func:`deform_attention_fwd` at the same
    ``keep_prob``, ``seed`` and ``span``, recomputed from q, k, v and bias
    (dbias is None without a bias).  CPU tensors take the plain version; CUDA
    tensors launch the two backward kernels (one launch of the wrapper)."""
    bg, n, j, dh = _check(q, k, v, bias, span)
    _check_dropout(keep_prob, seed)
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    if dout.device != q.device or not dout.is_contiguous():
        raise ValueError("dout must be contiguous on q's device")
    if q.device.type == "cpu":
        return deform_attention_bwd_plain(
            q, k, v, bias, dout, _keep_mask(keep_prob, seed, bg, n, j, q.device),
            keep_prob, span)
    _check_kernel("deform_attention_bwd", q, bias, span, keep_prob,
                  (q, k, v, bias, span, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = None if bias is None else torch.empty_like(bias)
    stats = torch.empty((2, bg, n), dtype=torch.float32, device=q.device)  # lse, delta
    lib = _library("deform_attn_bwd")
    # the f32 kernels' partial sums over segments of a long axis
    n_work = lib.deform_attn_bwd_work(_DTYPE_CODE[q.dtype], bg, n, j, dh)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device) if n_work else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deform_attn_bwd(_DTYPE_CODE[q.dtype], _bias_code(q, bias), q.data_ptr(),
                                 k.data_ptr(), v.data_ptr(), ptr(bias), ptr(span),
                                 dout.data_ptr(),
                                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(dbias),
                                 stats[0].data_ptr(), stats[1].data_ptr(), ptr(work),
                                 bg, n, j, dh, keep_prob, 1.0 / keep_prob, seed,
                                 q.device.index, stream)
    _build.check(rc, "deform_attention_bwd")
    _count(deform_attention_bwd, q, bias, span, keep_prob)
    return dq, dk, dv, dbias


for _fn in (deform_attention_fwd, deform_attention_bwd):
    _fn.launches = _fn.nobias_launches = _fn.span_launches = _fn.dropout_launches = 0
    _fn.f32bias_launches = _fn.dh32_launches = _fn.f32_launches = 0


class DeformAttentionTrainable(torch.autograd.Function):
    """Forward kernel + recompute backward kernel; saves q, k, v, bias, the
    span and the seed (never a mask or a (BG, N, J) activation)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, keep_prob, seed, span):
        ctx.save_for_backward(q, k, v, bias, span)
        ctx.keep_prob, ctx.seed = keep_prob, seed
        return deform_attention_fwd(q, k, v, bias, keep_prob, seed, span)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, span = ctx.saved_tensors
        dq, dk, dv, dbias = deform_attention_bwd(q, k, v, bias,
                                                 dout.to(q.dtype).contiguous(),
                                                 ctx.keep_prob, ctx.seed, span)
        return dq, dk, dv, dbias, None, None, None


def deform_attention_trainable(q, k, v, bias=None, keep_prob=1.0, seed=0, span=None):
    """Differentiable :func:`deform_attention_fwd` (the counterpart of the
    custom VJP ``deform_attention_trainable``); ``span`` takes no gradient and
    the bias-less form returns no bias gradient."""
    return DeformAttentionTrainable.apply(q, k, v, bias, keep_prob, seed, span)
