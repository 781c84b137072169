"""Kernel B: the deformable-attention forward, eval form (``csrc/deform_attn.cu``,
CUDA C++ for sm_90a).

Replaces the Pallas kernel ``_fused_attn_fwd_call``
(``sml_tpu/ops/pallas/deform_attn.py:1016``, body ``_attn_fwd_kernel`` at
``:894``, reached through ``deform_attention_trainable``) with no dropout, no
span mask and a bias: ``out = softmax(q k^T + bias - rowmax) @ v``.

What bounds it on the H100: bytes.  About 4*dh + 7 = 263 FLOP per
(query, key) pair against the bias's 2 bytes (bf16) for that pair: about 130
FLOP per byte, under the card's ridge of about 295.  At the 2500-patch shape
(BG=64, N=2500, J=144, dh=64, bf16) one branch moves about 89 MB (bias 46 MB,
q 20.5 MB, out 20.5 MB, k and v 2.4 MB): 27 us at 3.35 TB/s.

What the design does about it: every input byte is read from device memory
once and the (BG, N, J) probabilities never leave the SM.  One block per
(bg, 64 query rows) holds K and V in shared memory; each warp owns rows, reads
the bias row coalesced, keeps sim / exp in a per-warp f32 row buffer and writes
only the (N, dh) output.  The ragged last row tile (2500 = 39*64 + 4) is masked
in the kernel, so nothing is padded or copied.  The q k^T and p V products run
on the CUDA cores from shared memory, which is what this first kernel spends
its time on; tensor-core products are later work.

``deform_attention_fwd_plain`` is the same function in plain PyTorch.
``deform_attention_fwd`` takes it only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sml_tpu_torch.ops.kernels import _build

KERNEL_DH = 64
SMEM_LIMIT = 232448          # bytes of shared memory one block may use on sm_90
_WARPS = 8                   # kThreads / 32 in csrc/deform_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("deform_attn")
        lib.deform_attn_fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.deform_attn_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(j: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: padded K and V rows + per-warp p rows."""
    size = torch.finfo(dtype).bits // 8
    row = KERNEL_DH + 16 // size
    return 2 * j * row * size + _WARPS * j * 4


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


def deform_attention_fwd_plain(q, k, v, bias):
    """(BG, N, dh) in q's dtype; the chain in f32."""
    sim = torch.einsum("bnd,bjd->bnj", q.float(), k.float()) + bias.float()
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bnj,bjd->bnd", p, v.float()).to(q.dtype)


def deform_attention_fwd(q, k, v, bias):
    """out (BG, N, dh) = softmax(q k^T + bias) @ v, in q's dtype.

    q (BG, N, dh) already scaled; k, v (BG, J, dh) in q's dtype (float32 or
    bfloat16); bias (BG, N, J) float32 or bfloat16, upcast to f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    bg, n, j, dh = _check(q, k, v, bias)
    if q.device.type == "cpu":
        return deform_attention_fwd_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"deform_attention_fwd runs on cpu or cuda, not {q.device}")
    if dh != KERNEL_DH:
        raise ValueError(f"deform_attention_fwd kernel takes dh={KERNEL_DH}, not {dh}")
    if smem_bytes(j, q.dtype) > SMEM_LIMIT:
        raise ValueError(f"J={j} does not fit the kernel's shared memory")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deform_attn_fwd(_DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype],
                                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), bg, n, j, dh,
                                 q.device.index, stream)
    _build.check(rc, "deform_attention_fwd")
    deform_attention_fwd.launches += 1
    return out


deform_attention_fwd.launches = 0
