"""Philox4x32-10 dropout masks, the plain version of ``csrc/philox.cuh``.

The keep decision of element (bg, row, col) of a (BG, N, J) attention
probability tensor is a pure function of (seed, bg, row, col): one
Philox4x32-10 call on the counter (col // 4, row, bg, 0) with the key (low
word, high word) of the 64-bit seed gives four 32-bit words; word col % 4 is
the element's bits, and it is kept when ``(bits & 0x7FFFFF) * 2**-23 <
keep_prob`` (the rule of the Pallas kernel's ``_dropout_mult``,
``sml_tpu/ops/pallas/deform_attn.py:877-891``).  No tile size enters, so the
CUDA forward and backward kernels and this version draw the same mask.

The TPU's PRNG bits cannot be reproduced; the JAX-parity tests hand one
numpy {0, 1} mask to the JAX kernel's ``mask`` operand and to the plain
attention versions instead.

int64 cannot hold a 32 x 32-bit product, so the Philox multiply builds its
high and low words from 16-bit halves.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors a < 2**32."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi                      # < 2**33
    low = (mid & 0xFFFF) * 65536 + a_lo * m_lo            # < 2**33
    high = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox4x32(seed: int, c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor):
    """The four words of Philox4x32-10 for counters (c0, c1, c2, 0), as int64
    tensors broadcast from the three counter tensors."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    x0, x1, x2 = torch.broadcast_tensors(c0.long(), c1.long(), c2.long())
    x3 = torch.zeros_like(x0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(x0, _M0)
        hi1, lo1 = _mulhilo(x2, _M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def philox_keep_mask(seed: int, bg: int, n: int, j: int, keep_prob: float,
                     device=None, row0: int = 0, bg0: int = 0) -> torch.Tensor:
    """(bg, n, j) bool keep mask of rows [row0, row0 + n) of groups
    [bg0, bg0 + bg); element (b, r, c) is the decision of (bg0 + b, row0 + r, c)."""
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    ar = lambda lo, size: torch.arange(lo, lo + size, device=device, dtype=torch.int64)
    words = philox4x32(seed, ar(0, -(-j // 4))[None, None, :],
                       ar(row0, n)[None, :, None], ar(bg0, bg)[:, None, None])
    bits = torch.stack(words, dim=-1).reshape(bg, n, -1)[..., :j]
    u = (bits & 0x7FFFFF).to(torch.float32) * 2.0 ** -23
    return u < torch.tensor(keep_prob, dtype=torch.float32, device=device)
