"""The port's two kernels: plain PyTorch versions against the JAX package's Pallas
kernels in interpret mode (f32, rtol = atol = 1e-5), the wrappers' input checks,
and, on a machine with a CUDA card, each CUDA kernel against its plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import RAGGED, RAGGED_BIAS
from sml_tpu.ops.pallas.deform_attn import deform_attention_trainable, fused_cpb_bias
from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_plain, deform_attention_fwd,
                                       deform_attention_fwd_plain, philox_keep_mask)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cpb_inputs(seed, bg, h, w, j, dm):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return [f(bg, w * j, scale=0.7), f(bg, h, j, scale=0.7), f(dm, scale=0.5),
            f(dm, scale=0.5), f(dm, scale=0.1), f(dm, dm, scale=dm ** -0.5),
            f(dm, scale=0.1), f(dm, 1, scale=dm ** -0.5), f(1, scale=0.1)]


def _attn_inputs(seed, bg, n, j, dh=64):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return [f(bg, n, dh, scale=dh ** -0.5), f(bg, j, dh), f(bg, j, dh), f(bg, n, j)]


@pytest.mark.parametrize("bg,h,w,j,dm", [(3, 5, 7, 9, 8), (2, 8, 8, 16, 8),
                                         (2, 4, 6, 12, 16), (1, 3, 3, 4, 32)])
def test_plain_cpb_bias_matches_pallas_interpret(bg, h, w, j, dm):
    args = _cpb_inputs(bg * h + dm, bg, h, w, j, dm)
    want = np.asarray(fused_cpb_bias(*map(jnp.asarray, args), interpret=True))
    tensors = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(cpb_bias_plain(*tensors).numpy(), want, **TOL)
    before = cpb_bias.launches
    np.testing.assert_allclose(cpb_bias(*tensors).numpy(), want, **TOL)
    assert cpb_bias.launches == before          # CPU tensors never launch a kernel


@pytest.mark.parametrize("bg,n,j", [(3, 100, 16), (2, 64, 4), (2, 256, 24)])
def test_plain_deform_attention_matches_pallas_interpret(bg, n, j):
    """N=100 is ragged against every row tile the kernels use."""
    args = _attn_inputs(n + j, bg, n, j)
    want = np.asarray(deform_attention_trainable(*map(jnp.asarray, args),
                                                 interpret=True))
    tensors = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(deform_attention_fwd_plain(*tensors).numpy(), want, **TOL)
    before = deform_attention_fwd.launches
    np.testing.assert_allclose(deform_attention_fwd(*tensors).numpy(), want, **TOL)
    assert deform_attention_fwd.launches == before


def test_plain_deform_attention_takes_a_bf16_bias():
    q, k, v, bias = (torch.from_numpy(a) for a in _attn_inputs(5, 2, 36, 8))
    want = deform_attention_fwd_plain(q, k, v, bias.bfloat16().float())
    np.testing.assert_allclose(deform_attention_fwd(q, k, v, bias.bfloat16()).numpy(),
                               want.numpy(), **TOL)


@pytest.mark.parametrize("bad", ["dy_rows", "dtype", "weights", "contiguity"])
def test_cpb_bias_rejects_bad_inputs(bad):
    args = [torch.from_numpy(a) for a in _cpb_inputs(0, 2, 3, 4, 5, 8)]
    if bad == "dy_rows":
        args[1] = args[1][:1]
    elif bad == "dtype":
        args[0] = args[0].double()
    elif bad == "weights":
        args[5] = args[5].bfloat16()
    else:
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        cpb_bias(*args)


@pytest.mark.parametrize("bad", ["bias_shape", "kv_dtype", "contiguity"])
def test_deform_attention_rejects_bad_inputs(bad):
    q, k, v, bias = (torch.from_numpy(a) for a in _attn_inputs(0, 2, 16, 4))
    if bad == "bias_shape":
        bias = bias[:, :8]
    elif bad == "kv_dtype":
        k = k.bfloat16()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        deform_attention_fwd(q, k, v, bias)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bg,h,w,j,dm", [(4, 10, 10, 36, 32), (4, 10, 10, 36, 16),
                                         (4, 10, 10, 36, 8), (3, 6, 11, 37, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cpb_bias_matches_plain(dtype, bg, h, w, j, dm):
    """dm 32 / 16 / 8 (8 pads the tensor-core kernel's k16 step), and J = 37 with
    W*J = 407, not a multiple of its 16-pair step: a second launch must return
    the first one's bias bit for bit."""
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _cpb_inputs(1, bg, h, w, j, dm)]
    args[2:] = [a.to(dtype) for a in args[2:]]
    before = cpb_bias.launches
    got = cpb_bias(*args)
    torch.cuda.synchronize()
    assert cpb_bias.launches == before + 1
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), cpb_bias_plain(*args).float(), **tol)
    assert torch.equal(cpb_bias(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bg,n,j",
                         [(4, 100, 144)] + [(4, n, j) for n, j in RAGGED + RAGGED_BIAS]
                         + [(4, 256, 2560)])
@pytest.mark.parametrize("form", ["bias", "nobias", "span", "span_bias"])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_deform_attention_matches_plain(dtype, keep_prob, form, bg, n, j):
    """Every form (bias or none x span or none x dropout or none) at J = 144
    and chip_smoke.py's ragged shapes, J = 20 / 72 / 37 / 38 / 39 / 41 / 42 /
    43 (a partial 64-key tile; every residue of J mod 8, at which the staged
    bias tile's rows start at another 16-byte phase) with N = 100 and 65
    (partial row tiles, one row past a tile), and a thin row side, 256 rows
    against 2560 keys at BG 4, which the f32 kernel cuts into key segments
    (statistics, outputs per segment, their sum); the span batch has an
    interior interval, a whole bag, a bag with no valid row and one with no
    valid column.  A second launch must return the first one's output bit
    for bit."""
    dev = _cuda()
    q, k, v, bias = (torch.from_numpy(a).to(dev, dtype) for a in _attn_inputs(2, bg, n, j))
    bias = bias if form in ("bias", "span_bias") else None
    span = None
    if form.startswith("span"):
        span = torch.tensor([[7, n - 7, 3, j - 3], [0, n, 0, j], [n, n, 0, j], [0, n, j, j]],
                            dtype=torch.int32, device=dev)[:bg]
    keep = (philox_keep_mask(5, bg, n, j, keep_prob, device=dev) if keep_prob < 1.0
            else None)
    before = deform_attention_fwd.launches
    got = deform_attention_fwd(q, k, v, bias, keep_prob, 5, span)
    torch.cuda.synchronize()
    assert deform_attention_fwd.launches == before + 1
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2,
                                                                         atol=2e-2)
    torch.testing.assert_close(got.float(), deform_attention_fwd_plain(
        q, k, v, bias, keep, keep_prob, span).float(), **tol)
    assert torch.equal(deform_attention_fwd(q, k, v, bias, keep_prob, 5, span), got)
