"""The port's backward kernels and in-kernel dropout: the plain PyTorch backward
versions against ``jax.vjp`` of the JAX package's custom VJPs with their Pallas
kernels in interpret mode, the two autograd Functions on CPU tensors, the
Philox keep mask, bf16 parity of the plain forwards with the Pallas kernels, and,
on a machine with a CUDA card, each backward kernel against its plain version.

Tolerances (f32): 1e-5 absolute + 1e-5 relative for outputs and input
gradients; 1e-5 absolute + 1e-4 relative for the weight gradients, whose sums
run over every pair in another order than the Pallas kernel's.  bf16: one
bf16 ulp of the output's scale (2**(floor(log2 max|out|) - 7)).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.ops.pallas.deform_attn import (cpb_bias_trainable as j_cpb_bias_trainable,
                                            deform_attention_trainable as j_attn_trainable,
                                            fused_cpb_bias)
from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                       cpb_bias_plain, cpb_bias_trainable,
                                       deform_attention_bwd, deform_attention_bwd_plain,
                                       deform_attention_fwd, deform_attention_fwd_plain,
                                       deform_attention_trainable, philox_keep_mask)

TOL = dict(rtol=1e-5, atol=1e-5)
WTOL = dict(rtol=1e-4, atol=1e-5)
CPB_GRADS = ("d_dx", "d_dy", "dw0x", "dw0y", "db0", "dw1", "db1", "dw2", "db2")


def _cpb_inputs(seed, bg, h, w, j, dm):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return [f(bg, w * j, scale=0.7), f(bg, h, j, scale=0.7), f(dm, scale=0.5),
            f(dm, scale=0.5), f(dm, scale=0.1), f(dm, dm, scale=dm ** -0.5),
            f(dm, scale=0.1), f(dm, 1, scale=dm ** -0.5), f(1, scale=0.1)]


def _attn_inputs(seed, bg, n, j, dh=64):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return [f(bg, n, dh, scale=dh ** -0.5), f(bg, j, dh), f(bg, j, dh), f(bg, n, j),
            f(bg, n, dh)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bg,h,w,j,dm", [(3, 5, 7, 9, 8), (2, 8, 8, 16, 8),
                                         (2, 4, 6, 12, 16), (1, 3, 3, 4, 32)])
def test_plain_cpb_bias_bwd_matches_pallas_interpret_vjp(bg, h, w, j, dm):
    args = _cpb_inputs(bg * h + dm + 1, bg, h, w, j, dm)
    dbias = np.random.default_rng(dm).normal(size=(bg, h, w * j)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_cpb_bias_trainable(*a, True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dbias))
    got = cpb_bias_bwd_plain(*_t(args[:8]), torch.from_numpy(dbias))
    for name, g, w_ in zip(CPB_GRADS, got, want):
        w_ = np.asarray(w_)
        assert tuple(g.shape) == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_, err_msg=name,
                                   **(TOL if name in ("d_dx", "d_dy") else WTOL))


@pytest.mark.parametrize("bg,n,j", [(3, 100, 16), (2, 64, 8)])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
def test_plain_deform_attention_bwd_matches_pallas_interpret_vjp(bg, n, j, keep_prob):
    """N=100 is ragged against every row tile; at keep 0.9 one shared numpy
    {0, 1} mask feeds the Pallas kernel's mask operand and the plain versions."""
    q, k, v, bias, dout = _attn_inputs(n + j, bg, n, j)
    mask = None
    if keep_prob < 1.0:
        mask = (np.random.default_rng(j).uniform(size=(bg, n, j)) < keep_prob
                ).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    fn = lambda q_, k_, v_, b_: j_attn_trainable(q_, k_, v_, b_, jm, None, None,
                                                 keep_prob, True)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(dout))
    keep = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv, tb, td = _t((q, k, v, bias, dout))
    np.testing.assert_allclose(deform_attention_fwd_plain(tq, tk, tv, tb, keep,
                                                          keep_prob).numpy(),
                               np.asarray(out), **TOL)
    got = deform_attention_bwd_plain(tq, tk, tv, tb, td, keep, keep_prob)
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **TOL)


def test_cpb_bias_trainable_on_cpu_is_the_plain_backward():
    args = _t(_cpb_inputs(3, 2, 4, 5, 8, 16))
    leaves = [a.clone().requires_grad_(True) for a in args]
    dbias = torch.randn(2, 4, 40, generator=torch.Generator().manual_seed(1))
    before = (cpb_bias.launches, cpb_bias_bwd.launches)
    out = cpb_bias_trainable(*leaves)
    torch.testing.assert_close(out, cpb_bias_plain(*args), rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, dbias)
    want = cpb_bias_bwd_plain(*args[:8], dbias)
    for name, g, w_ in zip(CPB_GRADS, got, want):
        torch.testing.assert_close(g, w_.reshape(g.shape), rtol=0, atol=0, msg=name)
    assert (cpb_bias.launches, cpb_bias_bwd.launches) == before


@pytest.mark.parametrize("keep_prob", [1.0, 0.8])
def test_deform_attention_trainable_on_cpu_is_the_plain_backward(keep_prob):
    q, k, v, bias, dout = _t(_attn_inputs(4, 2, 36, 12))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    seed = 2 ** 40 + 12345
    before = (deform_attention_fwd.launches, deform_attention_bwd.launches)
    out = deform_attention_trainable(*leaves, keep_prob=keep_prob, seed=seed)
    keep = None if keep_prob == 1.0 else philox_keep_mask(seed, 2, 36, 12, keep_prob)
    torch.testing.assert_close(out, deform_attention_fwd_plain(q, k, v, bias, keep,
                                                               keep_prob), rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, dout)
    want = deform_attention_bwd_plain(q, k, v, bias, dout, keep, keep_prob)
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0, msg=name)
    assert (deform_attention_fwd.launches, deform_attention_bwd.launches) == before


def test_philox_matches_the_known_answer_and_is_deterministic():
    from sml_tpu_torch.ops.kernels.philox import philox4x32

    zero = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in philox4x32(0, zero, zero, zero)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]   # Random123 KAT
    a = philox_keep_mask(7, 3, 20, 30, 0.9)
    assert torch.equal(a, philox_keep_mask(7, 3, 20, 30, 0.9))
    assert not torch.equal(a, philox_keep_mask(8, 3, 20, 30, 0.9))
    with pytest.raises(ValueError):
        philox_keep_mask(2 ** 64, 1, 1, 1, 0.5)


def test_philox_mask_does_not_depend_on_how_the_range_is_split():
    whole = philox_keep_mask(99, 4, 50, 37, 0.7)
    rows = torch.cat([philox_keep_mask(99, 4, 13, 37, 0.7, row0=r)[:, :min(13, 50 - r)]
                      for r in range(0, 50, 13)], dim=1)
    groups = torch.cat([philox_keep_mask(99, 1, 50, 37, 0.7, bg0=b) for b in range(4)])
    cols = philox_keep_mask(99, 4, 50, 40, 0.7)[..., :37]          # a wider row
    for part in (rows, groups, cols):
        assert torch.equal(part, whole)


def test_philox_kept_share_is_keep_prob():
    keep_prob = 0.9
    mask = philox_keep_mask(2024, 8, 500, 256, keep_prob)
    n = mask.numel()
    assert n >= 10 ** 6
    sigma = math.sqrt(keep_prob * (1 - keep_prob) / n)
    assert abs(mask.float().mean().item() - keep_prob) < 5 * sigma


def _bf16_ulp_of_scale(x: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(x).max())) - 7)


def test_plain_cpb_bias_bf16_within_one_ulp_of_pallas_interpret():
    """The Pallas kernel rounds dx/dy and the layer-1 activations to bf16; the
    port computes the per-pair MLP in f32 and rounds only the output."""
    args = _cpb_inputs(21, 2, 8, 8, 16, 32)
    jargs = [jnp.asarray(a) for a in args[:2]] + [jnp.asarray(a, jnp.bfloat16)
                                                  for a in args[2:]]
    want = np.asarray(fused_cpb_bias(*jargs, interpret=True).astype(jnp.float32))
    targs = _t(args[:2]) + [torch.from_numpy(a).bfloat16() for a in args[2:]]
    got = cpb_bias_plain(*targs).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp_of_scale(want))


def test_plain_deform_attention_bf16_within_one_ulp_of_pallas_interpret():
    """The Pallas kernel rounds p to v's dtype before p @ v; the port keeps p
    in f32 and rounds only the output (see ROADMAP 'Faults')."""
    q, k, v, bias, _ = _attn_inputs(22, 2, 100, 16)
    want = np.asarray(j_attn_trainable(*(jnp.asarray(a, jnp.bfloat16)
                                         for a in (q, k, v, bias)),
                                       interpret=True).astype(jnp.float32))
    got = deform_attention_fwd_plain(*(t.bfloat16() for t in _t((q, k, v, bias)))
                                     ).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp_of_scale(want))


@pytest.mark.parametrize("bad", ["dbias_shape", "dbias_dtype"])
def test_cpb_bias_bwd_rejects_bad_dbias(bad):
    args = _t(_cpb_inputs(0, 2, 3, 4, 5, 8))
    dbias = torch.zeros(2, 3, 20)
    dbias = dbias[:, :2] if bad == "dbias_shape" else dbias.double()
    with pytest.raises((ValueError, TypeError)):
        cpb_bias_bwd(*args[:8], dbias)


@pytest.mark.parametrize("bad", ["dout_shape", "dout_dtype", "keep_prob", "seed"])
def test_deform_attention_bwd_rejects_bad_inputs(bad):
    q, k, v, bias, dout = _t(_attn_inputs(0, 2, 16, 4))
    kw = {}
    if bad == "dout_shape":
        dout = dout[:, :8]
    elif bad == "dout_dtype":
        dout = dout.double()
    elif bad == "keep_prob":
        kw["keep_prob"] = 0.0
    else:
        kw["seed"] = -1
    with pytest.raises((ValueError, TypeError)):
        deform_attention_bwd(q, k, v, bias, dout, **kw)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cpb_bias_bwd_matches_plain(dtype):
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _cpb_inputs(1, 4, 10, 10, 36, 32)]
    args[2:] = [a.to(dtype) for a in args[2:]]
    dbias = torch.randn(4, 10, 360, device=dev).to(dtype)
    before = cpb_bias_bwd.launches
    got = cpb_bias_bwd(*args[:8], dbias)
    torch.cuda.synchronize()
    assert cpb_bias_bwd.launches == before + 1
    # relative L2: the kernel's fused multiply-adds and the plain version's separate
    # operations can take different ReLU-derivative decisions at a ~ 0 (chip_smoke.py)
    for name, g, w_ in zip(CPB_GRADS, got, cpb_bias_bwd_plain(*args[:8], dbias)):
        g, w_ = g.float(), w_.float()
        assert ((g - w_).norm() / w_.norm()).item() <= 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
def test_cuda_deform_attention_bwd_matches_plain(dtype, keep_prob):
    dev = _cuda()
    q, k, v, bias, dout = (torch.from_numpy(a).to(dev, dtype)
                           for a in _attn_inputs(2, 4, 100, 144))
    keep = None if keep_prob == 1.0 else philox_keep_mask(5, 4, 100, 144, keep_prob,
                                                          device=dev)
    got = deform_attention_bwd(q, k, v, bias, dout, keep_prob, 5)
    torch.cuda.synchronize()
    want = deform_attention_bwd_plain(q, k, v, bias, dout, keep, keep_prob)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2,
                                                                         atol=2e-2)
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(g.float(), w_.float(), msg=name, **tol)
