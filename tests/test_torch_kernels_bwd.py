"""The port's backward kernels and in-kernel dropout: the plain PyTorch backward
versions against ``jax.vjp`` of the JAX package's custom VJPs with their Pallas
kernels in interpret mode, the two autograd Functions on CPU tensors, the
Philox keep mask, bf16 parity of the plain forwards with the Pallas kernels, and,
on a machine with a CUDA card, each backward kernel against its plain version.

Tolerances (f32): 1e-5 absolute + 1e-5 relative for outputs and input
gradients; 1e-5 absolute + 1e-4 relative for the weight gradients, whose sums
run over every pair in another order than the Pallas kernel's.  bf16: one
bf16 ulp of the output's scale (2**(floor(log2 max|out|) - 7)) for the plain
forwards; for the plain attention backward, see ``_bf16_rounding_bound``; for
the plain CPB backward, ``test_plain_cpb_bias_bwd_bf16_matches_pallas_interpret_vjp``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (MASK_DX, MASK_DY, RAGGED, RAGGED_BIAS, cpb_mask_counts,
                         cpb_mask_inputs)
from sml_tpu.ops.pallas.deform_attn import (cpb_bias_trainable as j_cpb_bias_trainable,
                                            deform_attention_trainable as j_attn_trainable,
                                            fused_cpb_bias)
from sml_tpu_torch.ops.kernels import (cpb_bias, cpb_bias_bwd, cpb_bias_bwd_plain,
                                       cpb_bias_plain, cpb_bias_trainable,
                                       deform_attention_bwd, deform_attention_bwd_plain,
                                       deform_attention_fwd, deform_attention_fwd_plain,
                                       deform_attention_trainable, philox_keep_mask)
from sml_tpu_torch.ops.kernels.cpb_bias import _layer1

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


CPB_GRAD_L2 = 1e-2      # the CPB backward's relative L2 bound on the card (chip_smoke.py)


def _bf16_exact_layer1(args):
    """``_cpb_inputs`` snapped so that the Pallas kernel's bf16 layer 1 rounds
    only once, where the port rounds h1: dx and w0x to 4 significant bits
    (u = w0x dx exact in bf16), dy, w0y and b0 to the grids 1/8, 1/16 and
    1/128 (v = w0y dy + b0 exact in bf16), so a = u + v is the one rounding.
    On the raw inputs the Pallas kernel's bf16 products and sums in layer 1
    flip ReLU decisions at a ~ 0 against the port's f32 layer 1, which moves
    the gradients by 1e-2 to 1e-1 relative L2 with or without the backward's
    rounding points (``scripts/cpb_bwd_yardstick.py``)."""
    def sig4(x):
        m, e = np.frexp(x)
        return np.ldexp(np.round(m * 16) / 16, e).astype(np.float32)

    def grid(x, step, lim):
        return (np.clip(np.round(x / step), -lim, lim) * step).astype(np.float32)

    out = list(args)
    out[0], out[2] = sig4(args[0]), sig4(args[2])
    out[1], out[3], out[4] = grid(args[1], 1 / 8, 8), grid(args[3], 1 / 16, 8), \
        grid(args[4], 1 / 128, 64)
    return out


def _pallas_cpb_vjp_bf16(args, dbias):
    """jax.vjp of the interpret-mode ``cpb_bias_trainable`` with bf16 weights
    and dbias (dx, dy f32), as float32 numpy arrays."""
    jargs = [jnp.asarray(a) for a in args[:2]] + [jnp.asarray(a, jnp.bfloat16)
                                                  for a in args[2:]]
    _, vjp = jax.vjp(lambda *a: j_cpb_bias_trainable(*a, True), *jargs)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dbias, jnp.bfloat16))]


def _rel_and_ulps(got, want):
    """(relative L2 error, max |got - want| in bf16 ulps of each element of want)."""
    g = got.float().numpy().reshape(want.shape)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return (np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30),
            (np.abs(g - want) / ulp).max())


def _cpb_errors(got, want):
    """name -> (relative L2 error, max |got - want| in bf16 ulps of want)."""
    return {name: _rel_and_ulps(g, w_) for name, g, w_ in zip(CPB_GRADS, got, want)}


@pytest.mark.parametrize("bg,h,w,j,dm", [(2, 8, 8, 16, 32), (3, 5, 7, 9, 16),
                                         (2, 6, 6, 4, 8)])
def test_plain_cpb_bias_bf16_rounds_h1_where_pallas_does(bg, h, w, j, dm):
    """bf16: the plain forward rounds h1 to bf16 before layer 2, where the Pallas
    kernel (and the tensor-core kernel, and the backward's recompute) rounds it.
    With layer 1 rounded once in both (``_bf16_exact_layer1``) it agrees with
    the interpret-mode Pallas kernel within 1e-5 relative L2 and one bf16 ulp of
    each element.  The control, the same forward with the weights handed over
    as f32 (h1 never rounded) and its output rounded to bf16, lies at least
    100x farther in relative L2."""
    args = _bf16_exact_layer1(_cpb_inputs(bg * h + dm + 1, bg, h, w, j, dm))
    jargs = [jnp.asarray(a) for a in args[:2]] + [jnp.asarray(a, jnp.bfloat16)
                                                  for a in args[2:]]
    want = np.asarray(fused_cpb_bias(*jargs, interpret=True).astype(jnp.float32))
    targs = _t(args[:2]) + [torch.from_numpy(a).bfloat16() for a in args[2:]]
    got = cpb_bias_plain(*targs)
    assert got.dtype == torch.bfloat16
    rel, ulps = _rel_and_ulps(got, want)
    assert rel <= 1e-5 and ulps <= 1.0, (rel, ulps)
    control = cpb_bias_plain(*targs[:2], *(a.float() for a in targs[2:])).bfloat16()
    control_rel, _ = _rel_and_ulps(control, want)
    assert control_rel >= 100 * max(rel, 1e-6), (control_rel, rel)


@pytest.mark.parametrize("bg,h,w,j,dm", [(2, 8, 8, 16, 32), (3, 5, 7, 9, 16),
                                         (2, 6, 6, 4, 8)])
def test_plain_cpb_bias_bwd_bf16_matches_pallas_interpret_vjp(bg, h, w, j, dm):
    """bf16: the plain backward takes the Pallas kernel's rounding points (h1
    and dz2 to bf16 before the products with w1 and before dw1, dx and dy to
    bf16 in dw0x and dw0y), which the tensor-core kernel takes too.  J = 16, 9
    and 4 are under 32; W*J = 63 and 24 are not multiples of 16.

    Every gradient within CPB_GRAD_L2 relative L2.  With layer 1 rounded once in
    both (``_bf16_exact_layer1``) the two backwards differ only in the order of
    their f32 sums, so d_dx and d_dy agree within 1e-5 relative L2 and every
    weight gradient (bf16; the Pallas VJP's db2 is f32) within one bf16 ulp per
    element.  The control, the same backward with the roundings left out (the
    bf16 weights and dbias handed over as f32), misses both bounds."""
    args = _bf16_exact_layer1(_cpb_inputs(bg * h + dm + 1, bg, h, w, j, dm))
    dbias = np.random.default_rng(dm).normal(size=(bg, h, w * j)).astype(np.float32)
    want = _pallas_cpb_vjp_bf16(args, dbias)
    tdbias = torch.from_numpy(dbias).bfloat16()
    targs = _t(args[:2]) + [torch.from_numpy(a).bfloat16() for a in args[2:8]]
    got = cpb_bias_bwd_plain(*targs, tdbias)
    assert [g.dtype for g in got] == [torch.float32] * 2 + [torch.bfloat16] * 7
    errors = _cpb_errors(got, want)
    assert max(rel for rel, _ in errors.values()) <= CPB_GRAD_L2, errors
    assert max(errors[n][0] for n in ("d_dx", "d_dy")) <= 1e-5, errors
    assert max(errors[n][1] for n in CPB_GRADS[2:]) <= 1.0, errors
    control = _cpb_errors(cpb_bias_bwd_plain(*targs[:2], *(a.float() for a in targs[2:]),
                                             tdbias.float()), want)
    assert max(control[n][0] for n in ("d_dx", "d_dy")) > 1e-4, control
    assert max(control[n][1] for n in CPB_GRADS[2:]) > 1.0, control


def _bf16_rounding_bound(want: np.ndarray) -> np.ndarray:
    """Three bf16 ulps of each element plus 3 * 2**-13 of the tensor's max:
    what two backwards that round the same quantities to bf16, from f32 sums
    taken in another order, differ by here (at most 0.8 of it), while either
    rounding left out misses it (by 1.35x at least)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return 3 * (ulp + 2.0 ** -13 * np.abs(want).max())


def _attn_bwd_errors(got, want):
    """name -> (|got - want| / the bf16 rounding bound).max() per gradient."""
    out = {}
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        if g is not None:
            out[name] = (np.abs(g.float().numpy() - w_) / _bf16_rounding_bound(w_)).max()
    return out


@pytest.mark.parametrize("bg,n,j", [(3, 100, 16), (2, 64, 8), (3, 100, 20), (3, 100, 72)])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("form", ["bias", "nobias", "span", "span_bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_deform_attention_bwd_matches_pallas_interpret_vjp(bg, n, j, keep_prob, form,
                                                                 dtype):
    """Every form of the backward (bias or none x span or none x dropout or
    none).  N=100 is ragged against every row tile; J=20 and 72 are 4 and 8 keys
    past a 16-key step, 20 not a multiple of 8.  The spans: an interior
    interval, a whole bag, a bag with no valid row.  At keep 0.9 one shared
    numpy {0, 1} mask feeds the Pallas kernel's mask operand and the plain
    versions.

    f32: element-wise 1e-5 absolute + 1e-5 relative.  bf16: 1e-2 of each
    tensor's max (the kernels' tolerance on the card) and, element-wise, the
    bound of ``_bf16_rounding_bound``, which holds the plain backward's
    rounding points to the Pallas kernel's: p * m to v's dtype before dv, ds to
    q's dtype before dq and dk.  Each of those roundings left out (the plain
    backward given v, or q, in f32) misses that bound."""
    q, k, v, bias, dout = _attn_inputs(n + j, bg, n, j)
    bias = bias if form in ("bias", "span_bias") else None
    span = None
    if form.startswith("span"):
        span = np.asarray([[7, n - 7, 3, j - 3], [0, n, 0, j], [n, n, 0, j]], np.int32)[:bg]
    mask = None
    if keep_prob < 1.0:
        mask = (np.random.default_rng(j).uniform(size=(bg, n, j)) < keep_prob
                ).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jm = None if mask is None else jnp.asarray(mask)
    jspan = None if span is None else jnp.asarray(span)
    leaves = [q, k, v] + ([] if bias is None else [bias])
    fn = lambda q_, k_, v_, b_=None: j_attn_trainable(q_, k_, v_, b_, jm, None, jspan,
                                                      keep_prob, True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in leaves))
    want = [np.asarray(w_.astype(jnp.float32)) for w_ in vjp(jnp.asarray(dout, jdt))]

    tdt = getattr(torch, dtype)
    keep = None if mask is None else torch.from_numpy(mask)
    tspan = None if span is None else torch.from_numpy(span)
    tq, tk, tv, td = (t.to(tdt) for t in _t((q, k, v, dout)))
    tb = None if bias is None else torch.from_numpy(bias).to(tdt)
    got = deform_attention_bwd_plain(tq, tk, tv, tb, td, keep, keep_prob, tspan)
    assert (got[3] is None) == (bias is None)
    assert all(g.dtype == tdt for g in got if g is not None)
    if dtype == "float32":
        np.testing.assert_allclose(deform_attention_fwd_plain(tq, tk, tv, tb, keep, keep_prob,
                                                              tspan).numpy(),
                                   np.asarray(out), **TOL)
        for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g.numpy(), w_, err_msg=name, **TOL)
        return
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert np.abs(g.float().numpy() - w_).max() <= 1e-2 * np.abs(w_).max(), name
    errors = _attn_bwd_errors(got, want)
    assert max(errors.values()) <= 1.0, errors
    # the control: without the rounding of p * m (v in f32) dv misses the bound,
    # without the rounding of ds (q in f32) dq or dk does
    no_pd = deform_attention_bwd_plain(tq, tk, tv.float(), tb, td, keep, keep_prob, tspan)
    assert _attn_bwd_errors(no_pd, want)["dv"] > 1.0
    no_ds = deform_attention_bwd_plain(tq.float(), tk, tv, tb, td, keep, keep_prob, tspan)
    assert max(_attn_bwd_errors(no_ds, want)[name] for name in ("dq", "dk")) > 1.0


@pytest.mark.parametrize("bg,n,j", [(3, 100, 16), (2, 64, 8), (3, 100, 20), (3, 100, 72),
                                    (2, 65, 16), (3, 100, 37)])
def test_plain_deform_attention_f32_bias_matches_pallas_interpret_vjp(bg, n, j):
    """bf16 q, k, v beside an f32 bias: the form of the 1-D deformable
    attention (``sml_tpu/ops/deformable.py:687-691``; no span, no dropout; the
    plain versions take no span here as the port's 1-D path passes none).
    N = 65 with J = 16 is a 64-token bag with its cls token.  The forward: at
    least 99.9% of the elements equal to the interpret-mode Pallas kernel's and
    none more than 1/16 of a bf16 ulp of the output's scale away (p * m is
    rounded to bf16 where Pallas rounds it).  The backward: dq, dk, dv in bf16
    within ``_bf16_rounding_bound`` (ds rounded to bf16 before dq and dk, p
    before dv); dbias in f32, unrounded, within 1e-5 of its scale plus 1e-5
    of each element (the f32 sums of dp run in another order); the control,
    dbias rounded to bf16 as the bf16-bias form returns it, misses that."""
    q, k, v, bias, dout = _attn_inputs(n + j + 7, bg, n, j)
    fn = lambda q_, k_, v_, b_: j_attn_trainable(q_, k_, v_, b_, None, None, None, 1.0, True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                       jnp.asarray(bias, jnp.float32))
    grads = vjp(jnp.asarray(dout, jnp.bfloat16))
    assert grads[3].dtype == jnp.float32
    want_out = np.asarray(out.astype(jnp.float32))
    want = [np.asarray(g.astype(jnp.float32)) for g in grads]
    tq, tk, tv, td = (t.bfloat16() for t in _t((q, k, v, dout)))
    tb = torch.from_numpy(bias)

    got_out = deform_attention_fwd_plain(tq, tk, tv, tb)
    assert got_out.dtype == torch.bfloat16
    got_out = got_out.float().numpy()
    assert (got_out == want_out).mean() >= 0.999, (got_out == want_out).mean()
    assert np.abs(got_out - want_out).max() <= _bf16_ulp_of_scale(want_out) / 16

    got = deform_attention_bwd_plain(tq, tk, tv, tb, td)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    errors = _attn_bwd_errors(got[:3], want[:3])
    assert max(errors.values()) <= 1.0, errors
    dbias_bound = 1e-5 * np.abs(want[3]).max() + 1e-5 * np.abs(want[3])
    assert (np.abs(got[3].numpy() - want[3]) <= dbias_bound).all()
    rounded = got[3].bfloat16().float().numpy()
    assert not (np.abs(rounded - want[3]) <= dbias_bound).all()


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


@pytest.mark.parametrize("boundary", [False, True])
def test_cpb_layer2_mask_counts_agree_on_the_plain_versions(boundary):
    """chip_smoke.py's layer-2 mask check on CPU tensors (the plain versions):
    with w2 = e_c and b2 = 0 the forward's count of bias > 0 and the
    backward's db1[c] from dbias = 1 both equal the number of pairs whose
    z2[c] > 0, in every column.  On boundary inputs the class (MASK_DX[0],
    MASK_DY[0]) has an exact layer 1 and a z2 within half an f32 ulp of its
    sum h1 w1 of 0 in float64, so another order of the sums may flip it."""
    bg, h, w, j, dm = 2, 5, 6, 7, 8
    args = cpb_mask_inputs(h, w, j, dm, seed=4, boundary=boundary, device="cpu", bg=bg)
    dx, dy, w0x, w0y, b0, w1, b1 = args[:7]
    h1 = torch.relu(_layer1(dx, dy, w0x, w0y, b0, 0, h))        # (BG, H, W, J, dm)
    z2 = h1 @ w1 + b1
    for c in range(dm):
        fwd, bwd = cpb_mask_counts(args, c)
        assert fwd == bwd == int((z2[..., c] > 0).sum()), c
    if boundary:
        cls = (dx.reshape(bg, 1, w, j) == MASK_DX[0]) & (dy[:, :, None, :] == MASK_DY[0])
        assert cls.any()
        h1c = h1[cls].double()
        total = h1c @ w1.double()
        assert torch.equal(h1c, (torch.relu(w0x.double() * MASK_DX[0] + w0y.double()
                                            * MASK_DY[0] + b0.double())).expand_as(h1c))
        assert bool(((total + b1.double()).abs() <= 2.0 ** -24 * total.abs()).all())


def test_launch_counts_carry_the_f32_cpb_forms():
    """The CPB wrappers count their f32 launches (the default compute dtype's)
    apart: ``launch_counts()`` reports them, ``reset_launch_counts()`` zeroes
    them with the rest, and a CPU call (the plain version) counts nothing."""
    from sml_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    counts = launch_counts()
    assert counts["cpb_bias_f32"] == counts["cpb_bias_bwd_f32"] == 0
    cpb_bias.f32_launches, cpb_bias_bwd.f32_launches = 3, 5
    counts = launch_counts()
    assert (counts["cpb_bias_f32"], counts["cpb_bias_bwd_f32"]) == (3, 5)
    reset_launch_counts()
    args = _t(_cpb_inputs(5, 2, 3, 4, 6, 8))
    cpb_bias_bwd(*args[:8], cpb_bias(*args))
    assert not any(launch_counts().values())


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
    port computes layer 1 in f32 and rounds h1 (before layer 2) and the output."""
    args = _cpb_inputs(21, 2, 8, 8, 16, 32)
    jargs = [jnp.asarray(a) for a in args[:2]] + [jnp.asarray(a, jnp.bfloat16)
                                                  for a in args[2:]]
    want = np.asarray(fused_cpb_bias(*jargs, interpret=True).astype(jnp.float32))
    targs = _t(args[:2]) + [torch.from_numpy(a).bfloat16() for a in args[2:]]
    got = cpb_bias_plain(*targs).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp_of_scale(want))


def test_plain_deform_attention_bf16_within_one_ulp_of_pallas_interpret():
    """The Pallas kernel rounds p to v's dtype before p @ v, and so does the
    port's plain forward (and its bf16 kernel): both sum p v in f32 and round
    the output; ``test_plain_deform_attention_bf16_rounds_p_where_pallas_does``
    holds them closer."""
    q, k, v, bias, _ = _attn_inputs(22, 2, 100, 16)
    want = np.asarray(j_attn_trainable(*(jnp.asarray(a, jnp.bfloat16)
                                         for a in (q, k, v, bias)),
                                       interpret=True).astype(jnp.float32))
    got = deform_attention_fwd_plain(*(t.bfloat16() for t in _t((q, k, v, bias)))
                                     ).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp_of_scale(want))


@pytest.mark.parametrize("bg,n,j,form,keep_prob", [
    (2, 100, 16, "bias", 1.0), (2, 128, 144, "bias", 1.0), (2, 64, 256, "bias", 1.0),
    (2, 100, 72, "bias", 0.9), (3, 100, 72, "span", 1.0)])
def test_plain_deform_attention_bf16_rounds_p_where_pallas_does(bg, n, j, form, keep_prob):
    """The plain bf16 forward rounds the kept probabilities p * m to v's dtype
    before the product with v, where ``_attn_fwd_kernel`` rounds them: against
    the interpret-mode Pallas kernel on bf16 inputs at least 99.9% of the
    elements are equal and none is more than 1/16 of a bf16 ulp of the
    output's scale away.  The dropout case feeds one numpy {0, 1} mask to the
    Pallas kernel's mask operand and to the plain version; the span form has
    an interior interval, a whole bag and a bag with no valid row.  The
    control, p kept in f32 (v given in f32), misses the share of equal
    elements."""
    q, k, v, bias, _ = _attn_inputs(22, bg, n, j)
    bias = bias if form == "bias" else None
    span = None
    if form == "span":
        span = np.asarray([[7, n - 7, 3, j - 3], [0, n, 0, j], [n, n, 0, j]], np.int32)[:bg]
    mask = None
    if keep_prob < 1.0:
        mask = (np.random.default_rng(j).uniform(size=(bg, n, j)) < keep_prob
                ).astype(np.float32)
    leaves = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_attn_trainable(
        *leaves, None if bias is None else jnp.asarray(bias, jnp.bfloat16),
        None if mask is None else jnp.asarray(mask), None,
        None if span is None else jnp.asarray(span), keep_prob, True
    ).astype(jnp.float32))
    tq, tk, tv = (t.bfloat16() for t in _t((q, k, v)))
    tb = None if bias is None else torch.from_numpy(bias).bfloat16()
    keep = None if mask is None else torch.from_numpy(mask)
    tspan = None if span is None else torch.from_numpy(span)
    bound = _bf16_ulp_of_scale(want) / 16

    got = deform_attention_fwd_plain(tq, tk, tv, tb, keep, keep_prob, tspan).float().numpy()
    assert (got == want).mean() >= 0.999, (got == want).mean()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)
    control = deform_attention_fwd_plain(tq, tk, tv.float(), tb, keep, keep_prob,
                                         tspan).float().numpy()
    assert (control == want).mean() < 0.999, (control == want).mean()


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
@pytest.mark.parametrize("bg,h,w,j", [(4, 10, 10, 36), (4, 8, 8, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cpb_bias_bwd_matches_plain(dtype, bg, h, w, j):
    """J = 36, and J = 4 (a 64-token bag's 2 x 2 offset grid), fewer kv points
    than a warp has lanes: a second launch must return the first one's
    gradients bit for bit."""
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _cpb_inputs(1, bg, h, w, j, 32)]
    args[2:] = [a.to(dtype) for a in args[2:]]
    dbias = torch.randn(bg, h, w * j, device=dev).to(dtype)
    before = (cpb_bias_bwd.launches, cpb_bias_bwd.f32_launches)
    got = cpb_bias_bwd(*args[:8], dbias)
    torch.cuda.synchronize()
    assert (cpb_bias_bwd.launches, cpb_bias_bwd.f32_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float32))
    # relative L2: the kernel's fused multiply-adds and the plain version's separate
    # operations can take different ReLU-derivative decisions at a ~ 0 (chip_smoke.py)
    for name, g, w_ in zip(CPB_GRADS, got, cpb_bias_bwd_plain(*args[:8], dbias)):
        g, w_ = g.float(), w_.float()
        assert ((g - w_).norm() / w_.norm()).item() <= CPB_GRAD_L2, name
    again = cpb_bias_bwd(*args[:8], dbias)
    for name, g, g2 in zip(CPB_GRADS, got, again):
        assert torch.equal(g, g2), name


# (N, J) where the staged bias tile's rows start at every 16-byte phase: J = 144 and
# chip_smoke.py's ragged shapes (every residue of J mod 8; N = 100 and N = 65, one row
# past a 64-row tile)
RAGGED_SHAPES = [(100, 144), *RAGGED, *RAGGED_BIAS]
# a Nystrom chain's thin side (256 landmark rows or keys, as TransMIL's): at BG = 4
# the f32 kernels cut the long side into segments, chain 3 the rows kernel's keys,
# chain 1 the keys kernel's rows
CHAIN_SHAPES = [(256, 2560), (2560, 256)]
BWD_FORMS = ("bias", "nobias", "span", "span_bias")
BWD_CASES = ([(torch.float32, n, j) for n, j in RAGGED_SHAPES + CHAIN_SHAPES]
             + [(torch.bfloat16, n, j) for n, j in RAGGED_SHAPES])


def _spans(seed, bg, n, j):
    """(bg, 4) int32 [row_start, row_end, col_start, col_end) intervals, the last
    bag with no valid row."""
    rng = np.random.default_rng(seed)
    r0, c0 = rng.integers(0, n // 2, bg), rng.integers(0, j // 2, bg)
    span = np.stack([r0, r0 + rng.integers(1, n // 2, bg), c0,
                     c0 + rng.integers(1, j // 2, bg)], axis=1)
    span[-1, :2] = n
    return torch.from_numpy(span.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,j", BWD_CASES)
@pytest.mark.parametrize("form", BWD_FORMS)
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
def test_cuda_deform_attention_bwd_matches_plain(dtype, keep_prob, form, n, j):
    """Every form (bias or none x span or none x dropout or none) in f32 and
    bf16 at the ragged shapes, and in f32 at the thin-side chains too, where
    the segments' partial sums meet; a second launch bit for bit."""
    dev = _cuda()
    q, k, v, bias, dout = (torch.from_numpy(a).to(dev, dtype)
                           for a in _attn_inputs(2, 4, n, j))
    bias = bias if "bias" in form else None
    span = _spans(n + j, 4, n, j).to(dev) if form.startswith("span") else None
    keep = None if keep_prob == 1.0 else philox_keep_mask(5, 4, n, j, keep_prob,
                                                          device=dev)
    got = deform_attention_bwd(q, k, v, bias, dout, keep_prob, 5, span)
    torch.cuda.synchronize()
    want = deform_attention_bwd_plain(q, k, v, bias, dout, keep, keep_prob, span)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2,
                                                                         atol=2e-2)
    assert (got[3] is None) == (bias is None)
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w_ is not None:
            torch.testing.assert_close(g.float(), w_.float(), msg=name, **tol)
    again = deform_attention_bwd(q, k, v, bias, dout, keep_prob, 5, span)
    for name, g, g2 in zip(("dq", "dk", "dv", "dbias"), got, again):
        assert (g is None and g2 is None) or torch.equal(g, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,j", RAGGED_SHAPES + [(2501, 625)])
def test_cuda_deform_attention_f32_bias_matches_plain(n, j):
    """The f32-bias form (bf16 q, k, v; no span, no dropout) forward and
    backward against their plain versions, one count each of the form, and
    a second launch bit for bit; N = 2501, J = 625 is the 1-D path's shape
    at fixdim 2500.  Forward within one bf16 ulp of the output's scale;
    dq, dk, dv at the bf16 tolerance above; dbias (f32) within 1e-2 of its
    scale (the kernel's ds sums dp in another order)."""
    dev = _cuda()
    q, k, v, bias, dout = (torch.from_numpy(a).to(dev) for a in _attn_inputs(3, 2, n, j))
    q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    before = (deform_attention_fwd.f32bias_launches, deform_attention_bwd.f32bias_launches)
    out = deform_attention_fwd(q, k, v, bias)
    got = deform_attention_bwd(q, k, v, bias, dout)
    torch.cuda.synchronize()
    assert (deform_attention_fwd.f32bias_launches,
            deform_attention_bwd.f32bias_launches) == (before[0] + 1, before[1] + 1)
    want = deform_attention_fwd_plain(q, k, v, bias).float()
    assert (out.float() - want).abs().max().item() <= _bf16_ulp_of_scale(want.cpu().numpy())
    assert got[3].dtype == torch.float32
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got,
                           deform_attention_bwd_plain(q, k, v, bias, dout)):
        g, w_ = g.float(), w_.float()
        assert (g - w_).abs().max().item() <= 1e-2 * w_.abs().max().item(), name
    assert torch.equal(deform_attention_fwd(q, k, v, bias), out)
    for name, g, g2 in zip(("dq", "dk", "dv", "dbias"), got,
                           deform_attention_bwd(q, k, v, bias, dout)):
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("form", ["span", "dropout", "f32_q", "built"])
def test_f32_bias_kernel_form_is_only_the_1d_one(form):
    """The wrappers hand a kernel an f32 bias beside bf16 q only without span
    and dropout (the form that is built); f32 q with a bf16 bias is refused
    too.  The dtype check comes before the device check, so meta tensors show
    it here: the built form gets past it and fails on the device alone."""
    from sml_tpu_torch.ops.kernels.deform_attn import _check_kernel

    f32_q = form == "f32_q"
    q = torch.empty(2, 8, 64, dtype=torch.float32 if f32_q else torch.bfloat16, device="meta")
    bias = torch.empty(2, 8, 4, dtype=torch.bfloat16 if f32_q else torch.float32,
                       device="meta")
    span = torch.zeros(2, 4, dtype=torch.int32, device="meta") if form == "span" else None
    keep_prob = 0.9 if form == "dropout" else 1.0
    error, match = (ValueError, "runs on cpu or cuda") if form == "built" else (TypeError,
                                                                                "f32 beside")
    with pytest.raises(error, match=match):
        _check_kernel("deform_attention_fwd", q, bias, span, keep_prob, ())
