"""The port's bias-less and span attention forms and the Nystrom modules of
TransMIL against the JAX package, f32.

Kernels: the plain forward and backward against ``jax.vjp`` of the JAX custom
VJP with its Pallas kernels in interpret mode (1e-5), in the bias-less form,
the span form (with a fully invalid bag) and the span form with a bias and an
explicit dropout mask.  Modules, on bridged weights: ``moore_penrose_pinv``
(1e-5), ``PPEG``, ``NystromAttention`` through its fused route (JAX
``use_pallas=True, pallas_interpret=True``, at shapes the JAX gate admits,
which the tests assert: ``dim_head=32`` in f32, 32 * 4 = 128 bytes) and
through its XLA route, outputs and input and parameter gradients at 1e-4, and
the ``TransMIL`` forward on square and non-square bags (1e-4).  On a machine
with a CUDA card, the bias-less and span kernels against their plain versions
at a chain-3 shape whose keys span several tiles.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.models.mil import TransMIL as JTransMIL
from sml_tpu.ops.conv import PPEG as JPPEG
from sml_tpu.ops.linear_algebra import moore_penrose_pinv as j_pinv
from sml_tpu.ops.nystrom import NystromAttention as JNystrom
from sml_tpu.ops.nystrom import _fused_chains_supported
from sml_tpu.ops.pallas.deform_attn import deform_attention_trainable as j_attn_trainable
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params
from sml_tpu_torch.models.mil import TransMIL
from sml_tpu_torch.ops import nystrom
from sml_tpu_torch.ops.conv import PPEG
from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                       deform_attention_fwd, deform_attention_fwd_plain,
                                       deform_attention_trainable)
from sml_tpu_torch.ops.linear_algebra import moore_penrose_pinv
from sml_tpu_torch.ops.nystrom import NystromAttention, fused_chains_supported

KTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
# the spans of tests/test_fused_attention.py: an interior interval, a whole
# bag, a bag with no valid row
SPANS = [[3, 17, 1, 5], [0, 20, 0, 6], [20, 20, 0, 6]]


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("form", ["nobias", "span", "span_bias_dropout"])
def test_plain_attention_forms_match_pallas_interpret_vjp(form):
    rng = np.random.default_rng(len(form))
    bg, n, j, dh, keep_prob = 3, 20, 6, 16, 1.0
    q, k, v = _f32(rng, bg, n, dh, scale=dh ** -0.5), _f32(rng, bg, j, dh), _f32(rng, bg, j, dh)
    dout = _f32(rng, bg, n, dh)
    bias = _f32(rng, bg, n, j) if form == "span_bias_dropout" else None
    span = None if form == "nobias" else np.asarray(SPANS, np.int32)
    keep = None
    if form == "span_bias_dropout":
        keep_prob = 0.75
        keep = (rng.uniform(size=(bg, n, j)) < keep_prob).astype(np.float32)
    jspan = None if span is None else jnp.asarray(span)
    jkeep = None if keep is None else jnp.asarray(keep)
    leaves = [q, k, v] + ([] if bias is None else [bias])

    def fn(*a):
        b_ = a[3] if bias is not None else None
        return j_attn_trainable(a[0], a[1], a[2], b_, jkeep, None, jspan, keep_prob, True)

    out, vjp = jax.vjp(fn, *map(jnp.asarray, leaves))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, td = _t((q, k, v, dout))
    tb = None if bias is None else torch.from_numpy(bias)
    ts = None if span is None else torch.from_numpy(span)
    tkeep = None if keep is None else torch.from_numpy(keep)
    got_out = deform_attention_fwd_plain(tq, tk, tv, tb, tkeep, keep_prob, ts)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), **KTOL)
    got = deform_attention_bwd_plain(tq, tk, tv, tb, td, tkeep, keep_prob, ts)
    assert (got[3] is None) == (bias is None)
    for name, g, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **KTOL)
    if span is not None:
        assert not got[0][2].any()            # the bag with no valid row: no dq
        if keep is None:                      # and uniform rows over all J
            np.testing.assert_allclose(got_out[2].numpy(),
                                       np.broadcast_to(v[2].mean(0), (n, dh)), **KTOL)


def test_bias_less_span_trainable_on_cpu_is_the_plain_backward():
    rng = np.random.default_rng(9)
    q, k, v, dout = _t((_f32(rng, 3, 20, 8), _f32(rng, 3, 6, 8), _f32(rng, 3, 6, 8),
                        _f32(rng, 3, 20, 8)))
    span = torch.tensor(SPANS, dtype=torch.int32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = {fn: (fn.launches, fn.nobias_launches, fn.span_launches)
              for fn in (deform_attention_fwd, deform_attention_bwd)}
    out = deform_attention_trainable(*leaves, span=span)
    torch.testing.assert_close(out, deform_attention_fwd_plain(q, k, v, span=span),
                               rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, dout)
    want = deform_attention_bwd_plain(q, k, v, None, dout, span=span)
    for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0, msg=name)
    for fn, counts in before.items():       # CPU tensors never launch a kernel
        assert (fn.launches, fn.nobias_launches, fn.span_launches) == counts


@pytest.mark.parametrize("bad", ["span_width", "span_dtype", "span_bags"])
def test_attention_rejects_bad_spans(bad):
    rng = np.random.default_rng(0)
    q, k, v = _t((_f32(rng, 2, 8, 8), _f32(rng, 2, 4, 8), _f32(rng, 2, 4, 8)))
    span = {"span_width": torch.zeros(2, 3, dtype=torch.int32),
            "span_dtype": torch.zeros(2, 4),
            "span_bags": torch.zeros(3, 4, dtype=torch.int32)}[bad]
    with pytest.raises((ValueError, TypeError)):
        deform_attention_fwd(q, k, v, span=span)


def test_pinv_matches_jax_and_scales_over_the_whole_batch():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 3, 16, 16)) * np.array([0.5, 2.0, 4.0])[None, :, None, None]
    x = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    x[1, 2] *= 3.0                              # one matrix far from row-stochastic
    x = x.astype(np.float32)
    want = np.asarray(j_pinv(jnp.asarray(x), 6))
    got = moore_penrose_pinv(torch.from_numpy(x), 6).numpy()
    np.testing.assert_allclose(got, want, **KTOL)
    alone = moore_penrose_pinv(torch.from_numpy(x[:1, :1]), 6).numpy()
    assert not np.allclose(alone, got[:1, :1], rtol=0, atol=1e-6)   # batch-wide scale
    assert moore_penrose_pinv(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_ppeg_matches_jax():
    rng = np.random.default_rng(2)
    x = _f32(rng, 2, 1 + 6 * 6, 16)
    variables = JPPEG(16).init(jax.random.PRNGKey(0), jnp.asarray(x), 6, 6)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02, variables["params"])
    want = JPPEG(16).apply({"params": params}, jnp.asarray(x), 6, 6)
    ppeg = PPEG(16)
    load_flax_params(ppeg, params)
    got = ppeg(torch.from_numpy(x), 6, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[:, 0].detach().numpy(), x[:, 0])   # cls untouched


KW = dict(dim=64, dim_head=32, heads=2, num_landmarks=16, pinv_iterations=6,
          residual=True, dropout=0.0)


def _interval_mask(n, lengths, starts=None):
    starts = starts or [0] * len(lengths)
    idx = np.arange(n)[None, :]
    lo, length = np.asarray(starts)[:, None], np.asarray(lengths)[:, None]
    return (idx >= lo) & (idx < lo + length)


def _check_nystrom(n, lengths=None, starts=None, dim_head=32, interval=True, b=2):
    """Port vs JAX NystromAttention on the same weights: output, d x and every
    parameter gradient of sum(out * cot); returns whether the port fused."""
    kw = dict(KW, dim_head=dim_head)
    rng = np.random.default_rng(n + dim_head)
    x = _f32(rng, b, n, kw["dim"])
    cot = _f32(rng, b, n, kw["dim"])
    mask = None if lengths is None else _interval_mask(n, lengths, starts)
    jmod = JNystrom(**kw, use_pallas=True, pallas_masked=interval, pallas_interpret=True)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True)["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01, params)

    def loss(p, x_):
        return jnp.sum(jmod.apply({"params": p}, x_, mask=jmask, deterministic=True)
                       * jnp.asarray(cot))

    want_out = jmod.apply({"params": params}, jnp.asarray(x), mask=jmask, deterministic=True)
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    port = NystromAttention(**kw)
    load_flax_params(port, params)
    tx = torch.from_numpy(x).requires_grad_(True)
    tmask = None if mask is None else torch.from_numpy(mask)
    with mock.patch.object(nystrom, "deform_attention_trainable",
                           wraps=nystrom.deform_attention_trainable) as chains:
        out = port(tx, mask=tmask, interval_mask=interval)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), **TOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_gp))
    got = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(port).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert chains.call_count in (0, 2)
    return chains.call_count == 2


@pytest.mark.parametrize("case", ["front_pad", "suffix_masks", "masked_landmarks",
                                  "prefix_intervals"])
def test_nystrom_fused_route_matches_jax(case):
    n, lengths, starts = {
        "front_pad": (100, None, None),                   # n % m: 12 rows of front pad
        "suffix_masks": (200, [150, 200], None),          # bucketed bags + front pad
        "masked_landmarks": (256, [40, 8, 256], None),    # whole segments invalid
        "prefix_intervals": (256, [100, 200], [30, 56]),  # intervals with a prefix
    }[case]
    m = KW["num_landmarks"]
    n_pad = -(-n // m) * m
    # the JAX gate admits the shape, so the JAX side runs its Pallas kernels
    assert _fused_chains_supported(n_pad, m, 32, jnp.float32, has_span=lengths is not None)
    assert fused_chains_supported(n_pad, m, 32, torch.float32)
    assert _check_nystrom(n, lengths, starts, b=len(lengths or [0, 0]))


@pytest.mark.parametrize("case", ["dim_head_16", "not_an_interval", "short"])
def test_nystrom_xla_route_matches_jax(case):
    if case == "dim_head_16":            # 16 * 4 bytes < 128: the gate declines
        assert not _fused_chains_supported(208, 16, 16, jnp.float32)
        assert not _check_nystrom(200, [150, 200], dim_head=16)
    elif case == "not_an_interval":      # pallas_masked=False keeps the XLA route
        assert not _check_nystrom(200, [150, 200], interval=False)
    else:                                # n_pad < 4 m
        assert not fused_chains_supported(48, 16, 32, torch.float32)
        assert not _check_nystrom(40, [30, 40])


def test_nystrom_bf16_keeps_fully_masked_landmarks_finite():
    """-f32max rounds to -inf in bf16 and the JAX module returns NaN there;
    the port fills in f32 (module note)."""
    torch.manual_seed(0)
    port = NystromAttention(**KW, dtype=torch.bfloat16)
    for p in port.parameters():
        torch.nn.init.normal_(p, std=0.05)
    mask = torch.from_numpy(_interval_mask(256, [40, 256]))
    out = port(torch.randn(2, 256, KW["dim"]), mask=mask)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


@functools.lru_cache(maxsize=None)
def _transmil_params():
    jmodel = JTransMIL(label_dim=4, path_dim=16, hidden_dim=256, use_pallas=True,
                       pallas_interpret=True)
    x = jnp.zeros((1, 529, 24), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(4), x, deterministic=True)["params"]
    return jmodel, jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01, params)


@pytest.mark.parametrize("case", ["square", "square_masked", "non_square_masked"])
def test_transmil_forward_matches_jax(case):
    """hidden 256: 8 heads of 32 and 128 landmarks.  Square bags of 529 (23 x 23,
    + cls = 530 tokens, n_pad 640) take the fused route; a non-square masked bag
    (520 patches, wrap-padded by 9) takes the XLA route on both sides."""
    jmodel, params = _transmil_params()
    n = 520 if case == "non_square_masked" else 529
    assert _fused_chains_supported(640, 128, 32, jnp.float32, has_span=True)
    rng = np.random.default_rng(n)
    x = _f32(rng, 2, n, 24)
    mask = None if case == "square" else _interval_mask(n, [300, n])
    jmask = None if mask is None else jnp.asarray(mask)
    want = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True, mask=jmask)
    model = TransMIL(4, 16, 24, hidden_dim=256).eval()
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_bias_less_and_span_kernels_match_plain(dtype, masked):
    dev = _cuda()
    rng = np.random.default_rng(3)
    bg, n, j = 4, 64, 700                      # six key tiles, the last ragged
    q, k, v, dout = (torch.from_numpy(a).to(dev, dtype) for a in (
        _f32(rng, bg, n, 64, scale=0.125), _f32(rng, bg, j, 64), _f32(rng, bg, j, 64),
        _f32(rng, bg, n, 64)))
    span = (torch.tensor([[0, 64, 0, 700], [5, 40, 300, 650], [64, 64, 0, 700],
                          [0, 30, 200, 210]], dtype=torch.int32, device=dev)
            if masked else None)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2,
                                                                         atol=2e-2)
    got = deform_attention_fwd(q, k, v, span=span)
    torch.testing.assert_close(got.float(), deform_attention_fwd_plain(
        q, k, v, span=span).float(), **tol)
    grads = deform_attention_bwd(q, k, v, None, dout, span=span)
    assert grads[3] is None
    for name, g, w_ in zip(("dq", "dk", "dv"), grads,
                           deform_attention_bwd_plain(q, k, v, None, dout, span=span)):
        torch.testing.assert_close(g.float(), w_.float(), msg=name, **tol)
