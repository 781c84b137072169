"""CMTA's Nystrom chains on the dh = 32 form of the attention kernels, against
the JAX package, f32 (TOL, 1e-4): the CMTA forward through the fused chains
at fixdim 484 (2 x 8 heads of 32 over n_pad 512 = 4 x 128 landmarks, which
both gates admit: the JAX side runs its Pallas kernels in interpret mode, the
port the plain versions of its kernels), ``NystromAttention`` alone at
CMTA's width, outputs and gradients, and the dh = 32 attention alone at the
card test's shapes; the kernel check's head-dim rules.  On a
machine with a CUDA card, the dh = 32 kernels against their plain versions
and the refusal of every other dh = 32 form.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.models.cmta import CMTA as JCMTA
from sml_tpu.ops.nystrom import NystromAttention as JNystrom
from sml_tpu.ops.nystrom import _fused_chains_supported
from sml_tpu.ops.pallas.deform_attn import deform_attention_trainable as j_attention
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params
from sml_tpu_torch.models.cmta import CMTA
from sml_tpu_torch.ops import nystrom
from sml_tpu_torch.ops.kernels import (deform_attention_bwd, deform_attention_bwd_plain,
                                       deform_attention_fwd, deform_attention_fwd_plain,
                                       deform_attention_trainable)
from sml_tpu_torch.ops.nystrom import NystromAttention, fused_chains_supported
from test_torch_cmta import CMTA_OUT
from test_torch_mcat import TOL, np_tree, perturbed

# CMTA's Nystrom layers: dim 256, 8 heads of 32, 128 landmarks
M, DH = 128, 32


def test_fused_route_matches_jax_pallas_interpret():
    """fixdim 484 = 22 x 22: 485 tokens with the cls token, front-padded to
    n_pad 512 = 4 m, which both gates admit in f32; both TransformerP's two
    TransLayers take the fused chains (8 chain calls), the genomic stream's 5
    tokens the XLA route."""
    assert _fused_chains_supported(512, M, DH, jnp.float32)
    assert fused_chains_supported(512, M, DH, torch.float32)
    assert not fused_chains_supported(512, M, DH, torch.bfloat16)    # 64 bytes a row
    rng = np.random.default_rng(484)
    x_path = rng.normal(size=(2, 484, 24)).astype(np.float32)
    x_omic = rng.normal(size=(2, 431)).astype(np.float32)
    jmodel = JCMTA(label_dim=4, use_pallas=True, pallas_interpret=True)
    init = jax.jit(functools.partial(jmodel.init, deterministic=True))
    variables = perturbed(np_tree(init(jax.random.PRNGKey(4), jnp.asarray(x_path),
                                       jnp.asarray(x_omic))))
    want = jax.jit(functools.partial(jmodel.apply, deterministic=True))(
        variables, jnp.asarray(x_path), jnp.asarray(x_omic))
    model = CMTA(label_dim=4, input_path_dim=24, fusion="concat").eval()
    load_flax_params(model, variables)
    with mock.patch.object(nystrom, "deform_attention_trainable",
                           wraps=nystrom.deform_attention_trainable) as chains, \
            torch.no_grad():
        got = model(torch.from_numpy(x_path), torch.from_numpy(x_omic))
    assert chains.call_count == 8
    assert set(got) == set(want) == set(CMTA_OUT)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_nystrom_at_cmta_width_matches_jax_pallas_interpret():
    """NystromAttention(256) over 505 tokens (front-padded to 512): the output,
    d x and every parameter gradient of sum(out * cot) against the JAX module
    on its Pallas kernels in interpret mode; the port's chains go through the
    plain versions of the dh = 32 kernels."""
    kw = dict(dim=256, dim_head=DH, heads=8, num_landmarks=M, pinv_iterations=6,
              residual=True, dropout=0.0)
    rng = np.random.default_rng(505)
    x = rng.normal(size=(2, 505, 256)).astype(np.float32)
    cot = rng.normal(size=(2, 505, 256)).astype(np.float32)
    jmod = JNystrom(**kw, use_pallas=True, pallas_interpret=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True)["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01, params)

    def loss(p, x_):
        return jnp.sum(jmod.apply({"params": p}, x_, deterministic=True) * jnp.asarray(cot))

    want_out = jax.jit(functools.partial(jmod.apply, deterministic=True))(
        {"params": params}, jnp.asarray(x))
    want_gp, want_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = NystromAttention(**kw)
    load_flax_params(port, params)
    tx = torch.from_numpy(x).requires_grad_(True)
    with mock.patch.object(nystrom, "deform_attention_trainable",
                           wraps=nystrom.deform_attention_trainable) as chains:
        out = port(tx)
    assert chains.call_count == 2
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), **TOL)
    want = flatten_params(np_tree(want_gp))
    got = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(port).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("bg,n,j", [(2, 128, 700), (2, 700, 128), (3, 100, 37)])
def test_plain_dh32_forward_and_vjp_match_pallas_interpret(bg, n, j):
    """The dh = 32 form (f32, no bias, span or dropout) at the shapes whose
    key segments, row tiles and key tails the card test below holds the
    kernels to: the port's forward and VJP (their plain versions, on CPU
    tensors) against the Pallas kernels in interpret mode and ``jax.vjp``;
    the forward within 1e-5, each gradient within 1e-4 of its max."""
    rng = np.random.default_rng(bg * 10000 + n * 10 + j)
    q = (rng.normal(size=(bg, n, DH)) * DH ** -0.5).astype(np.float32)
    k, v = rng.normal(size=(2, bg, j, DH)).astype(np.float32)
    cot = rng.normal(size=(bg, n, DH)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: j_attention(*a, None, interpret=True),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = deform_attention_trainable(*leaves)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for name, t, w in zip("qkv", leaves, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"d{name}")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,j", [(128, 700), (700, 128), (100, 37), (128, 2560), (2560, 128)])
def test_cuda_dh32_kernels_match_plain(n, j):
    """The f32 dh = 32 forward and backward at chain-3-like, chain-1-like and
    ragged shapes and at CMTA's chains, against their plain versions."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + j)
    q = torch.randn(4, n, DH, device=dev, generator=g) * DH ** -0.5
    k, v = torch.randn(2, 4, j, DH, device=dev, generator=g)
    dout = torch.randn(4, n, DH, device=dev, generator=g)
    torch.testing.assert_close(deform_attention_fwd(q, k, v),
                               deform_attention_fwd_plain(q, k, v), rtol=1e-4, atol=1e-5)
    got = deform_attention_bwd(q, k, v, None, dout)
    want = deform_attention_bwd_plain(q, k, v, None, dout)
    assert got[3] is None
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bias", "span", "dropout"])
def test_cuda_other_dh32_forms_raise(form):
    dev = _cuda()
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    q, k, v = (torch.randn(2, 16, DH, device=dev, dtype=dtype) for _ in range(3))
    bias = torch.zeros(2, 16, 16, device=dev) if form == "bias" else None
    span = (torch.tensor([[0, 16, 0, 16]] * 2, dtype=torch.int32, device=dev)
            if form == "span" else None)
    keep_prob = 0.9 if form == "dropout" else 1.0
    with pytest.raises(ValueError, match="dh=32"):
        deform_attention_fwd(q, k, v, bias, keep_prob, 0, span)
    with pytest.raises(ValueError, match="dh=32"):
        deform_attention_bwd(q, k, v, bias, q, keep_prob, 0, span)


def test_cpu_wrappers_reject_no_dh_and_cuda_wrappers_reject_others():
    """On the CPU every dh takes the plain version; the kernel check admits dh
    64, and dh 32 only in its f32 form, and names any other dh."""
    from sml_tpu_torch.ops.kernels.deform_attn import _check_kernel

    q = torch.zeros(2, 8, DH)
    assert deform_attention_fwd(q, q, q).shape == q.shape
    fake = mock.Mock(dtype=torch.float32, shape=(2, 8, 48), device=torch.device("cuda"))
    with pytest.raises(ValueError, match="not 48"):
        _check_kernel("deform_attention_fwd", fake, None, None, 1.0, ())
    fake.shape = (2, 8, DH)
    _check_kernel("deform_attention_fwd", fake, None, None, 1.0, ())
    with pytest.raises(ValueError, match="dh=32"):
        _check_kernel("deform_attention_fwd", fake, None, None, 0.9, ())
    fake.dtype = torch.bfloat16
    with pytest.raises(ValueError, match="dh=32"):
        _check_kernel("deform_attention_fwd", fake, None, None, 1.0, ())
