"""The port's 1-D deformable path (``attn_dim`` 1) against the JAX package,
on the same weights (a JAX init bridged into the port), f32, at the repo's
parity tolerance (TOL, 1e-4) unless stated: ``grid_sample_1d``, ``CPB1D``
(forward and gradients), ``DeformCrossAttention1D`` and the whole model, with
and without a mask, one train step's gradients, a bf16 forward, and the bf16
coordinates of the JAX module (finding: a bf16 ``arange`` collapses at 2501
queries; the port keeps its coordinates in f32).  JAX runs its XLA route
(``use_pallas=False``); the port its kernels' plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.ops import deformable as jdef
from sml_tpu.ops.grid_sample import grid_sample_1d as j_grid_sample_1d
from sml_tpu.train import steps as j_steps
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.ops import deformable as tdef
from sml_tpu_torch.ops.grid_sample import grid_sample_1d
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_eval_step, make_grad_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0, attn_dim=1,
             return_vgrid=False)
CPU = torch.device("cpu")


def _perturb(params, shift=0.02):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) + shift, params)


def test_grid_sample_1d_matches_jax_and_samples_along_the_sequence():
    rng = np.random.default_rng(0)
    inp = rng.normal(size=(3, 17, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(3, 11)).astype(np.float32)
    want = j_grid_sample_1d(jnp.asarray(inp), jnp.asarray(grid))
    got = grid_sample_1d(torch.from_numpy(inp), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the lift fix: a ramp 0 .. L-1 sampled at position x returns x (the
    # reference's 2-D lift returned the midpoint scaled by the offset)
    length = 17
    ramp = torch.arange(length, dtype=torch.float32)[None, :, None].expand(2, -1, 3)
    pos = torch.tensor([[0.0, 3.25, 8.5, 16.0], [1.0, 2.0, 12.75, 15.5]])
    g = (2.0 * pos + 1.0) / length - 1.0                 # align_corners=False
    np.testing.assert_allclose(grid_sample_1d(ramp, g)[..., 0].numpy(), pos.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("query_chunk", [5, 13])
def test_cpb1d_forward_and_gradients_match_jax(query_chunk):
    """The chunked f32 MLP over 13 queries (chunks of 5, the last one short,
    and one chunk of all 13), and its gradients."""
    b, g, n, j = 2, 4, 13, 6
    rng = np.random.default_rng(1)
    grid_q = np.linspace(-1, 1, n).astype(np.float32)
    grid_kv = rng.uniform(-1.2, 1.2, size=(b * g, j)).astype(np.float32)
    jmod = jdef.CPB1D(8, heads=8, offset_groups=g, query_chunk=query_chunk)
    params = _perturb(jmod.init(jax.random.PRNGKey(2), jnp.asarray(grid_q),
                                jnp.asarray(grid_kv), b)["params"])
    want, vjp = jax.vjp(lambda p, kv: jmod.apply({"params": p}, jnp.asarray(grid_q), kv, b),
                        params, jnp.asarray(grid_kv))
    mod = tdef.CPB1D(8, 8, g, query_chunk=query_chunk)
    load_flax_params(mod, params)
    kv = torch.from_numpy(grid_kv).requires_grad_(True)
    got = mod(torch.from_numpy(grid_q), kv, b)
    assert got.dtype == torch.float32 and got.shape == (b, 8, n, j)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    cot = rng.normal(size=want.shape).astype(np.float32)
    d_params, d_kv = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(kv.grad.numpy(), np.asarray(d_kv), **TOL)
    for name, leaf in flatten_params(jax.tree_util.tree_map(np.asarray, d_params)).items():
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(), leaf, err_msg=name, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_deform_cross_attention_1d_matches_jax(masked):
    b, n, dim = 2, 65, 32
    rng = np.random.default_rng(3)
    x1, x2 = (rng.normal(size=(b, n, dim)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.zeros((b, n), bool)
        mask[0, :50] = mask[1] = True
    jm = None if mask is None else jnp.asarray(mask)
    jmod = jdef.DeformCrossAttention1D(dim=dim, downsample_factor=4, offset_scale=2.0,
                                       offset_kernel_size=6)
    params = _perturb(jmod.init(jax.random.PRNGKey(4), jnp.asarray(x1), jnp.asarray(x2),
                                deterministic=True, mask=jm)["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x1), jnp.asarray(x2),
                      deterministic=True, mask=jm)
    mod = tdef.DeformCrossAttention1D(dim, downsample_factor=4, offset_scale=2.0,
                                      offset_kernel_size=6)
    load_flax_params(mod, params)
    got = mod(torch.from_numpy(x1), torch.from_numpy(x2),
              mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _setup(variable_bags):
    """(JAX config, model, params + 0.02, train batches)."""
    jcfg = JConfig(**SMALL, variable_bags=variable_bags, use_pallas=False)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    assert ("mask" in batches[0]) == variable_bags
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batches[0])
    return jcfg, jmodel, _perturb(variables["params"]), batches


def _port(variable_bags, params, train=False, dtype="float32"):
    cfg = Config(**SMALL, variable_bags=variable_bags, compute_dtype=dtype)
    model = define_net(cfg, CPU, seed=0, train=train)
    load_flax_params(model, params)
    return cfg, model


@pytest.mark.parametrize("variable_bags", [False, True])
def test_attn_dim_1_model_forward_and_eval_step_match_jax(variable_bags):
    jcfg, jmodel, params, batches = _setup(variable_bags)
    batch = batches[0]
    want = jmodel.apply({"params": params}, **j_model_inputs(jcfg, batch), deterministic=True)
    cfg, model = _port(variable_bags, params)
    assert "pooler" not in dict(model.pathomic_net_tumor.named_children())
    with torch.inference_mode():
        got = model(**model_inputs(cfg, batch_to_device(cfg, batch, CPU)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    want = j_steps.make_eval_step(jcfg, jmodel)({"params": params},
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg, model)(batch_to_device(cfg, batch, CPU))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("variable_bags", [False, True])
def test_attn_dim_1_train_step_gradients_match_jax(variable_bags):
    """One train step: the loss terms and every parameter gradient after the
    gradient modulation (cls tokens and CPB1D weights included)."""
    jcfg, jmodel, params, batches = _setup(variable_bags)
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(p):
        out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, batch, jax.random.PRNGKey(0),
                                  train=True)
        total, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
        return total, (out, aux)

    (loss, (out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, j_steps.modulate_classifier_grads(
        jcfg, grads, params, out, batch["labels"])))
    cfg, model = _port(variable_bags, params, train=True)
    got = make_grad_step(cfg, model)(batch_to_device(cfg, batches[0], CPU), None)
    assert set(got) == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
    grads_t = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads_t.keys() == want.keys()
    assert "pathomic_net_tumor/cls_token" in want
    for k in want:
        np.testing.assert_allclose(grads_t[k], want[k], err_msg=k, **TOL)


# bf16 forward against the JAX f32 forward at N = 65 (fixdim 64 + the cls
# token), where a bf16 arange is exact, so both packages' bf16 coordinates are
# the f32 ones: every output within BF16_TOL of the f32 scale of its tensor,
# and no farther than twice the JAX bf16 forward's own distance (plus 1e-3)
BF16_TOL = 3e-2


def test_attn_dim_1_bf16_forward_tracks_jax_f32():
    jcfg, jmodel, params, batches = _setup(False)
    batch = batches[0]
    want = jmodel.apply({"params": params}, **j_model_inputs(jcfg, batch), deterministic=True)
    jcfg16 = JConfig(**SMALL, compute_dtype="bfloat16", use_pallas=False)
    jwant16 = j_define_net(jcfg16).apply({"params": params}, **j_model_inputs(jcfg16, batch),
                                         deterministic=True)
    cfg, model = _port(False, params, dtype="bfloat16")
    with torch.inference_mode():
        got = model(**model_inputs(cfg, batch_to_device(cfg, batch, CPU)))
    for k in ("logits", "logits_tumor", "logits_immune", "features", "vec_tumor"):
        ref = np.asarray(want[k])
        scale = np.abs(ref).max()
        err = np.abs(got[k].float().numpy() - ref).max()
        jerr = np.abs(np.asarray(jwant16[k], np.float32) - ref).max()
        assert err <= BF16_TOL * scale, (k, err, scale)
        assert err <= 2 * jerr + 1e-3 * scale, (k, err, jerr)


def test_jax_bf16_coordinates_collapse_and_the_ports_do_not():
    """At N = 2501 (fixdim 2500 + the cls token) the JAX 1-D module's bf16
    ``jnp.arange(n, dtype=qh.dtype)`` takes 669 distinct values and its query
    coordinates (``seq_scaled``) 345; its 625-point grid (``jnp.arange(nd,
    dtype=offsets.dtype)``) takes 413.  The port's f32 coordinates take 2501
    and 625, in a bf16 model too."""
    n, nd = 2501, 625
    seq = 2.0 * jnp.arange(n, dtype=jnp.bfloat16) / max(n - 1, 1) - 1.0
    assert len(np.unique(np.asarray(jnp.arange(n, dtype=jnp.bfloat16)))) == 669
    assert len(np.unique(np.asarray(seq, np.float32))) == 345
    assert len(np.unique(np.asarray(jnp.arange(nd, dtype=jnp.bfloat16)))) == 413
    assert torch.unique(tdef.normalized_axis(n, CPU)).numel() == n
    # what the port's bf16 1-D module hands CPB1D: f32 coordinates, all distinct
    seen = {}
    mod = tdef.DeformCrossAttention1D(32, offset_scale=2.0, dtype=torch.bfloat16)
    mod.rel_pos_bias.register_forward_hook(
        lambda m, args, out: seen.update(q=args[0], kv=args[1], bias=out))
    x = torch.randn(1, n, 32, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        mod(x, x)
    assert seen["q"].dtype == seen["kv"].dtype == seen["bias"].dtype == torch.float32
    assert torch.unique(seen["q"]).numel() == n and seen["kv"].shape == (4, nd)
