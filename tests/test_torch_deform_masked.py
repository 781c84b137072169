"""The port's masked and non-square 2-D deformpathomic bags against the JAX
package, on the same weights (a JAX init bridged into the port), f32, at the
repo's parity tolerance (TOL, 1e-4): the masked forward with garbage under
the mask, a full mask against none, a non-square bag padded inside the model
against the same bag padded outside, non-square fixdims, bucketed train steps
and one masked train step's gradients.  JAX runs its XLA route
(``use_pallas=False``); the port its kernels' plain versions.  Mirrors
``tests/test_deform_masking.py``."""

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
from sml_tpu.train import steps as j_steps
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net, define_optimizer
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_grad_step, make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0)
OUT_KEYS = ("logits", "logits_tumor", "logits_immune", "features", "vec_tumor",
            "vec_immune", "vgrid_tumor", "vgrid_immune", "omic_tumor")
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _models(fixdim=64):
    """(JAX model, params moved off the init by 0.02, port model in eval mode)."""
    jcfg = JConfig(**{**SMALL, "fixdim": fixdim}, use_pallas=False)
    jmodel = j_define_net(jcfg)
    batch = next(iter(JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size)))
    batch.pop("sample_mask")
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batch)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, variables["params"])
    model = define_net(Config(**{**SMALL, "fixdim": fixdim}), CPU, seed=0)
    load_flax_params(model, params)
    return jmodel, params, model


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 64)).astype(np.float32),
            rng.normal(size=(b, 59)).astype(np.float32),
            rng.normal(size=(b, 361)).astype(np.float32))


def _both(x_path, x_t, x_i, mask=None, fixdim=64):
    """(JAX outputs, port outputs) of one eval forward, as numpy."""
    jmodel, params, model = _models(fixdim)
    jm = None if mask is None else jnp.asarray(mask)
    want = jmodel.apply({"params": params}, jnp.asarray(x_path), jnp.asarray(x_t),
                        jnp.asarray(x_i), deterministic=True, mask=jm)
    with torch.inference_mode():
        got = model(torch.from_numpy(x_path), torch.from_numpy(x_t), torch.from_numpy(x_i),
                    mask=None if mask is None else torch.from_numpy(mask))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_close(got, want, keys=OUT_KEYS, **tol):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


def _bag_mask(b, n, sizes):
    mask = np.zeros((b, n), bool)
    for i, m in enumerate(sizes):
        mask[i, :m] = True
    return mask


def test_masked_forward_matches_jax_with_garbage_under_the_mask():
    x_path, x_t, x_i = _inputs(0, 3, 64)
    mask = _bag_mask(3, 64, (40, 64, 17))
    garbage = x_path.copy()
    garbage[~mask] = 1e3 * np.random.default_rng(1).normal(size=(int((~mask).sum()), 64))
    want, got = _both(x_path * mask[..., None], x_t, x_i, mask)
    _assert_close(got, want)
    _, got_garbage = _both(garbage, x_t, x_i, mask)
    _assert_close(got_garbage, got, rtol=1e-5, atol=1e-5)


def test_full_mask_equals_no_mask():
    x_path, x_t, x_i = _inputs(2, 3, 64)
    want, got = _both(x_path, x_t, x_i)
    _assert_close(got, want)
    _, got_full = _both(x_path, x_t, x_i, np.ones((3, 64), bool))
    _assert_close(got_full, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_real,side", [(60, 8), (50, 8), (99, 10)])
def test_non_square_bag_pads_inside_as_outside(n_real, side):
    """A bag of n_real tokens (no square) equals the same bag zero-padded to
    side x side with a mask, and each equals JAX."""
    n = side * side
    x_path, x_t, x_i = _inputs(3, 3, n_real)
    want, got = _both(x_path, x_t, x_i, fixdim=n_real)
    _assert_close(got, want)
    padded = np.zeros((3, n, 64), np.float32)
    padded[:, :n_real] = x_path
    _, got_ext = _both(padded, x_t, x_i, _bag_mask(3, n, (n_real,) * 3), fixdim=n_real)
    _assert_close(got_ext, got, rtol=1e-5, atol=1e-5)


def test_masked_bag_with_garbage_on_a_non_square_bucket():
    """A 60-token bucket (padded to 64 inside) holding bags of 60, 33 and 9
    tokens, garbage under the mask: equal to JAX and to the zeroed bags."""
    x_path, x_t, x_i = _inputs(4, 3, 60)
    mask = _bag_mask(3, 60, (60, 33, 9))
    clean = x_path * mask[..., None]
    want, got = _both(clean, x_t, x_i, mask, fixdim=60)
    _assert_close(got, want)
    _, got_garbage = _both(np.where(mask[..., None], x_path, 1e3), x_t, x_i, mask, fixdim=60)
    _assert_close(got_garbage, got, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _bucketed(fixdim):
    """(JAX config, model, params + 0.02, train batches with masks)."""
    jcfg = JConfig(**{**SMALL, "fixdim": fixdim}, variable_bags=True, use_pallas=False)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    assert all("mask" in b for b in batches)
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batches[0])
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, variables["params"])
    return jcfg, jmodel, params, batches


@pytest.mark.parametrize("fixdim", [64, 60])
def test_masked_train_step_gradients_match_jax(fixdim):
    """One train step on variable bags (masks from the loader; 60 pads to 64
    inside): loss terms and every gradient after the gradient modulation."""
    jcfg, jmodel, params, batches = _bucketed(fixdim)
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    assert batches[0]["mask"].sum(axis=1).min() < fixdim

    def loss_fn(p):
        out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, batch, jax.random.PRNGKey(0),
                                  train=True)
        total, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
        return total, (out, aux)

    (loss, (out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, j_steps.modulate_classifier_grads(
        jcfg, grads, params, out, batch["labels"])))
    cfg = Config(**{**SMALL, "fixdim": fixdim}, variable_bags=True)
    model = define_net(cfg, CPU, seed=0, train=True)
    load_flax_params(model, params)
    got = make_grad_step(cfg, model)(batch_to_device(cfg, batches[0], CPU), None)
    assert set(got) == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
    for k in aux:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(aux[k]), err_msg=k, **TOL)
    grads_t = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads_t[k], want[k], err_msg=k, **TOL)


def test_bucketed_train_steps_have_finite_decreasing_loss():
    """As ``tests/test_deform_masking.py``: variable bags bucketed to fixdim 60
    (padded to 64 inside) with masks, 3 epochs of train steps at dropout 0.1."""
    cfg = Config(mode="deformpathomic", dataset="synthetic", synthetic_size=16, fixdim=60,
                 batch_size=4, variable_bags=True, input_path_dim=64, path_dim=32,
                 mmhid=32)
    batches = list(Loader(build_datasets(cfg, "Train"), cfg.batch_size, shuffle=True,
                          drop_last=True))
    sizes = np.concatenate([b["mask"].sum(axis=1) for b in batches])
    assert sizes.min() < sizes.max(), "bags should vary in size"
    model = define_net(cfg, CPU, train=True)
    optimizer, scheduler = define_optimizer(cfg, model, len(batches))
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(0, CPU))
    step = make_train_step(cfg, model)
    losses = []
    for _ in range(3):
        for batch in batches:
            batch = {k: v for k, v in batch.items() if k != "sample_mask"}
            losses.append(float(step(state, batch_to_device(cfg, batch, CPU))["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-len(batches):]) < np.mean(losses[:len(batches)])
