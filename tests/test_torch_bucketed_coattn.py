"""MCAT and CMTA on bucketed bags (``--variable_bags true --bucket_sizes
36,64``) against the JAX package, f32, at the repo's parity tolerance (TOL,
1e-4): the loaders' batches, then at each bucket size the outputs and one
train step's loss terms and every gradient from one bridged init.
Neither mode is in ``MASKABLE_MODES``, so both packages run the zero-padded
bags unmasked.  Dropout is held at 0 on both sides for the train step (see
``test_torch_mcat.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import BucketedLoader as JBucketedLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.train import steps as j_steps
from sml_tpu_torch.bridge import _leaf_map, export_flax_params, flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import BucketedLoader, build_datasets
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_grad_step
from test_torch_mcat import CPU, SMALL, TOL, no_jax_dropout, np_tree, perturbed, port

BUCKETS = (36, 64)
FLAGS = dict(SMALL, task_type="survival", variable_bags=True,
             bucket_sizes=",".join(map(str, BUCKETS)), synthetic_size=24)
MODES = ("mcat", "cmta")

__all__ = ["no_jax_dropout"]      # the fixture, used by name


@functools.lru_cache(maxsize=None)
def _setup(mode):
    """(flags, JAX model, perturbed variables, {bucket: first train batch}),
    the port's bucketed batches checked equal to JAX's on the way."""
    flags = dict(FLAGS, mode=mode)
    jcfg = JConfig(**flags)
    args = dict(shuffle=True, drop_last=True, seed=jcfg.seed)
    want = list(JBucketedLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, **args))
    got = list(BucketedLoader(build_datasets(Config(**flags), "Train"), jcfg.batch_size,
                              **args))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batches = {}
    for b in want:
        b = dict(b)
        b.pop("sample_mask")
        batches.setdefault(b["x_path"].shape[1], b)
    assert sorted(batches) == list(BUCKETS)
    assert "mask" in batches[BUCKETS[0]]
    # the port's init, exported as the flax tree (the bridge is held against
    # JAX's init in test_torch_mcat.py / test_torch_cmta.py): no JAX init to compile
    variables = {"params": export_flax_params(define_net(Config(**flags), CPU, seed=3))}
    return flags, j_define_net(jcfg), perturbed(variables), batches


@functools.lru_cache(maxsize=None)
def _jax_steps(mode):
    """{bucket: (loss, aux, outputs, gradients)} of one JAX train step at each
    bucket size, dropout off (the caller patches it), in one jitted program:
    one compile for both shapes."""
    flags, jmodel, variables, batches = _setup(mode)
    jcfg = JConfig(**flags)

    def step(params, batch):
        def loss_fn(p):
            out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, batch,
                                      jax.random.PRNGKey(0), train=True)
            loss, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
            return loss, (aux, out)

        (loss, (aux, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, aux, out, grads

    both = jax.jit(lambda params, bs: {b: step(params, bs[b]) for b in BUCKETS})
    inputs = {b: {k: jnp.asarray(v) for k, v in batches[b].items()} for b in BUCKETS}
    return np_tree(both(variables["params"], inputs))


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("mode", MODES)
def test_bucketed_bags_match_jax(mode, bucket, no_jax_dropout):
    """The outputs, the loss terms and every gradient of one train step.  With
    dropout at 0 and concat fusion (no BatchNorm) the train-mode outputs are
    the eval-mode ones, so one JAX program gives both, held against the port's
    eval-mode forward and its train step."""
    flags, _, variables, batches = _setup(mode)
    loss, aux, want_out, grads = _jax_steps(mode)[bucket]
    cfg, model = port(flags, variables, train=False)
    inputs = model_inputs(cfg, batch_to_device(cfg, batches[bucket], CPU))
    assert "mask" not in inputs and inputs["x_path"].shape[1] == bucket
    with torch.inference_mode():
        out = model(**inputs)
    assert set(out) == set(want_out)
    for k in want_out:
        np.testing.assert_allclose(out[k].numpy(), want_out[k], err_msg=k, **TOL)

    cfg, model = port(flags, variables, train=True)
    got = make_grad_step(cfg, model)(batch_to_device(cfg, batches[bucket], CPU), None)
    assert set(got) == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), loss, **TOL)
    for k in aux:
        np.testing.assert_allclose(got[k].numpy(), aux[k], err_msg=k, **TOL)
    want = flatten_params(grads)
    grads_t = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads_t[k], want[k], err_msg=k, **TOL)
