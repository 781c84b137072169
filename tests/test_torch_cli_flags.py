"""The port's CLI flags that used to be accepted and ignored: each now gives
the JAX package's run or raises.

- ``--batchloss_grad_scale ddp``: the deformpathomic batch-similarity term
  keeps its value and its gradient is scaled by 1/w, against the JAX train
  step at ``num_devices`` 4 on one bridged init (f32, dropout off, 1e-4);
  w = 1 at ``num_devices`` 0; an unknown value raises.
- ``--reload`` and ``--eval_every_iters``: a one-epoch omic run of the train
  CLI from a written ``best_modal.npz`` logs the JAX train loop's
  ``metrics.jsonl`` records (the mid-epoch Test / Val records with
  ``--eval_every_iters 2``) from the same weights, at 1e-4.
- ``--workers``: ``Loader`` and ``BucketedLoader`` give the same batches in
  the same order at workers 0 and 2, and the JAX loaders' at workers 2; the
  train loader takes the flag, the eval loaders prefetch nothing (as in JAX).
"""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import BucketedLoader as JBucketedLoader
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.train import steps as j_steps
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import _leaf_map, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.loop import setup
from sml_tpu_torch.train.steps import make_grad_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=8, input_path_dim=64,
             path_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX model, params moved off their init by 0.02, one train batch)."""
    jcfg = JConfig(**SMALL, use_pallas=False)
    jmodel = j_define_net(jcfg)
    batch = next(iter(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size,
                              shuffle=True, drop_last=True, seed=jcfg.seed)))
    batch.pop("sample_mask")
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batch)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, variables["params"])
    return jmodel, params, batch


def _jax_step(**flags):
    """(loss, aux, modulated grads) of the JAX train step's body."""
    jmodel, params, batch = _setup()
    jcfg = JConfig(**SMALL, use_pallas=False, **flags)

    def loss_fn(p, jb):
        out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, jb, jax.random.PRNGKey(0),
                                  train=True)
        total, aux = j_steps.compute_mode_loss(jcfg, out, jb["labels"], train=True)
        return total, (out, aux)

    @jax.jit
    def step(params, jb):
        (loss, (out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, jb)
        return loss, aux, j_steps.modulate_classifier_grads(jcfg, grads, params, out,
                                                            jb["labels"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, aux, grads = step(params, jb)
    return (np.asarray(loss), {k: np.asarray(v) for k, v in aux.items()},
            flatten_params(jax.tree_util.tree_map(np.asarray, grads)))


def _port_step(**flags):
    """(metrics, {flax name: gradient}) of one port grad step on the bridged init."""
    _, params, batch = _setup()
    cfg = Config(**SMALL, **flags)
    model = define_net(cfg, CPU, seed=0, train=True)
    load_flax_params(model, params)
    metrics = make_grad_step(cfg, model)(batch_to_device(cfg, batch, CPU), None)
    grads = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    return metrics, grads


def test_ddp_batchloss_grad_scale_matches_jax_at_four_devices():
    flags = dict(batchloss_grad_scale="ddp", num_devices=4)
    loss, aux, want = _jax_step(**flags)
    got, grads = _port_step(**flags)
    np.testing.assert_allclose(got["loss"].numpy(), loss, **TOL)
    for k in aux:
        np.testing.assert_allclose(got[k].numpy(), aux[k], err_msg=k, **TOL)
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], err_msg=k, **TOL)
    # the value is the exact one; only the batch-similarity gradient is scaled
    exact, exact_grads = _port_step()
    for k in ("loss", "loss3", "batch_sim_loss"):
        np.testing.assert_allclose(got[k].numpy(), exact[k].numpy(), rtol=1e-6, err_msg=k)
    moved = [k for k in want if not np.allclose(grads[k], exact_grads[k], rtol=0, atol=1e-6)]
    assert moved, "ddp at 4 devices left every gradient as the exact scale's"


def test_ddp_at_num_devices_zero_is_one_card():
    got, grads = _port_step(batchloss_grad_scale="ddp", num_devices=0)
    exact, exact_grads = _port_step(batchloss_grad_scale="exact", num_devices=0)
    for k in got:
        assert torch.equal(got[k], exact[k]), k
    for k in grads:
        np.testing.assert_array_equal(grads[k], exact_grads[k], err_msg=k)


def test_unknown_batchloss_grad_scale_raises():
    with pytest.raises(ValueError, match="batchloss_grad_scale"):
        Config(**SMALL, batchloss_grad_scale="mean")


def test_train_loader_takes_workers():
    train_loader, val_loader, test_loader = setup(Config(**SMALL, workers=2), CPU)[3]
    assert train_loader.workers == 2
    assert val_loader.workers == test_loader.workers == 0


@pytest.mark.parametrize("flag", [["--reload", "true"], ["--eval_every_iters", "2"]])
def test_reload_and_eval_every_iters_match_jax_loop(flag, tmp_path):
    """``--reload`` and ``--eval_every_iters`` give the JAX loop's run: both
    sides reload the same weights (the JAX init moved by 0.02) and log the
    same records."""
    from sml_tpu.train import checkpoint as j_ckpt
    from sml_tpu.train import loop as j_loop
    from sml_tpu.utils.logging import MetricLogger as JMetricLogger

    kw = dict(dataset="synthetic", fixdim=64, synthetic_size=24, batch_size=8, epochs=1,
              mode="omic", dropout_rate=0.0, reload=True,
              eval_every_iters=int(flag[1]) if flag[0] == "--eval_every_iters" else 0)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JConfig(**kw, checkpoints=str(jdir), use_pallas=False)
    weights = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02,
                                     j_loop.setup(JConfig(**dict(kw, reload=False),
                                                          use_pallas=False))[2].params)
    j_ckpt.save_weights(str(jdir / "best_modal"), {"params": weights})
    pdir.mkdir()
    np.savez(pdir / "best_modal.npz", **flatten_params(weights))
    j_loop.train(jcfg, JMetricLogger(out_dir=str(jdir)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert train_main.main([f"--{k}={v}" for k, v in kw.items()]
                               + ["--device=cpu", f"--checkpoints={pdir}"]) == 0
    records = [[json.loads(line) for line in open(d / "metrics.jsonl")] for d in (pdir, jdir)]
    assert [r.keys() for r in records[0]] == [r.keys() for r in records[1]]
    mid = [r for r in records[0] if "test/loss" in r and "epoch" not in r]
    assert len(mid) == (1 if kw["eval_every_iters"] else 0)
    for got, want in zip(*records):
        for k in want:
            if k not in ("t", "elapsed_sec"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


VAR = dict(dataset="synthetic", fixdim=64, input_path_dim=8, synthetic_size=24,
           variable_bags=True, bucket_sizes="16,36,64")


@pytest.mark.parametrize("bucketed", [False, True])
def test_workers_give_the_same_batches_as_jax(bucketed):
    flags = VAR if bucketed else dict(SMALL, synthetic_size=16)
    port_cls, jax_cls = (BucketedLoader, JBucketedLoader) if bucketed else (Loader, JLoader)
    kw = dict(shuffle=True, drop_last=True, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ds, jds = build_datasets(Config(**flags), "Train"), j_build_datasets(
            JConfig(**flags), "Train")
        loaders = [port_cls(ds, 4, **kw, workers=w) for w in (0, 2)]
        jloader = jax_cls(jds, 4, **kw, workers=2)
        for epoch in range(2):
            for loader in (*loaders, jloader):
                loader.set_epoch(epoch)
            want = list(jloader)
            assert len(want) == len(jloader) > 1
            for loader in loaders:
                got = list(loader)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert a.keys() == b.keys()
                    for k in a:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_workers_raise_a_producer_error_in_the_consumer():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("sample 4")
            return {"x": np.full(2, i)}

    with pytest.raises(KeyError, match="sample 4"):
        list(Loader(Broken(), 2, workers=2))
