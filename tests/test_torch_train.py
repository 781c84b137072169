"""The port's deformpathomic training path against the JAX package on the same
weights (a JAX init bridged into the port), f32, dropout off, at the repo's
parity tolerance (1e-4): the train loss terms, every parameter gradient after
gradient modulation (both styles, on a batch where it fires), every parameter
after two Adam steps, the LR schedule, the train loader, the classification
metrics and the train CLI's best-on-val weights."""

import ast
import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import define_optimizer as j_define_optimizer
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.models.factory import make_lr_schedule as j_make_lr_schedule
from sml_tpu.train import steps as j_steps
from sml_tpu.train.state import TrainState as JTrainState
from sml_tpu_torch import inference
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import _leaf_map, export_flax_params, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net, define_optimizer, make_lr_schedule
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_grad_step, make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _setup(task_type):
    """(JAX config, JAX model, params with every leaf moved off its init by
    0.02, train batches).  No leaf is zero, so the coupled weight decay keeps
    Adam's first steps away from gradients that are zero up to rounding."""
    jcfg = JConfig(**SMALL, task_type=task_type, use_pallas=False)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batches[0])
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + 0.02, variables["params"])
    return jcfg, jmodel, params, batches


def _port(task_type, params, **overrides):
    cfg = Config(**{**SMALL, **overrides}, task_type=task_type)
    model = define_net(cfg, CPU, seed=0, train=True)
    load_flax_params(model, params)
    return cfg, model


@functools.lru_cache(maxsize=None)
def _jax_grads(task_type, style):
    """Jitted (params, batch) -> (loss, aux, raw grads, modulated grads) of the
    JAX train step's body."""
    jcfg, jmodel, _, _ = _setup(task_type)
    jcfg = JConfig(**{**vars(jcfg), "modulation_style": style})

    def grads_fn(params, batch):
        def loss_fn(p):
            out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, batch,
                                      jax.random.PRNGKey(0), train=True)
            total, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
            return total, (out, aux)

        (loss, (out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        modulated = j_steps.modulate_classifier_grads(jcfg, grads, params, out,
                                                      batch["labels"])
        return loss, aux, grads, modulated

    return jax.jit(grads_fn)


@pytest.mark.parametrize("style", ["reference", "orthogonal"])
@pytest.mark.parametrize("task_type", ["diag2021", "survival"])
def test_modulated_gradients_match_jax(task_type, style):
    _, _, params, batches = _setup(task_type)
    cfg, model = _port(task_type, params, modulation_style=style)
    grad_step = make_grad_step(cfg, model)
    fired = False
    for batch in batches:
        loss, aux, raw, want = _jax_grads(task_type, style)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        got = grad_step(batch_to_device(cfg, batch, CPU), None)
        assert set(got) == {"loss", "loss3", "batch_sim_loss"} == {"loss", *aux}
        np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
        for k in aux:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(aux[k]), err_msg=k, **TOL)
        want = flatten_params(jax.tree_util.tree_map(np.asarray, want))
        grads = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
        assert grads.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(grads[k], want[k], err_msg=k, **TOL)
        raw_kernel = np.asarray(raw["classifier"]["kernel"])
        fired = not np.allclose(want["classifier/kernel"], raw_kernel, rtol=0, atol=1e-7)
        if fired:
            break
    assert fired, "gradient modulation did not fire on any train batch"


@pytest.mark.parametrize("task_type", ["diag2021", "survival"])
def test_two_adam_steps_match_jax(task_type):
    jcfg, jmodel, params, batches = _setup(task_type)
    spe = len(batches)
    tx = j_define_optimizer(jcfg, spe)
    jstate = JTrainState.create({"params": params}, tx, jax.random.PRNGKey(1))
    j_step = jax.jit(j_steps.make_train_step(jcfg, jmodel, tx, jit=False))
    cfg, model = _port(task_type, params)
    optimizer, scheduler = define_optimizer(cfg, model, spe)
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(0, CPU))
    step = make_train_step(cfg, model)
    for batch in batches[:2]:
        jstate, jm = j_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, batch_to_device(cfg, batch, CPU))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), **TOL)
    assert state.step == 2
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = flatten_params(export_flax_params(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("policy", ["cosine", "none"])
def test_lr_schedule_matches_jax(policy):
    jcfg = JConfig(**SMALL, epochs=3, lr_policy=policy)
    cfg = Config(**SMALL, epochs=3, lr_policy=policy)
    spe = 4
    want = j_make_lr_schedule(jcfg, spe)
    got = make_lr_schedule(cfg, spe)
    for k in range(3 * spe + 2):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6, err_msg=str(k))
    model = define_net(cfg, CPU, seed=0, train=True)
    optimizer, scheduler = define_optimizer(cfg, model, spe)
    for k in range(3 * spe):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(got(k), rel=1e-12)
        optimizer.step()
        scheduler.step()
    with pytest.raises(NotImplementedError):
        make_lr_schedule(Config(**SMALL, lr_policy="step"), spe)


def test_train_loader_matches_jax_for_two_epochs():
    jcfg, cfg = JConfig(**SMALL), Config(**SMALL)
    jloader = JLoader(j_build_datasets(jcfg, "Train"), 3, shuffle=True, drop_last=True,
                      seed=jcfg.seed)
    loader = Loader(build_datasets(cfg, "Train"), 3, shuffle=True, drop_last=True,
                    seed=cfg.seed)
    assert len(loader) == len(jloader) == 16 // 3
    firsts = []
    for epoch in range(2):
        jloader.set_epoch(epoch)
        loader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        firsts.append(got[0]["labels"])
    assert not np.array_equal(*firsts)                # a new order each epoch


@pytest.mark.parametrize("case", ["all_classes", "missing_class", "ties", "binary"])
def test_compute_avg_metrics_matches_sklearn(case):
    from sml_tpu.train.metrics import compute_avg_metrics as j_metrics
    from sml_tpu_torch.train.metrics import compute_avg_metrics

    rng = np.random.default_rng(len(case))
    n = 23
    classes = {"missing_class": 3, "binary": 2}.get(case, 4)
    gt = rng.integers(0, classes, n).astype(np.float32)
    gt[:classes] = np.arange(classes)
    logits = rng.normal(size=(n, 4))
    if case == "ties":
        logits = np.round(logits)
    act = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    with contextlib.redirect_stdout(io.StringIO()):
        want = j_metrics(gt, act)
        got = compute_avg_metrics(gt, act)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_batch_cindex_matches_jax():
    from sml_tpu.train.metrics import batch_cindex as j_batch_cindex
    from sml_tpu_torch.train.metrics import batch_cindex

    rng = np.random.default_rng(3)
    risk = np.round(rng.normal(size=9), 1).astype(np.float32)
    censor = (rng.uniform(size=9) < 0.4).astype(np.float32)
    time = rng.choice([10.0, 50.0, 90.0, 300.0], 9).astype(np.float32)
    for c in (censor, np.ones_like(censor)):
        want = j_batch_cindex(jnp.asarray(risk), jnp.asarray(c), jnp.asarray(time))
        got = batch_cindex(*(torch.from_numpy(a) for a in (risk, c, time)))
        assert bool(got[1]) == bool(want[1])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)


def test_train_cli_writes_best_weights_that_inference_reproduces(tmp_path, capsys):
    flags = [f"--{k}={v}" for k, v in {**SMALL, "dropout_rate": 0.1}.items()]
    ckpt = tmp_path / "ck"
    assert train_main.main(flags + ["--epochs=2", f"--checkpoints={ckpt}",
                                    "--device=cpu"]) == 0
    out = capsys.readouterr().out
    epochs = re.findall(r"^epoch (\d)/2 val=(\{.*?\}) test=(\{.*?\})", out, re.M)
    trains = re.findall(r"^epoch \d/2 train=(\{.*\})$", out, re.M)
    assert len(epochs) == len(trains) == 2
    for line in trains:
        assert set(ast.literal_eval(line)) == {"loss", "loss3", "batch_sim_loss"}
    best = ast.literal_eval(out.split("best (val): ")[-1].strip())
    best_test = ast.literal_eval(epochs[best["epoch"]][2])
    assert set(best_test) == {"loss", "acc", "f1", "auc", "bac", "sens", "spec", "prec"}
    assert inference.main(flags + [f"--weights={ckpt / 'best_modal.npz'}",
                                   "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("test metrics: ")][-1]
    got = ast.literal_eval(line[len("test metrics: "):])
    for k in best_test:
        np.testing.assert_allclose(got[k], best_test[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_training_dropout_needs_explicit_generators():
    cfg = Config(**{**SMALL, "dropout_rate": 0.1})
    model = define_net(cfg, CPU, seed=0, train=True)
    batch = next(iter(Loader(build_datasets(cfg, "Train"), 3)))
    inputs = {k: torch.from_numpy(batch[k])
              for k in ("x_path", "x_omic_tumor", "x_omic_immune")}
    with pytest.raises(ValueError, match="generator|DropoutRNG"):
        model(**inputs)
    a = model(**inputs, rng=DropoutRNG.from_seed(5, CPU))["logits"]
    b = model(**inputs, rng=DropoutRNG.from_seed(5, CPU))["logits"]
    c = model(**inputs, rng=DropoutRNG.from_seed(6, CPU))["logits"]
    assert torch.equal(a, b) and not torch.equal(a, c)
