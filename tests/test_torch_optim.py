"""The port's optimizers, plateau controller, ``init_type`` re-initialisation
and ``remat`` against the JAX package (``use_pallas=False``), f32, at the
repo's parity tolerance (1e-4) unless stated: two train steps of SGD, Adagrad
and plateau-driven Adam from one bridged init; ``ReduceLROnPlateau`` step by
step; the leaves that each ``init_type`` redraws, zeroes and keeps, and the
laws it draws them from; and a rematerialised deformpathomic train step
against the one without remat (bit for bit, dropout on) and against JAX's
remat step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models import factory as j_factory
from sml_tpu.train import steps as j_steps
from sml_tpu.train.state import TrainState as JTrainState
from sml_tpu_torch.bridge import (STATS, _leaf_map, export_flax_batch_stats,
                                  export_flax_params, flatten_params, load_flax_params,
                                  unflatten_params)
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import (ReduceLROnPlateau, _fans, define_net,
                                          define_optimizer, reinit_params,
                                          set_learning_rate)
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_grad_step, make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0)
CPU = torch.device("cpu")


def _batches(jcfg):
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    return batches


@functools.lru_cache(maxsize=None)
def _omic_setup():
    """(JAX config, model, params moved off their init by 0.02, train batches)
    of the omic mode."""
    jcfg = JConfig(**SMALL, mode="omic", use_pallas=False)
    jmodel = j_factory.define_net(jcfg)
    batches = _batches(jcfg)
    variables = j_factory.init_model(jcfg, jmodel, jax.random.PRNGKey(11), batches[0])
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, variables["params"])
    return jmodel, params, batches


@pytest.mark.parametrize("optimizer,policy", [("sgd", "cosine"), ("adagrad", "cosine"),
                                              ("adam", "plateau")])
def test_two_steps_match_jax(optimizer, policy):
    """Two updates from one bridged init; under plateau both sides take a new
    learning rate between them, which the port's next ``scheduler.step()``
    must keep."""
    jmodel, params, batches = _omic_setup()
    kw = dict(SMALL, mode="omic", optimizer=optimizer, lr_policy=policy, epochs=3)
    jcfg = JConfig(**kw, use_pallas=False)
    spe = len(batches)
    tx = j_factory.define_optimizer(jcfg, spe)
    jstate = JTrainState.create({"params": params}, tx, jax.random.PRNGKey(1))
    j_step = jax.jit(j_steps.make_train_step(jcfg, jmodel, tx, jit=False))
    cfg = Config(**kw)
    model = define_net(cfg, CPU, seed=0, train=True)
    load_flax_params(model, params)
    opt, scheduler = define_optimizer(cfg, model, spe)
    state = TrainState(model, opt, scheduler, DropoutRNG.from_seed(0, CPU))
    step = make_train_step(cfg, model)
    for i, batch in enumerate(batches[:2]):
        if i == 1 and policy == "plateau":
            jstate = j_factory.set_learning_rate(jstate, 2e-4)
            set_learning_rate(state, 2e-4)
        jstate, jm = j_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, batch_to_device(cfg, batch, CPU))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), **TOL)
    if policy == "plateau":
        assert opt.param_groups[0]["lr"] == pytest.approx(2e-4, rel=1e-12)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = flatten_params(export_flax_params(model))
    moved = flatten_params(params)
    for k in want:
        assert not np.allclose(want[k], moved[k], rtol=0, atol=1e-7), k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_plateau_matches_jax():
    metrics = [1.0, 0.995, 0.98, 0.99, 0.97, 0.975, 0.972, 0.971, 0.9705, 0.97, 0.969,
               0.8, 0.81, 0.805, 0.802, 0.801, 0.8, 0.8, 0.79, 0.8]
    port, jax_ = ReduceLROnPlateau(1e-3), j_factory.ReduceLROnPlateau(1e-3)
    lrs = set()
    for metric in metrics:
        assert port.step(metric) == jax_.step(metric)
        assert (port.lr, port.best, port.num_bad) == (jax_.lr, jax_.best, jax_.num_bad)
        lrs.add(port.lr)
    assert len(lrs) == 3                     # the sequence cut the rate twice


def test_set_learning_rate_survives_scheduler_steps():
    cfg = Config(**SMALL, mode="omic", lr_policy="plateau")
    model = define_net(cfg, CPU, seed=0, train=True)
    opt, scheduler = define_optimizer(cfg, model, 4)
    state = TrainState(model, opt, scheduler, DropoutRNG.from_seed(0, CPU))
    for lr in (cfg.lr, 2e-4, 4e-5):
        set_learning_rate(state, lr)
        for _ in range(5):
            assert all(g["lr"] == pytest.approx(lr, rel=1e-12) for g in opt.param_groups)
            opt.step()
            scheduler.step()


def _classify(before, after):
    return {k: ("zeroed" if not after[k].any() else
                "kept" if np.array_equal(after[k], before[k]) else "redrawn") for k in before}


def _law_variance(init_type, shape, gain):
    fan_in, fan_out = _fans(shape)
    return {"normal": gain ** 2, "xavier": gain ** 2 * 2.0 / (fan_in + fan_out),
            "kaiming": 2.0 / fan_in}[init_type]


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_type_matches_jax(init_type):
    """On the deformpathomic pofusion model (Dense and grouped Conv kernels,
    the Bilinear weight, LayerNorm and BatchNorm scales and biases, the CPB's
    raw leaves), every leaf moved off its init by 0.02, JAX's
    ``_reinit_kernels`` on the flax tree and the port's ``reinit_params``
    must redraw, zero and keep the same leaves."""
    gain = 0.02
    cfg = Config(**SMALL, fusion_type="pofusion", omic_dim=32, init_type=init_type)
    model = define_net(cfg, CPU, seed=1)
    before = flatten_params(export_flax_params(model))
    before = {k: v + np.float32(0.02) for k, v in before.items()}
    j_after = flatten_params(jax.tree_util.tree_map(np.asarray, j_factory._reinit_kernels(
        {"params": unflatten_params(before)}, init_type, gain,
        jax.random.PRNGKey(5))["params"]))
    load_flax_params(model, {**before, **{STATS + k: v for k, v in flatten_params(
        export_flax_batch_stats(model)).items()}})
    reinit_params(model, init_type, gain, torch.Generator().manual_seed(5))
    after = flatten_params(export_flax_params(model))
    plan, j_plan = _classify(before, after), _classify(before, j_after)
    assert plan == j_plan
    assert {"redrawn", "zeroed", "kept"} == set(plan.values())
    assert {k for k, v in plan.items() if v == "zeroed"} == {
        k for k in before if k.endswith("/bias")}
    assert plan["fusion/linear_z1/weight"] == "redrawn"              # Bilinear, 3-D
    assert plan["fusion/bn1/scale"] == "kept"
    assert plan["pathomic_net_tumor/norm/scale"] == "kept"

    # define_net draws the same leaves from the same laws, biases exactly zero
    drawn = flatten_params(export_flax_params(define_net(cfg, CPU)))
    checked = 0
    for key, value in drawn.items():
        if plan[key] == "zeroed":
            assert not value.any(), key
        if plan[key] != "redrawn":
            continue
        w = value.astype(np.float64)
        if init_type == "orthogonal":
            m = w.reshape(-1, w.shape[-1])
            gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
            np.testing.assert_allclose(gram / gain ** 2, np.eye(len(gram)), rtol=0, atol=1e-5,
                                       err_msg=key)
            checked += 1
        elif w.size >= 4096:
            law = _law_variance(init_type, w.shape, gain)
            for sample in (w, j_after[key].astype(np.float64)):
                assert abs(sample.var() / law - 1.0) < 0.1, (key, sample.var(), law)
            checked += 1
    assert checked >= 3


@functools.lru_cache(maxsize=None)
def _deform_batches():
    return _batches(JConfig(**SMALL, use_pallas=False))


def _remat_steps(remat, n_steps, dropout_rate=0.1):
    """(per-step metrics and gradients, final params, generator states) of
    ``n_steps`` deformpathomic train steps from one init and one seed."""
    cfg = Config(**dict(SMALL, dropout_rate=dropout_rate), remat=remat)
    model = define_net(cfg, CPU, seed=0, train=True)
    opt, scheduler = define_optimizer(cfg, model, 4)
    state = TrainState(model, opt, scheduler, DropoutRNG.from_seed(9, CPU))
    grad_step = make_grad_step(cfg, model)
    steps = []
    for batch in _deform_batches()[:n_steps]:
        m = grad_step(batch_to_device(cfg, batch, CPU), state.rng)
        steps.append((m, {n: p.grad.clone() for n, p in model.named_parameters()}))
        opt.step()
        scheduler.step()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return steps, params, state.rng.get_state()


@pytest.mark.parametrize("n_steps", [1, 2])
def test_remat_is_bit_for_bit_the_step_without(n_steps):
    plain, params, rng = _remat_steps(False, n_steps)
    remat, r_params, r_rng = _remat_steps(True, n_steps)
    for (m, g), (rm, rg) in zip(plain, remat):
        for k in m:
            assert torch.equal(m[k], rm[k]), k
        for n in g:
            assert torch.equal(g[n], rg[n]), n
    for n in params:
        assert torch.equal(params[n], r_params[n]), n
    for k in rng:
        assert torch.equal(rng[k], r_rng[k]), k


def test_remat_matches_jax_remat():
    """One gradient from one init: the port's, bridged into the JAX model."""
    batch = _deform_batches()[0]
    jcfg = JConfig(**SMALL, remat=True, use_pallas=False)
    jmodel = j_factory.define_net(jcfg)
    cfg = Config(**SMALL, remat=True, gradient_modulate=False)
    model = define_net(cfg, CPU, train=True)
    params = export_flax_params(model)

    @jax.jit
    def value_and_grad(p, jbatch):
        def loss_fn(p):
            out, _ = j_steps._forward(jcfg, jmodel, {"params": p}, jbatch,
                                      jax.random.PRNGKey(0), train=True)
            return j_steps.compute_mode_loss(jcfg, out, jbatch["labels"], train=True)[0]

        return jax.value_and_grad(loss_fn)(p)

    loss, grads = value_and_grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
    m = make_grad_step(cfg, model)(batch_to_device(cfg, batch, CPU), None)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(loss), **TOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, grads))
    got = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
