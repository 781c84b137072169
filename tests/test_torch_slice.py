"""The port's deformpathomic serving slice against the JAX package, on the same
weights (a JAX init bridged into the port), f32, at the repo's parity tolerance
(1e-4): the model forward, the eval step with a padded tail row, and the
inference CLI's metrics."""

import ast
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.train.evaluate import evaluate as j_evaluate
from sml_tpu.train.steps import make_eval_step as j_make_eval_step
from sml_tpu_torch import inference
from sml_tpu_torch.bridge import flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_eval_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, batch_size=3, use_pallas=False)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _setup(task_type):
    """(JAX config, JAX model, variables, Test batches) with perturbed biases so
    every bridged leaf carries information."""
    jcfg = JConfig(**SMALL, task_type=task_type)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size))
    init_batch = {k: v for k, v in batches[0].items() if k != "sample_mask"}
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), init_batch)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (0.02 if "bias" in str(p[-1]) else 0.0),
        variables["params"])
    return jcfg, jmodel, {"params": params}, batches


def _port_model(task_type, params):
    model = define_net(Config(**SMALL, task_type=task_type), CPU, seed=0)
    load_flax_params(model, params)
    return model


@pytest.mark.parametrize("task_type", ["diag2021", "survival"])
def test_deformpathomic_forward_matches_jax(task_type):
    jcfg, jmodel, variables, batches = _setup(task_type)
    batch = batches[0]
    want = jmodel.apply(variables, **j_model_inputs(jcfg, batch), deterministic=True)
    model = _port_model(task_type, variables["params"])
    with torch.inference_mode():
        got = model(**{k: torch.from_numpy(batch[k])
                       for k in ("x_path", "x_omic_tumor", "x_omic_immune")})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("task_type", ["diag2021", "survival"])
def test_eval_step_matches_jax_with_padded_tail(task_type):
    jcfg, jmodel, variables, batches = _setup(task_type)
    tail = batches[-1]
    assert tail["sample_mask"].min() == 0.0       # 8 Test samples in batches of 3
    j_step = j_make_eval_step(jcfg, jmodel)
    cfg = Config(**SMALL, task_type=task_type)
    step = make_eval_step(cfg, _port_model(task_type, variables["params"]))
    for batch in (batches[0], tail):
        want = j_step(variables, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(batch_to_device(cfg, batch, CPU))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k,
                                       **TOL)


@pytest.mark.parametrize("task_type", ["diag2021", "survival"])
def test_inference_cli_matches_jax_evaluate(task_type, tmp_path, capsys):
    jcfg, jmodel, variables, _ = _setup(task_type)
    weights = tmp_path / "params.npz"
    np.savez(weights, **flatten_params(variables["params"]))
    want = j_evaluate(jcfg, j_make_eval_step(jcfg, jmodel), variables,
                      JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size))
    argv = [f"--{k}={v}" for k, v in SMALL.items()]
    assert inference.main(argv + [f"--task_type={task_type}", f"--weights={weights}",
                                  "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("test metrics: ")][-1]
    got = ast.literal_eval(line[len("test metrics: "):])
    assert set(got) == set(want)      # survival: loss, cindex; else the 7 metrics + loss
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_seeded_init_is_deterministic_and_cuda_needs_a_card():
    cfg = Config(**SMALL)
    a, b = define_net(cfg, CPU), define_net(cfg, CPU)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.omic_net_tumor.encoder1.weight
    assert w.abs().max() <= 2.0 / np.sqrt(w.shape[1]) / 0.8796 + 1e-6   # truncated
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            define_net(cfg, "cuda")


def _init_apply(module, *args, **kwargs):
    """JAX init (params + 0.03 so biases are non-zero) and apply -> (params, out)."""
    variables = module.init(jax.random.PRNGKey(5), *args, **kwargs)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.03, variables["params"])
    return params, module.apply({"params": params}, *args, **kwargs)


def test_maxnet_fusion_and_pooler_match_jax():
    from sml_tpu.models.maxnet import MaxNet as JMaxNet
    from sml_tpu.ops.fusion import FusionNet as JFusionNet
    from sml_tpu.ops.pooling import Pooler as JPooler
    from sml_tpu_torch.models.maxnet import MaxNet
    from sml_tpu_torch.ops.fusion import FusionNet
    from sml_tpu_torch.ops.pooling import Pooler

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 59)).astype(np.float32)
    params, want = _init_apply(JMaxNet(input_dim=59, omic_dim=16, label_dim=4),
                               jnp.asarray(x), deterministic=True)
    net = MaxNet(59, 16, 0.1, 4).eval()
    load_flax_params(net, params)
    got = net(torch.from_numpy(x))
    for k in ("features", "logits"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **TOL)

    gene = rng.normal(size=(3, 10, 8)).astype(np.float32)
    image = rng.normal(size=(3, 5)).astype(np.float32)
    params, want = _init_apply(JFusionNet(6), jnp.asarray(gene), jnp.asarray(image))
    fusion = FusionNet(8, 5, 6)
    load_flax_params(fusion, params)
    got = fusion(torch.from_numpy(gene), torch.from_numpy(image))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    hidden = rng.normal(size=(3, 10, 6)).astype(np.float32)
    mask = (rng.uniform(size=(3, 10)) < 0.7).astype(np.float32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        params, want = _init_apply(JPooler(6), jnp.asarray(hidden), mask=jm)
        pooler = Pooler(6)
        load_flax_params(pooler, params)
        got = pooler(torch.from_numpy(hidden), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["group", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_batch_similarity_loss_matches_jax(layout, masked):
    from sml_tpu.train import losses as jlosses
    from sml_tpu_torch.train import losses

    rng = np.random.default_rng(6)
    omic = rng.normal(size=(4, 16)).astype(np.float32)
    vgrid = rng.normal(size=(4, 8, 3, 3, 2)).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    want = jlosses.batch_similarity_loss(
        jnp.asarray(omic), jnp.asarray(vgrid),
        sample_mask=None if mask is None else jnp.asarray(mask), layout=layout)
    got = losses.batch_similarity_loss(
        torch.from_numpy(omic), torch.from_numpy(vgrid),
        sample_mask=None if mask is None else torch.from_numpy(mask), layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_task_losses_and_cindex_match_jax():
    from sml_tpu.train import losses as jlosses
    from sml_tpu.train.metrics import cindex as j_cindex
    from sml_tpu_torch.train import losses
    from sml_tpu_torch.train.metrics import cindex

    rng = np.random.default_rng(8)
    b = 7
    labels = np.zeros((b, 12), np.float32)
    labels[:, 5] = rng.integers(0, 4, b)
    labels[:, 8] = rng.integers(0, 4, b)
    labels[:, 9] = rng.integers(0, 2, b)
    labels[:, 11] = rng.choice([30.0, 200.0, 450.0, 900.0], b)      # tied times
    logits = rng.normal(size=(b, 4)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    for task in ("diag2021", "survival"):
        for train in (True, False):
            want = jlosses.task_loss(jnp.asarray(logits), jnp.asarray(labels), task,
                                     train=train, sample_mask=jnp.asarray(mask))
            got = losses.task_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   task, train=train, sample_mask=torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    risk = np.round(rng.normal(size=b), 1)                           # tied risks
    assert cindex(risk, labels[:, 9], labels[:, 11]) == j_cindex(risk, labels[:, 9],
                                                                 labels[:, 11])


def test_alpha_dropout_keeps_zero_mean_and_unit_variance():
    from sml_tpu_torch.ops.snn import alpha_dropout

    g = torch.Generator().manual_seed(0)
    x = torch.randn(400_000, generator=g)
    y = alpha_dropout(x, 0.25, training=True, generator=g)
    assert abs(y.mean().item()) < 0.01 and abs(y.std().item() - 1.0) < 0.01
    _, counts = torch.unique(y, return_counts=True)   # dropped units share one value
    assert counts.max().item() / y.numel() == pytest.approx(0.25, abs=0.01)
    assert alpha_dropout(x, 0.25, training=False) is x
