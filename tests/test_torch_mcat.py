"""The port's MCAT (``mode: mcat``) against the JAX package on the same weights,
f32, at the repo's parity tolerance (TOL, 1e-4): the weight bridge in both
``coattn_fusion``s, the forward and eval step, one train step's loss and every
gradient in survival and diag2021, and the two CLIs on the CPU.  MCAT's
dropout rates are fixed in both packages (0.25); for the train step they are
held at 0 on both sides, on the JAX side by a test-side patch of flax's
``Dropout`` and the package's ``AlphaDropout``.
"""

import ast
import functools
import re

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sml_tpu.ops.snn as j_snn
from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.ops.attention import RawMultiheadAttention as JRawMultiheadAttention
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.train import steps as j_steps
from sml_tpu.train.evaluate import evaluate as j_evaluate
from sml_tpu_torch import inference
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import (_leaf_map, _stats_map, export_flax_batch_stats,
                                  export_flax_params, flatten_params, load_flax_params,
                                  unflatten_params)
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.ops.attention import RawMultiheadAttention
from sml_tpu_torch.ops.common import Dropout
from sml_tpu_torch.ops.fusion import BilinearFusion
from sml_tpu_torch.ops.nystrom import NystromAttention
from sml_tpu_torch.ops.snn import AlphaDropout
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_eval_step, make_grad_step

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
SMALL = dict(dataset="synthetic", mode="mcat", fixdim=64, input_path_dim=24,
             synthetic_size=16, batch_size=4)
# flags that change the loss but not the model, its weights or the batches
LOSS_FLAGS = ("task_type", "survival_loss")
FUSIONS = ["concat", "bilinear"]


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax ``Dropout`` and the JAX package's ``AlphaDropout`` as the identity."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(j_snn.AlphaDropout, "__call__",
                        lambda self, x, deterministic=False: x)


def no_port_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Every dropout rate of a port model set to 0."""
    for m in model.modules():
        if isinstance(m, (Dropout, AlphaDropout)):
            m.rate = 0.0
        elif isinstance(m, NystromAttention):
            m.dropout = 0.0
        elif isinstance(m, BilinearFusion):
            m.dropout_rate = 0.0
    return model


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables):
    """Every parameter moved off its init by 0.01 (cls tokens off ~0, biases
    off 0); running means moved by 0.1 and variances scaled by 1.5."""
    out = {"params": jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.01,
                                            variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: np.asarray(v) * 1.5 if str(p[-1]) == "['var']"
            else np.asarray(v) + 0.1, variables["batch_stats"])
    return out


def train_batches(flags):
    jcfg = JConfig(**flags)
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    return jcfg, batches


@functools.lru_cache(maxsize=None)
def _jax_model(model_items):
    jcfg, batches = train_batches(dict(model_items))
    jmodel = j_define_net(jcfg)
    init = jax.jit(functools.partial(jmodel.init, deterministic=True))
    p_rng, d_rng = jax.random.split(jax.random.PRNGKey(3))
    variables = np_tree(init({"params": p_rng, "dropout": d_rng},
                             **j_model_inputs(jcfg, batches[0])))
    return jmodel, perturbed(variables), batches, jax.jit(
        functools.partial(jmodel.apply, deterministic=True))


def jax_setup(flags):
    """(JAX config, model, perturbed variables, train batches) of ``flags``;
    the model and weights are shared by flags that differ in the loss only."""
    jmodel, variables, batches, _ = _jax_model(_model_items(flags))
    return JConfig(**flags), jmodel, variables, batches


def _model_items(flags):
    return tuple((k, v) for k, v in flags.items() if k not in LOSS_FLAGS)


def jax_eval(flags, variables, batch):
    """The JAX model's eval-mode outputs (one jitted forward per model) and
    its eval step's quantities from them, as ``make_eval_step`` takes them for
    mcat and cmta: risk = -sum(S), and the loss over ``sample_mask``."""
    jcfg = JConfig(**flags)
    apply = _jax_model(_model_items(flags))[3]
    batch = dict(batch)
    sample_mask = batch.pop("sample_mask", None)
    out = apply(variables, **j_model_inputs(jcfg, batch))
    loss, _ = j_steps.compute_mode_loss(jcfg, out, jnp.asarray(batch["labels"]),
                                        train=False, sample_mask=sample_mask)
    return out, {"risk": -jnp.sum(out["S"], axis=1), "loss": loss}


def port(flags, variables, train):
    cfg = Config(**flags)
    model = define_net(cfg, CPU, seed=0, train=train)
    load_flax_params(model, variables)
    return cfg, no_port_dropout(model)


def check_bridge(flags):
    """The JAX variables load leaf by leaf, export back equal, and a missing
    or an extra leaf raises."""
    _, _, variables, _ = jax_setup(flags)
    model = define_net(Config(**flags), CPU, seed=0)
    load_flax_params(model, variables)
    flat = flatten_params(variables["params"])
    exported = flatten_params(export_flax_params(model))
    assert exported.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    if "batch_stats" in variables:
        want = flatten_params(variables["batch_stats"])
        got = flatten_params(export_flax_batch_stats(model))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    some_leaf = sorted(flat)[0]
    for change in ("missing", "extra"):
        bad = dict(flat)
        if change == "missing":
            bad.pop(some_leaf)
        else:
            bad["classifier/extra"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="missing|unused"):
            load_flax_params(model, {"params": unflatten_params(bad),
                                     **({"batch_stats": variables["batch_stats"]}
                                        if "batch_stats" in variables else {})})
    return flat


def check_forward_and_eval(flags, keys):
    _, _, variables, batches = jax_setup(flags)
    batch = batches[0]
    want, want_step = jax_eval(flags, variables, batch)
    cfg, model = port(flags, variables, train=False)
    with torch.inference_mode():
        got = model(**model_inputs(cfg, batch_to_device(cfg, batch, CPU)))
    assert set(got) == set(want) == set(keys)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    want = want_step
    got = make_eval_step(cfg, model)(batch_to_device(cfg, batch, CPU))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def check_train_step(flags):
    """One train step (dropout off on both sides): the loss terms, every
    parameter gradient and, with a BatchNorm, the new running averages."""
    jcfg, jmodel, variables, batches = jax_setup(flags)
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params):
        v = {"params": params, **({"batch_stats": variables["batch_stats"]}
                                  if "batch_stats" in variables else {})}
        out, new_bs = j_steps._forward(jcfg, jmodel, v, batch, jax.random.PRNGKey(0),
                                       train=True)
        total, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
        return total, (aux, new_bs)

    (loss, (aux, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    cfg, model = port(flags, variables, train=True)
    got = make_grad_step(cfg, model)(batch_to_device(cfg, batches[0], CPU), None)
    assert set(got) == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
    for k in aux:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(aux[k]), err_msg=k, **TOL)
    want = flatten_params(np_tree(grads))
    grads_t = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads_t[k], want[k], err_msg=k, **TOL)
    stats = _stats_map(model)
    assert bool(stats) == (new_bs is not None)
    if new_bs is not None:
        want = flatten_params(np_tree(new_bs))
        assert stats.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(stats[k].numpy(), want[k], err_msg=k, **TOL)


def check_inference_cli(flags, tmp_path, capsys):
    """``inference.main --device cpu`` on JAX-initialised weights against the
    JAX package's ``evaluate`` over the Test split."""
    jcfg, _, variables, _ = jax_setup(flags)
    jloader = JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size)
    weights = tmp_path / "params.npz"
    np.savez(weights, **flatten_params(variables["params"]),
             **flatten_params(variables.get("batch_stats", {}), "batch_stats/"))
    want = j_evaluate(jcfg, lambda v, b: jax_eval(flags, v, b)[1], variables, jloader)
    argv = [f"--{k}={v}" for k, v in flags.items()]
    assert inference.main(argv + [f"--weights={weights}", "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("test metrics: ")][-1]
    got = ast.literal_eval(line[len("test metrics: "):])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def check_train_cli(flags, tmp_path, capsys, train_keys):
    ckpt = tmp_path / "ck"
    argv = [f"--{k}={v}" for k, v in flags.items()]
    assert train_main.main(argv + ["--epochs=2", f"--checkpoints={ckpt}",
                                   "--device=cpu"]) == 0
    out = capsys.readouterr().out
    trains = re.findall(r"^epoch \d/2 train=(\{.*\})$", out, re.M)
    evals = re.findall(r"^epoch \d/2 val=(\{.*?\}) test=(\{.*?\})", out, re.M)
    assert len(trains) == len(evals) == 2
    for line in trains:
        metrics = ast.literal_eval(line)
        assert set(metrics) == set(train_keys) and np.isfinite(metrics["loss"])
    for val, test in evals:
        for m in (ast.literal_eval(val), ast.literal_eval(test)):
            assert "cindex" in m and all(np.isfinite(list(m.values())))
    assert (ckpt / "best_modal.npz").exists()


MCAT_OUT = ("logits", "hazards", "S", "coattn")


@pytest.mark.parametrize("masked", [False, True])
def test_raw_multihead_attention_matches_jax(masked):
    """RawMultiheadAttention (4 heads of 4) alone: the output, the raw logits
    and the gradients of the query, key, value and every weight; with
    ``key_padding_mask``, each row masks some of its 7 keys (never all)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, n, 16)).astype(np.float32) for n in (3, 7, 7))
    cot_out = rng.normal(size=(2, 3, 16)).astype(np.float32)
    cot_raw = rng.normal(size=(2, 4, 3, 7)).astype(np.float32)
    mask = np.array([[0, 1, 0, 0, 1, 1, 0], [1, 0, 0, 0, 0, 0, 1]], bool) if masked else None
    jmod = JRawMultiheadAttention(16, 4)
    params = jmod.init(jax.random.PRNGKey(1), q, k, v)["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01, params)

    def loss(p, q_, k_, v_):
        out, raw = jmod.apply({"params": p}, q_, k_, v_, key_padding_mask=mask)
        return jnp.sum(out * cot_out) + jnp.sum(raw * cot_raw), (out, raw)

    (_, (want_out, want_raw)), want_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(params, q, k, v)
    model = RawMultiheadAttention(16, 4)
    load_flax_params(model, {"params": params})
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, raw = model(*inputs, key_padding_mask=None if mask is None
                     else torch.from_numpy(mask))
    (torch.sum(out * torch.from_numpy(cot_out))
     + torch.sum(raw * torch.from_numpy(cot_raw))).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(want_raw), **TOL)
    for name, t, g in zip("qkv", inputs, want_grads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **TOL)
    want = flatten_params(np_tree(want_grads[0]))
    got = {name: to_flax(p.grad.numpy()) for name, (p, _, to_flax) in _leaf_map(model).items()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_bridge_round_trips_the_mcat_tree(fusion):
    flat = check_bridge(dict(SMALL, coattn_fusion=fusion))
    assert {"sig_net3/SNNBlock_1/Dense_0/kernel", "coattn/q_proj/kernel",
            "path_transformer/layer1/self_attn/out_proj/bias",
            "omic_attention_head/attention_c/kernel", "omic_rho/kernel"} <= set(flat)
    assert ("mm0/kernel" in flat) == (fusion == "concat")
    assert ("mm/linear_z1/weight" in flat) == (fusion == "bilinear")


@pytest.mark.parametrize("fusion", FUSIONS)
def test_forward_and_eval_step_match_jax(fusion):
    check_forward_and_eval(dict(SMALL, coattn_fusion=fusion, task_type="survival"), MCAT_OUT)


@pytest.mark.parametrize("task_type,fusion", [("survival", "concat"),
                                              ("diag2021", "bilinear")])
def test_train_step_matches_jax(task_type, fusion, no_jax_dropout):
    check_train_step(dict(SMALL, coattn_fusion=fusion, task_type=task_type))


def test_inference_cli_matches_jax_evaluate(tmp_path, capsys):
    check_inference_cli(dict(SMALL, task_type="survival"), tmp_path, capsys)


def test_train_cli_two_epochs(tmp_path, capsys):
    check_train_cli(dict(SMALL, task_type="survival", synthetic_size=12,
                         coattn_fusion="bilinear"), tmp_path, capsys, ("loss", "loss3"))
