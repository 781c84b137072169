"""The port's TransMIL path (``mode: path``, ``path_arch: transmil``) against the
JAX package on the same weights, f32: the weight bridge, the train step's loss
and every gradient (fused route on fixed and bucketed bags), two Adam steps,
the variable-bag synthetic data and the bucketed loader (bit-identical), and
the two CLIs on the CPU.  TransLayer's attention dropout (0.1) is held at 0
on both sides, on the JAX side by a test-side patch of
``sml_tpu.models.mil.TransLayer``.
"""

import ast
import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sml_tpu.models.mil as j_mil
from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import BucketedLoader as JBucketedLoader
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import define_optimizer as j_define_optimizer
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.ops.nystrom import _fused_chains_supported
from sml_tpu.train import steps as j_steps
from sml_tpu.train.evaluate import evaluate as j_evaluate
from sml_tpu.train.state import TrainState as JTrainState
from sml_tpu_torch import inference
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import _leaf_map, export_flax_params, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import BucketedLoader, build_datasets
from sml_tpu_torch.models.factory import define_net, define_optimizer
from sml_tpu_torch.models.mil import TransMIL
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_grad_step, make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
PATH = dict(dataset="synthetic", mode="path", path_arch="transmil", input_path_dim=24,
            path_dim=16, batch_size=2, synthetic_size=8)
# square bags of 529 (+ cls = 530 tokens, n_pad 640 at 128 landmarks) or buckets of
# 400 / 529 patches (n_pad 512 / 640): hidden 256 gives 8 heads of 32, which the JAX
# gate admits in f32, so both sides run the fused chains
FIXED = dict(PATH, fixdim=529)
BUCKETED = dict(PATH, fixdim=529, variable_bags=True, bucket_sizes="400,529",
                synthetic_size=12)


@pytest.fixture
def no_translayer_dropout(monkeypatch):
    monkeypatch.setattr(j_mil, "TransLayer", functools.partial(j_mil.TransLayer,
                                                               dropout=0.0))


def _batches(flags):
    jcfg = JConfig(**flags)
    loader_cls = JBucketedLoader if flags.get("variable_bags") else JLoader
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batches = list(loader_cls(j_build_datasets(jcfg, "Train"), jcfg.batch_size,
                                  shuffle=True, drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    return jcfg, batches


@functools.lru_cache(maxsize=None)
def _jax_setup(hidden, fused):
    """(JAX TransMIL, params with every leaf moved off its init by 0.01)."""
    jmodel = j_mil.TransMIL(label_dim=4, path_dim=16, hidden_dim=hidden, use_pallas=fused,
                            pallas_interpret=fused)
    x = jnp.zeros((1, 529, PATH["input_path_dim"]), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(7), x, deterministic=True)["params"]
    return jmodel, jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01, params)


def _port(flags, params, hidden):
    cfg = Config(**flags)
    model = TransMIL(cfg.label_dim, cfg.path_dim, cfg.input_path_dim, hidden_dim=hidden)
    load_flax_params(model, params)
    for layer in (model.layer1, model.layer2):
        layer.attn.dropout = 0.0
    return cfg, model.train()


def test_bridge_round_trips_the_transmil_tree():
    _, params = _jax_setup(256, True)
    model = TransMIL(4, 16, PATH["input_path_dim"], hidden_dim=256)
    load_flax_params(model, params)
    flat = flatten_params(params)
    assert {"cls_token", "layer1/attn/res_conv_kernel", "pos_layer/proj2/kernel"} <= set(flat)
    exported = flatten_params(export_flax_params(model))
    assert exported.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)


@pytest.mark.parametrize("task_type,flags", [("diag2021", FIXED), ("survival", BUCKETED)],
                         ids=["diag2021-fixed", "survival-bucketed"])
def test_train_step_gradients_match_jax(task_type, flags, no_translayer_dropout):
    jcfg, batches = _batches(dict(flags, task_type=task_type))
    for b in batches:
        n_pad = -(-(b["x_path"].shape[1] + 1) // 128) * 128
        assert _fused_chains_supported(n_pad, 128, 32, jnp.float32, has_span="mask" in b)
    jmodel, params = _jax_setup(256, True)

    @jax.jit
    def grads_fn(p, batch):
        def loss_fn(p_):
            out, _ = j_steps._forward(jcfg, jmodel, {"params": p_}, batch,
                                      jax.random.PRNGKey(0), train=True)
            return j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    cfg, model = _port(dict(flags, task_type=task_type), params, 256)
    grad_step = make_grad_step(cfg, model)
    batch = batches[0]
    (loss, aux), want = grads_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = grad_step(batch_to_device(cfg, batch, CPU), DropoutRNG.from_seed(0, CPU))
    assert set(got) == {"loss", "loss3"} == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want))
    grads = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], err_msg=k, **TOL)


def test_two_adam_steps_match_jax(no_translayer_dropout):
    """hidden 64 (8 heads of 8, 32 landmarks: the XLA route on both sides)."""
    jcfg, batches = _batches(FIXED)
    jmodel, params = _jax_setup(64, False)
    tx = j_define_optimizer(jcfg, len(batches))
    jstate = JTrainState.create({"params": params}, tx, jax.random.PRNGKey(1))
    j_step = jax.jit(j_steps.make_train_step(jcfg, jmodel, tx, jit=False))
    cfg, model = _port(FIXED, params, 64)
    optimizer, scheduler = define_optimizer(cfg, model, len(batches))
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(0, CPU))
    step = make_train_step(cfg, model)
    for batch in batches[:2]:
        jstate, jm = j_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, batch_to_device(cfg, batch, CPU))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), **TOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = flatten_params(export_flax_params(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


VAR = dict(dataset="synthetic", fixdim=64, input_path_dim=8, synthetic_size=24,
           variable_bags=True, bucket_sizes="16,36,64")


@pytest.mark.parametrize("phase", ["Train", "Test"])
def test_variable_bags_match_jax(phase):
    jds, ds = j_build_datasets(JConfig(**VAR), phase), build_datasets(Config(**VAR), phase)
    np.testing.assert_array_equal(ds.bag_sizes, jds.bag_sizes)
    assert [ds.bucket_of(i) for i in range(len(ds))] == [jds.bucket_of(i)
                                                          for i in range(len(jds))]
    assert len({ds.bucket_of(i) for i in range(len(ds))}) >= 2
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a.keys() == b.keys() and "mask" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        assert a["mask"].sum() == min(ds.bag_sizes[i], a["x_path"].shape[0])


@pytest.mark.parametrize("train", [True, False])
def test_bucketed_loader_matches_jax_for_two_epochs(train):
    kw = dict(shuffle=True, drop_last=True, seed=3) if train else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jloader = JBucketedLoader(j_build_datasets(JConfig(**VAR), "Train"), 4, **kw)
        loader = BucketedLoader(build_datasets(Config(**VAR), "Train"), 4, **kw)
        assert len(loader) == len(jloader)
        orders = []
        for epoch in range(2):
            jloader.set_epoch(epoch)
            loader.set_epoch(epoch)
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) == len(loader)
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert len({x.shape[0] for x in a["x_path"]}) == 1    # one bucket
            orders.append([a["labels"].tolist() for a in got])
    assert (orders[0] != orders[1]) == train         # a new order each train epoch


SMALL = dict(dataset="synthetic", mode="path", path_arch="transmil", fixdim=64,
             synthetic_size=16, input_path_dim=32, path_dim=16, batch_size=3)


@pytest.mark.parametrize("bucketed", [False, True])
def test_inference_cli_matches_jax_evaluate(bucketed, tmp_path, capsys):
    """Full width (hidden 512): bags of 64 pad to 256 tokens, under 4 x 256
    landmarks, so both sides take the XLA route on the CPU."""
    flags = dict(SMALL, **(dict(variable_bags=True, bucket_sizes="36,64") if bucketed
                           else {}))
    jcfg = JConfig(**flags)
    jmodel = j_define_net(jcfg)
    jloader = (JBucketedLoader if bucketed else JLoader)(j_build_datasets(jcfg, "Test"),
                                                         jcfg.batch_size)
    init = next(iter(jloader))
    init.pop("sample_mask")
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(2), init)
    weights = tmp_path / "params.npz"
    np.savez(weights, **flatten_params(variables["params"]))
    want = j_evaluate(jcfg, j_steps.make_eval_step(jcfg, jmodel), variables, jloader)
    argv = [f"--{k}={v}" for k, v in flags.items()]
    assert inference.main(argv + [f"--weights={weights}", "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("test metrics: ")][-1]
    got = ast.literal_eval(line[len("test metrics: "):])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_train_cli_two_bucketed_epochs(tmp_path, capsys):
    flags = [f"--{k}={v}" for k, v in SMALL.items()] + [
        "--variable_bags=true", "--bucket_sizes=36,64", "--task_type=survival"]
    ckpt = tmp_path / "ck"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert train_main.main(flags + ["--epochs=2", f"--checkpoints={ckpt}",
                                        "--device=cpu"]) == 0
    out = capsys.readouterr().out
    trains = re.findall(r"^epoch \d/2 train=(\{.*\})$", out, re.M)
    evals = re.findall(r"^epoch \d/2 val=(\{.*?\}) test=(\{.*?\})", out, re.M)
    assert len(trains) == len(evals) == 2
    for line in trains:
        metrics = ast.literal_eval(line)
        assert set(metrics) == {"loss", "loss3"} and np.isfinite(metrics["loss"])
    for val, test in evals:
        for m in (ast.literal_eval(val), ast.literal_eval(test)):
            assert set(m) == {"loss", "cindex"} and all(np.isfinite(list(m.values())))
    assert (ckpt / "best_modal.npz").exists()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "interval_masked"])
def test_nystrom_return_attn_matches_jax(masked):
    """``return_attn`` gives JAX's (out, attn), attn = attn1 @ pinv @ attn3 of
    shape (b, h, n_pad, n_pad), on the formed chains at a shape whose default
    route is fused; its out is the fused route's."""
    from unittest import mock

    from sml_tpu.ops.nystrom import NystromAttention as JNystrom
    from sml_tpu_torch.ops import nystrom

    kw = dict(dim=64, dim_head=32, heads=2, num_landmarks=16, dropout=0.0)
    b, n, n_pad = 2, 200, 208
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, n, kw["dim"])).astype(np.float32)
    idx = np.arange(n)[None, :]
    mask = (idx >= np.array([[0], [20]])) & (idx < np.array([[150], [200]])) if masked \
        else None
    assert _fused_chains_supported(n_pad, 16, 32, jnp.float32, has_span=masked)
    jmod = JNystrom(**kw, use_pallas=False)      # return_attn keeps JAX off Pallas
    jmask = None if mask is None else jnp.asarray(mask)
    params = jax.eval_shape(functools.partial(jmod.init, deterministic=True),
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), params)
    want_out, want_attn = jax.jit(functools.partial(
        jmod.apply, deterministic=True, return_attn=True))({"params": params},
                                                          jnp.asarray(x), mask=jmask)
    port = nystrom.NystromAttention(**kw)
    load_flax_params(port, params)
    tx, tmask = torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)
    with torch.no_grad(), mock.patch.object(nystrom, "deform_attention_trainable",
                                            wraps=nystrom.deform_attention_trainable) as chains:
        out, attn = port(tx, mask=tmask, return_attn=True)
        assert chains.call_count == 0
        fused = port(tx, mask=tmask)
        assert chains.call_count == 2
    assert attn.shape == want_attn.shape == (b, kw["heads"], n_pad, n_pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **TOL)
    np.testing.assert_allclose(out.numpy(), fused.numpy(), **TOL)
