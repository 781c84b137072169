"""The port's fusion blocks and the modes they open (omic, path with ABMIL,
pathomic, pathomic_original, deformpathomic with BilinearFusion) against the
JAX package, on the same weights (a JAX init bridged into the port), f32,
dropout off, at the repo's parity tolerance (TOL, 1e-4): each block's
forward, BatchNorm's running averages after two train-mode steps, each
mode's forward and one train step's loss, gradients and new batch
statistics, and the train CLI's best-on-val weights (BatchNorm statistics
included) read back by the inference CLI."""

import ast
import functools
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
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.train import steps as j_steps
from sml_tpu_torch import inference
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import _leaf_map, _stats_map, flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_eval_step, make_grad_step

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, omic_dim=32, mmhid=32, batch_size=3, dropout_rate=0.0)
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables):
    """Biases moved off their zero init by 0.02; running means moved by 0.1 and
    variances scaled by 1.5, so eval mode reads statistics that are not the
    init's 0 and 1.  The kernels keep their init: shifted by 0.02 each, they
    give BatchNorm inputs whose batch mean is 60x their spread at B = 3, where
    flax's E[x^2] - E[x]^2 cancels and the JAX package's own gradients drift
    from a float64 evaluation of itself."""
    out = {"params": jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (0.02 if "bias" in str(p[-1]) else 0.0),
        variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: np.asarray(v) * 1.5 if str(p[-1]) == "['var']"
            else np.asarray(v) + 0.1, variables["batch_stats"])
    return out


def _init_apply(module, *args, **kwargs):
    variables = module.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                            *args, **kwargs)
    variables = _perturbed(variables)
    return variables, module.apply(variables, *args, **kwargs)


def _vecs(seed, b=3, d1=12, d2=10, d3=None):
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=(b, d)).astype(np.float32) for d in (d1, d2, d3) if d]
    return vs, [jnp.asarray(v) for v in vs], [torch.from_numpy(v) for v in vs]


def test_bilinear_matches_jax():
    from sml_tpu.ops.fusion import Bilinear as JBilinear
    from sml_tpu_torch.ops.common import Bilinear

    _, jv, tv = _vecs(0)
    variables, want = _init_apply(JBilinear(7), *jv)
    layer = Bilinear(12, 10, 7)
    load_flax_params(layer, variables["params"])
    np.testing.assert_allclose(layer(*tv).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("skip,use_bilinear,gates,scales", [
    (0, 1, (1, 1), (1, 1)), (1, 1, (1, 0), (2, 1)), (1, 0, (0, 1), (1, 2)),
    (0, 0, (0, 0), (1, 1))])
def test_bilinear_fusion_eval_matches_jax(skip, use_bilinear, gates, scales):
    """Eval mode: the running averages (moved off 0 and 1) normalize."""
    from sml_tpu.ops.fusion import BilinearFusion as JBilinearFusion
    from sml_tpu_torch.ops.fusion import BilinearFusion

    kw = dict(skip=skip, use_bilinear=use_bilinear, gate1=gates[0], gate2=gates[1],
              dim1=12, dim2=10, scale_dim1=scales[0], scale_dim2=scales[1], mmhid=9,
              dropout_rate=0.25)
    _, jv, tv = _vecs(1)
    variables, want = _init_apply(JBilinearFusion(**kw), *jv, deterministic=True)
    block = BilinearFusion(**kw).eval()
    load_flax_params(block, variables)
    np.testing.assert_allclose(block(*tv).detach().numpy(), np.asarray(want), **TOL)


def test_bilinear_fusion_train_mode_moves_running_stats_as_flax():
    """Two train-mode steps at B = 3 (dropout 0): the outputs and, after each,
    the running mean and var equal flax's.  flax moves the variance by the
    biased batch variance; torch's own BatchNorm1d moves it by the unbiased
    one, 1.5x larger at B = 3, and misses.  The inputs are scaled by 10 and the
    encoders' kernels by 10 so that every feature's batch variance
    moves the running variance by 20x the tolerance or more."""
    from sml_tpu.ops.fusion import BilinearFusion as JBilinearFusion
    from sml_tpu_torch.ops.fusion import BilinearFusion

    kw = dict(skip=1, dim1=12, dim2=10, mmhid=9, dropout_rate=0.0)
    jblock = JBilinearFusion(**kw)
    _, jv, _ = _vecs(2)
    init = jblock.init({"params": jax.random.PRNGKey(5)}, *jv, deterministic=True)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (10.0 if "encoder" in str(p[0]) and "kernel" in str(p[-1])
                                      else 1.0) + (0.02 if "bias" in str(p[-1]) else 0.0),
        init["params"])
    stats = _np_tree(init["batch_stats"])
    block = BilinearFusion(**kw).train()
    load_flax_params(block, {"params": params, "batch_stats": stats})
    seen = []
    block.bn1.register_forward_hook(lambda mod, args, out: seen.append(args[0].detach()))
    for step in range(2):
        vs = [10.0 * v for v in _vecs(10 + step)[0]]
        before = stats
        want, mutated = jblock.apply({"params": params, "batch_stats": stats},
                                     *map(jnp.asarray, vs), deterministic=False,
                                     mutable=["batch_stats"])
        stats = _np_tree(mutated["batch_stats"])
        got = block(*map(torch.from_numpy, vs))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        for name in ("bn1", "bn2"):
            bn = getattr(block, name)
            np.testing.assert_allclose(bn.running_mean.numpy(), stats[name]["mean"],
                                       err_msg=f"{name} step {step}", **TOL)
            np.testing.assert_allclose(bn.running_var.numpy(), stats[name]["var"],
                                       err_msg=f"{name} step {step}", **TOL)
        # torch's own BatchNorm1d, from the same state on the same input
        ref = torch.nn.BatchNorm1d(9, momentum=0.1).train()
        ref.running_mean.copy_(torch.tensor(before["bn1"]["mean"]))
        ref.running_var.copy_(torch.tensor(before["bn1"]["var"]))
        ref(seen[-1].float())
        kept = 0.9 * before["bn1"]["var"]        # both add 0.1 x a batch variance to it
        assert (stats["bn1"]["var"] - kept).min() > 20 * TOL["atol"]
        np.testing.assert_allclose(ref.running_var.numpy() - kept,
                                   1.5 * (stats["bn1"]["var"] - kept), rtol=1e-3)
        assert np.abs(ref.running_var.numpy() - stats["bn1"]["var"]).min() > 10 * TOL["atol"]


def _one_pass_batch_norm(self, x):
    """flax's default train-mode BatchNorm: the variance E[x^2] - E[x]^2,
    clipped at 0 (the running averages left alone)."""
    x = x.float()
    mean = x.mean(dim=0)
    var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


@pytest.mark.parametrize("seed", range(4))
def test_bilinear_fusion_b3_gradients_nearer_float64_than_jax(seed):
    """The port's BatchNorm departs from flax on purpose (ROADMAP.md section
    3): it takes the batch variance in two passes, E[(x - E[x])^2], where
    flax's default E[x^2] - E[x]^2 cancels when a feature's batch mean is far
    above its spread, as at B = 3.  One train-mode step of a BilinearFusion at
    pofusion's small widths (B = 3, biases moved by 0.02 as in _perturbed,
    dropout 0): the f32 gradients of sum(out * r) over every parameter, against
    the JAX package's own block evaluated in float64 (jax x64, nothing of the
    port).  The port lies at least 2x nearer than the JAX package's f32
    gradients (4.5-12.5x on these seeds), and the port's block with flax's
    variance (the control) at least 2x farther than the port (3.7-34x).  The
    port and the JAX package differ here by 2.3e-4 to 1.8e-3, beyond TOL, so
    the train-step parity cases with a BilinearFusion run at B = 8 (MODES)."""
    from unittest import mock

    from sml_tpu.ops.fusion import BilinearFusion as JBilinearFusion
    from sml_tpu_torch.ops.fusion import BatchNorm, BilinearFusion

    kw = dict(skip=1, dim1=32, dim2=32, mmhid=32, dropout_rate=0.0)
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=(3, 32)).astype(np.float32) for _ in range(2)]
    r = rng.normal(size=(3, 32)).astype(np.float32)
    jblock = JBilinearFusion(**kw)
    init = jblock.init({"params": jax.random.PRNGKey(seed)}, *map(jnp.asarray, vs),
                       deterministic=True)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (0.02 if "bias" in str(p[-1]) else 0.0), init["params"])
    stats = _np_tree(init["batch_stats"])

    def jax_grads(dtype):
        cast = lambda tree: jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), tree)
        x = [jnp.asarray(v, dtype) for v in vs]

        def loss(p):
            out, _ = jblock.apply({"params": p, "batch_stats": cast(stats)}, *x,
                                  deterministic=False, mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(r, dtype))
        grads = jax.grad(loss)(cast(params))
        return flatten_params(jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                                     grads))

    want = jax_grads(jnp.float32)
    with jax.enable_x64(True):
        exact = jax_grads(jnp.float64)
    assert all(v.dtype == np.float64 for v in exact.values())

    def port_grads():
        block = BilinearFusion(**kw).train()
        load_flax_params(block, {"params": params, "batch_stats": stats})
        (block(*map(torch.from_numpy, vs)) * torch.from_numpy(r)).sum().backward()
        return {k: to_flax(p.grad.double().numpy())
                for k, (p, _, to_flax) in _leaf_map(block).items()}

    got = port_grads()
    with mock.patch.object(BatchNorm, "forward", _one_pass_batch_norm):
        control = port_grads()
    assert got.keys() == exact.keys() == want.keys() == control.keys()
    dist = lambda g: max(float(np.abs(g[k] - exact[k]).max()) for k in exact)
    assert 2 * dist(got) <= dist(want), (dist(got), dist(want))
    assert 2 * dist(got) <= dist(control), (dist(got), dist(control))


@pytest.mark.parametrize("variant,skip,use_bilinear", [("A", 1, 1), ("B", 0, 1), ("A", 0, 0)])
def test_trilinear_fusion_matches_jax(variant, skip, use_bilinear):
    from sml_tpu.ops.fusion import TrilinearFusion as JTrilinearFusion
    from sml_tpu_torch.ops.fusion import TrilinearFusion

    kw = dict(variant=variant, skip=skip, use_bilinear=use_bilinear, dim1=6, dim2=5,
              dim3=4, mmhid=7, dropout_rate=0.25)
    _, jv, tv = _vecs(3, d1=6, d2=5, d3=4)
    variables, want = _init_apply(JTrilinearFusion(**kw), *jv, deterministic=True)
    block = TrilinearFusion(**kw).eval()
    load_flax_params(block, variables["params"])
    np.testing.assert_allclose(block(*tv).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_abmil_and_gated_abmil_match_jax(masked):
    from sml_tpu.models.mil import ABMIL as JABMIL
    from sml_tpu.models.mil import GatedABMIL as JGatedABMIL
    from sml_tpu_torch.models.mil import ABMIL, GatedABMIL

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((3, 20), bool)
        for i, n in enumerate((20, 13, 5)):
            mask[i, :n] = True
        x[~mask] = 1e3              # garbage under the mask
    jm = None if mask is None else jnp.asarray(mask)
    variables, want = _init_apply(JABMIL(label_dim=4, path_dim=8, input_path_dim=16),
                                  jnp.asarray(x), deterministic=True, mask=jm)
    model = ABMIL(4, 8, 16)
    load_flax_params(model, variables["params"])
    got = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TOL)
    variables, want = _init_apply(JGatedABMIL(label_dim=2, input_path_dim=16),
                                  jnp.asarray(x), deterministic=True)
    model = GatedABMIL(2, 16)
    load_flax_params(model, variables["params"])
    got = model(torch.from_numpy(x))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TOL)


# (mode, fusion_type, extra config): every new mode, each pathomic fusion and
# the deformpathomic fusion variants (pofusion and add go through BilinearFusion).
# The cases with a BilinearFusion run at B = 8: at B = 3 its train-mode
# BatchNorm amplifies f32 rounding, flax's one-pass variance more than the
# port's two-pass one (ROADMAP.md section 3), and the JAX package's own
# gradients lie up to 2.6e-4 (deformpathomic) and 2.4e-4 (pathomic, omic_dim
# 16) from a float64 evaluation, the port's 1.0e-4 and 7.8e-6; at B = 8,
# 4.4e-5 / 2.0e-5 and 1.7e-5 / 2.4e-6 (scripts/fusion_grad_yardstick.py).
# test_bilinear_fusion_b3_gradients_nearer_float64_than_jax holds the B = 3
# block against the JAX package's own float64 evaluation.
B8 = ("batch_size", 8)
MODES = [
    ("omic", "concat", ()),
    ("path", "concat", ()),
    ("path", "concat", (("variable_bags", True),)),
    ("pathomic", "concat", ()),
    ("pathomic", "add", ()),
    ("pathomic", "pofusion", (B8,)),
    ("pathomic", "pofusion", (B8, ("skip", 1), ("path_gate", 0))),
    ("pathomic", "pofusion", (B8, ("omic_dim", 16))),
    ("pathomic_original", "concat", ()),
    ("pathomic_original", "add", ()),
    ("pathomic_original", "pofusion", (B8, ("use_bilinear", 0))),
    ("deformpathomic", "pofusion", (B8,)),
    ("deformpathomic", "add", (B8, ("skip", 1))),
    ("deformpathomic", "pofusion", (B8, ("omic_dim", 16))),
]


def _mode_id(case):
    mode, fusion, extra = case
    return "-".join([mode, fusion] + [f"{k}={v}" for k, v in extra])


@functools.lru_cache(maxsize=None)
def _setup(mode, fusion_type, extra):
    """(JAX config, model, perturbed variables, train batches)."""
    jcfg = JConfig(**{**SMALL, **dict(extra)}, mode=mode, fusion_type=fusion_type,
                   use_pallas=False)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Train"), jcfg.batch_size, shuffle=True,
                           drop_last=True, seed=jcfg.seed))
    for b in batches:
        b.pop("sample_mask")
    variables = j_init_model(jcfg, jmodel, jax.random.PRNGKey(11), batches[0])
    return jcfg, jmodel, _perturbed(variables), batches


def _port(mode, fusion_type, extra, variables, train):
    cfg = Config(**{**SMALL, **dict(extra)}, mode=mode, fusion_type=fusion_type)
    model = define_net(cfg, CPU, seed=0, train=train)
    load_flax_params(model, variables)
    return cfg, model


@pytest.mark.parametrize("case", MODES, ids=_mode_id)
def test_mode_forward_and_eval_step_match_jax(case):
    jcfg, jmodel, variables, batches = _setup(*case)
    batch = batches[0]
    want = jmodel.apply(variables, **j_model_inputs(jcfg, batch), deterministic=True)
    cfg, model = _port(*case, variables, train=False)
    with torch.inference_mode():
        got = model(**model_inputs(cfg, batch_to_device(cfg, batch, CPU)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    jstep = j_steps.make_eval_step(jcfg, jmodel)
    want = jstep(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg, model)(batch_to_device(cfg, batch, CPU))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("case", MODES, ids=_mode_id)
def test_mode_train_step_matches_jax(case):
    """One train step: the loss terms, every parameter gradient and, with a
    BatchNorm, the new running averages."""
    jcfg, jmodel, variables, batches = _setup(*case)
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params):
        v = {"params": params, **({"batch_stats": variables["batch_stats"]}
                                  if "batch_stats" in variables else {})}
        out, new_bs = j_steps._forward(jcfg, jmodel, v, batch, jax.random.PRNGKey(0),
                                       train=True)
        total, aux = j_steps.compute_mode_loss(jcfg, out, batch["labels"], train=True)
        return total, (aux, new_bs)

    (loss, (aux, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    cfg, model = _port(*case, variables, train=True)
    got = make_grad_step(cfg, model)(batch_to_device(cfg, batches[0], CPU), None)
    assert set(got) == {"loss", *aux}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(loss), **TOL)
    for k in aux:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(aux[k]), err_msg=k, **TOL)
    want = flatten_params(_np_tree(grads))
    grads_t = {k: to_flax(p.grad.numpy()) for k, (p, _, to_flax) in _leaf_map(model).items()}
    assert grads_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads_t[k], want[k], err_msg=k, **TOL)
    stats = _stats_map(model)
    assert bool(stats) == (new_bs is not None)
    if new_bs is not None:
        want = flatten_params(_np_tree(new_bs))
        assert stats.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(stats[k].numpy(), want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("mode", ["pathomic", "deformpathomic"])
def test_cut_fuse_grad_stops_the_classifier_gradient(mode):
    """With ``cut_fuse_grad`` the fused classifier's loss sends no gradient
    into either branch's projection (the loss here is the fused logits alone;
    the branch vectors reach them only through the cut fusion)."""
    extra = (("cut_fuse_grad", True),)
    jcfg, jmodel, variables, batches = _setup(mode, "pofusion", extra)
    cfg, model = _port(mode, "pofusion", extra, variables, train=True)
    batch = batch_to_device(cfg, batches[0], CPU)
    out = model(**model_inputs(cfg, batch))
    out["logits"].float().sum().backward()
    projections = ([model.path_net.multimodal_projection, model.omic_net.encoder4]
                   if mode == "pathomic" else
                   [model.pathomic_net_tumor.multimodal_projection,
                    model.pathomic_net_immune.multimodal_projection])
    for layer in projections:
        assert layer.weight.grad is None or not layer.weight.grad.any()
    assert model.fusion.encoder1.weight.grad.abs().sum() > 0
    # without the cut the same loss reaches them
    _, model = _port(mode, "pofusion", (), variables, train=True)
    model(**model_inputs(cfg, batch))["logits"].float().sum().backward()
    layer = (model.path_net.multimodal_projection if mode == "pathomic"
             else model.pathomic_net_tumor.multimodal_projection)
    assert layer.weight.grad.abs().sum() > 0


CLI_MODES = [
    ("omic", ()),
    ("path", ()),
    ("path", ("--variable_bags=true", "--bucket_sizes=36,64")),
    ("pathomic", ("--fusion_type=pofusion",)),
    ("pathomic_original", ("--fusion_type=add",)),
    ("deformpathomic", ("--fusion_type=pofusion",)),
]


@pytest.mark.parametrize("mode,extra", CLI_MODES, ids=lambda c: str(c))
def test_train_cli_writes_weights_that_inference_reproduces(mode, extra, tmp_path, capsys):
    """Two epochs through the train CLI (dropout 0.1), then ``inference
    --weights best_modal.npz`` gives the best epoch's Test metrics; with a
    BatchNorm the file holds its ``batch_stats`` and they have moved."""
    flags = [f"--{k}={v}" for k, v in {**SMALL, "dropout_rate": 0.1}.items()]
    flags += [f"--mode={mode}", *extra]
    ckpt = tmp_path / "ck"
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a bucket smaller than a batch never trains
        assert train_main.main(flags + ["--epochs=2", f"--checkpoints={ckpt}",
                                        "--device=cpu"]) == 0
    out = capsys.readouterr().out
    epochs = re.findall(r"^epoch (\d)/2 val=(\{.*?\}) test=(\{.*?\})", out, re.M)
    trains = re.findall(r"^epoch \d/2 train=(\{.*\})$", out, re.M)
    assert len(epochs) == len(trains) == 2
    for line in trains:
        assert all(np.isfinite(v) for v in ast.literal_eval(line).values())
    best = ast.literal_eval(out.split("best (val): ")[-1].strip())
    best_test = ast.literal_eval(epochs[best["epoch"]][2])
    stored = np.load(ckpt / "best_modal.npz")
    stats = [k for k in stored.files if k.startswith("batch_stats/")]
    assert bool(stats) == ("fusion_type=pofusion" in " ".join(extra)), stats
    for k in stats:
        init = 0.0 if k.endswith("/mean") else 1.0
        assert np.isfinite(stored[k]).all() and not np.allclose(stored[k], init), k
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert inference.main(flags + [f"--weights={ckpt / 'best_modal.npz'}",
                                       "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("test metrics: ")][-1]
    got = ast.literal_eval(line[len("test metrics: "):])
    assert set(got) == set(best_test)
    for k in got:
        np.testing.assert_allclose(got[k], best_test[k], rtol=1e-6, atol=1e-7, err_msg=k)
