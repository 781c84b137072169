"""The port's gene attribution (``sml_tpu_torch/utils/importance.py`` and the
inference CLI's ``_gene_attribution``) against the JAX package's on bridged
weights: f32, fixdim 16, 12 genes (5 tumor + 7 immune), the same numpy inputs.

Tolerances: ablation and permutation importance exactly (after every
prediction's top-2 margin is checked to exceed 1e-3, so no argmax is decided
by rounding); gradient SHAP and integrated gradients within 1e-4 of the
largest attribution; the exact DeepLIFT estimator through MaxNet within 1e-5
of it (and its attributions summing to logit(x) - logit(ref) per pair).
``test_torch_importance_fusion.py`` holds the fused pathomic heads and
MCAT."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference as j_inference
from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.train import steps as j_steps
from sml_tpu.utils import importance as j_imp
from sml_tpu_torch import inference
from sml_tpu_torch.bridge import load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.train.steps import make_eval_step
from sml_tpu_torch.utils import importance as imp

CPU = torch.device("cpu")
GENES = dict(input_size_omic=12, input_size_omic_tumor=5, input_size_omic_immune=7)
SMALL = dict(dataset="synthetic", fixdim=16, synthetic_size=48, input_path_dim=32,
             path_dim=16, omic_dim=16, mmhid=16, batch_size=8, dropout_rate=0.0, seed=4,
             **GENES)
MARGIN = 1e-3


def _leaf(path, v):
    """A bias off 0 by 0.02; a classifier's kernel (the model's and MaxNet's)
    times 8, so that the class probabilities lie far from ties."""
    name = jax.tree_util.keystr(path)
    if "bias" in str(path[-1]):
        return np.asarray(v) + 0.02
    return np.asarray(v) * (8.0 if "classifier']['kernel" in name else 1.0)


def _perturbed(variables):
    """``_leaf`` on every parameter; running means moved by 0.1, variances
    scaled by 1.5."""
    out = {"params": jax.tree_util.tree_map_with_path(_leaf, variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: np.asarray(v) * 1.5 if str(p[-1]) == "['var']"
            else np.asarray(v) + 0.1, variables["batch_stats"])
    return out


@functools.lru_cache(maxsize=None)
def _setup(items):
    """(JAX config, model, variables, port config, model, Test batches): the
    batches' real rows, without ``sample_mask``, as ``_gene_attribution``
    takes them."""
    flags = dict(items)
    jcfg = JConfig(**flags)
    jmodel = j_define_net(jcfg)
    batches = []
    for b in JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size):
        keep = b.pop("sample_mask") > 0
        batches.append({k: v[keep] for k, v in b.items()})
    variables = _perturbed(j_init_model(jcfg, jmodel, jax.random.PRNGKey(3), batches[0]))
    cfg = Config(**flags)
    model = define_net(cfg, CPU, seed=0)
    load_flax_params(model, variables)
    return jcfg, jmodel, variables, cfg, model, batches


def _items(**extra):
    return tuple(sorted({**SMALL, **extra}.items()))


def _close(got, want, rtol):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _predictors(items):
    """(port predict, JAX predict, margins seen by the port): batch -> probs."""
    jcfg, jmodel, variables, cfg, model, _ = _setup(items)
    jstep = jax.jit(j_steps.make_eval_step(jcfg, jmodel))
    step = make_eval_step(cfg, model)
    margins = []

    def port(b):
        probs = step(batch_to_device(cfg, b, CPU))["probs"].numpy()
        top2 = np.sort(probs, axis=1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        return probs

    def jax_(b):
        return np.asarray(jstep(variables, {k: jnp.asarray(v) for k, v in b.items()})["probs"])

    return port, jax_, margins


@pytest.mark.parametrize("mode", ["omic", "pathomic"])
def test_ablation_importance_equals_jax(mode):
    items = _items(mode=mode)
    *_, batches = _setup(items)
    port, jax_, margins = _predictors(items)
    gt = np.concatenate([b["labels"][:, 5] for b in batches]).astype(int)
    got = imp.ablation_importance(port, batches, gt)
    assert min(margins) > MARGIN
    want = j_imp.ablation_importance(jax_, batches, gt)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (12,)


def test_permutation_importance_equals_jax():
    items = _items(mode="omic")
    *_, batches = _setup(items)
    port, jax_, margins = _predictors(items)
    omic = np.concatenate([b["x_omic"] for b in batches])
    gt = np.concatenate([b["labels"][:, 5] for b in batches])

    def score(predict):
        def fn(x):
            preds, off = [], 0
            for b in batches:
                n = len(b["x_omic"])
                preds.append(np.argmax(predict(dict(b, x_omic=x[off:off + n])), -1))
                off += n
            return float((np.concatenate(preds) == gt).mean())
        return fn

    got = imp.get_score_importances(score(port), omic, seed=4)
    assert min(margins) > MARGIN
    want = j_imp.get_score_importances(score(jax_), omic, n_iter=3, seed=4)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for pre in (False, True):
        for (c1, a), (c2, b) in zip(imp.iter_shuffled(omic, pre_shuffle=pre, seed=2),
                                    j_imp.iter_shuffled(omic, pre_shuffle=pre, seed=2)):
            assert c1 == c2
            np.testing.assert_array_equal(a, b)


def _loss_fns(items):
    """(port loss, JAX loss): the true class's summed log-probability."""
    jcfg, jmodel, variables, cfg, model, _ = _setup(items)
    model.eval()

    def port(omic, batch):
        out = model(**model_inputs(cfg, {**batch, "x_omic": omic}))
        logp = torch.log_softmax(out["logits"].float(), dim=1)
        return logp.gather(1, batch["labels"][:, 5].long()[:, None]).sum()

    def jax_(omic, batch):
        out = jmodel.apply(variables, **j_model_inputs(jcfg, {**batch, "x_omic": omic}),
                           deterministic=True)
        logp = jax.nn.log_softmax(out["logits"], axis=1)
        y = jnp.asarray(batch["labels"][:, 5]).astype(jnp.int32)
        return jnp.sum(jnp.take_along_axis(logp, y[:, None], axis=1))

    return port, jax_


@pytest.mark.parametrize("mode", ["omic", "pathomic"])
def test_gradient_shap_and_integrated_gradients_match_jax(mode):
    items = _items(mode=mode)
    *_, cfg, _, batches = _setup(items)
    port, jax_ = _loss_fns(items)
    background = np.concatenate([b["x_omic"] for b in batches])
    for b in batches:
        got = imp.gradient_shap(port, batch_to_device(cfg, b, CPU), background, seed=4)
        want = j_imp.gradient_shap(jax_, b, background, seed=4)
        assert got.shape == want.shape == b["x_omic"].shape
        _close(got, want, 1e-4)
    b = batches[0]
    _close(imp.gradient_importance(port, batch_to_device(cfg, b, CPU)),
           j_imp.gradient_importance(jax_, b), 1e-4)


def _logit(model, cfg, batch, omic, c):
    with torch.no_grad():
        out = model(**model_inputs(cfg, {**batch_to_device(cfg, batch, CPU),
                                         "x_omic": torch.as_tensor(omic)}))
    return out["logits"][:, c].double().numpy()


def test_deep_shap_maxnet_matches_jax_and_sums_to_delta():
    jcfg, jmodel, variables, cfg, model, batches = _setup(_items(mode="omic"))
    x = batches[0]["x_omic"]
    background = np.concatenate([b["x_omic"] for b in batches])
    for c in range(cfg.label_dim):
        got = imp.deep_shap_maxnet(model, x, background, class_index=c)
        want = j_imp.deep_shap_maxnet(variables["params"], x, background, class_index=c)
        _close(got, want, 1e-5)
    ref = background[-1:]
    pair = imp.deep_shap_maxnet(model, x, ref, class_index=1)
    delta = (_logit(model, cfg, batches[0], x, 1)
             - _logit(model, cfg, batches[0], np.repeat(ref, len(x), 0), 1))
    np.testing.assert_allclose(pair.sum(axis=1), delta, rtol=1e-4, atol=1e-5)


def _refusal(mod, cfg, kind):
    loader = (Loader if mod is inference else JLoader)(
        (build_datasets if mod is inference else j_build_datasets)(cfg, "Test"), 8)
    with pytest.raises(ValueError) as err:
        if mod is inference:
            mod._gene_attribution(cfg, None, None, loader, kind, CPU)
        else:
            mod._gene_attribution(cfg, None, None, None, loader, kind)
    return str(err.value)


@pytest.mark.parametrize("flags, kind", [
    (dict(mode="deformpathomic"), "gradient_shap"),
    (dict(mode="path"), "ablation"),
    (dict(mode="omic", task_type="survival"), "ablation"),
    (dict(mode="mcat", task_type="survival"), "deep_shap"),
])
def test_gene_attribution_refuses_as_jax(flags, kind):
    kw = {**SMALL, **flags}
    if flags["mode"] == "mcat":
        kw.update(input_size_omic=431, input_size_omic_tumor=59, input_size_omic_immune=361)
    got = _refusal(inference, Config(**kw), kind)
    assert got == _refusal(j_inference, JConfig(**kw), kind)
