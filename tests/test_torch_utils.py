"""The port's ``utils`` modules against the JAX package's: the L1 regularisers
on one bridged set of weights per mode (values at 1e-5 relative, the same
leaves, gradient sign(p)), ``StepTimer`` on the same fed clock, ``trace`` /
``annotate`` writing a trace that holds the annotation, and the FLOP counts
(pure arithmetic: equal to JAX's where its TPU gates send the shape to a
Pallas kernel, and larger by exactly the refused kernel's term elsewhere)."""

import functools
import itertools
import json
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.ops.pallas.deform_attn import fused_attention_padding, pallas_cpb_supported
from sml_tpu.utils import flops as j_flops
from sml_tpu.utils import profiling as j_profiling
from sml_tpu.utils import regularize as j_regularize
from sml_tpu_torch.bridge import (_leaf_map, export_flax_batch_stats, flatten_params,
                                  load_flax_params)
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.utils import flops, profiling, regularize

CPU = torch.device("cpu")
SMALL = dict(dataset="synthetic", fixdim=64, input_path_dim=24, path_dim=32, omic_dim=32,
             mmhid=32, synthetic_size=8, batch_size=2)
MODES = {"omic": dict(mode="omic"),
         "pathomic_pofusion": dict(mode="pathomic", fusion_type="pofusion"),
         "deformpathomic": dict(mode="deformpathomic")}
REGULARIZERS = ("regularize_weights", "regularize_mm_weights", "regularize_mm_omic")


@functools.lru_cache(maxsize=None)
def _params(mode):
    """The JAX params tree of ``mode`` (the init's shapes, seeded values)."""
    jcfg = JConfig(**SMALL, **MODES[mode])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch = next(iter(JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size)))
    batch.pop("sample_mask")
    jmodel = j_define_net(jcfg)
    shapes = jax.eval_shape(functools.partial(jmodel.init, deterministic=True),
                            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            **j_model_inputs(jcfg, batch))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes["params"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", REGULARIZERS + ("regularize_subtrees",))
def test_regularizers_match_jax(mode, name):
    params = _params(mode)
    args = (("pooler", "rel_pos"),) if name == "regularize_subtrees" else ()
    fn = functools.partial(getattr(j_regularize, name), names=args[0]) if args \
        else getattr(j_regularize, name)
    want, want_grads = jax.jit(jax.value_and_grad(fn))(params)
    want_grads = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    model = define_net(Config(**SMALL, **MODES[mode]), CPU, seed=0)
    load_flax_params(model, {"params": params,
                             "batch_stats": export_flax_batch_stats(model)})
    got = getattr(regularize, name)(model, *args)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    selected = {k for k, g in want_grads.items() if np.any(g)}
    if not selected:                     # no leaf matches: a constant 0 in both
        assert float(want) == got.item() == 0.0 and not got.requires_grad
        return
    got.backward()
    flat = flatten_params(params)
    assert selected == {k for k, (p, _, _) in _leaf_map(model).items()
                        if p.grad is not None and torch.any(p.grad)}
    for k, (p, _, to_flax) in _leaf_map(model).items():
        grad = np.zeros_like(flat[k]) if p.grad is None else to_flax(p.grad.numpy())
        np.testing.assert_array_equal(grad, want_grads[k], err_msg=k)
        if k in selected:
            np.testing.assert_array_equal(grad, np.sign(flat[k]), err_msg=k)


def _fed_clock(monkeypatch, times):
    it = iter(times)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("steps, warmup", [(6, 2), (2, 2), (3, 0)])
def test_step_timer_matches_jax(monkeypatch, steps, warmup):
    starts = np.cumsum(np.arange(1, steps + 1) * 0.5)
    clock = list(itertools.chain.from_iterable(
        (t, t + 0.001 * (i + 1) ** 2) for i, t in enumerate(starts)))
    stats = []
    for timer, block_on in ((j_profiling.StepTimer(warmup), None),
                            (profiling.StepTimer(warmup), torch.zeros(2))):
        _fed_clock(monkeypatch, clock)
        for _ in range(steps):
            with timer.step(block_on=block_on):
                pass
        stats.append(timer.stats())
    assert stats[0] == stats[1]
    assert stats[1]["steps"] == (steps - warmup if steps > warmup else steps)


def test_trace_writes_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as path:
        with profiling.annotate("sml_region"):
            torch.ones(8).add_(1).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sml_region" for e in events)


@pytest.mark.parametrize("fixdim", [2500, 4096])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("executed", [False, True])
def test_flops_match_jax(fixdim, training, executed):
    kw = dict(training=training, executed=executed)
    got = flops.deformpathomic_flops(8, fixdim, **kw)
    want = j_flops.deformpathomic_pallas_flops(8, fixdim, **kw)
    g = flops.deform_grid(fixdim)
    assert g == j_flops.deform_grid(fixdim)
    pairs = 2 * 8 * 8 * g["n_grid"] * g["j"]
    refused = 0.0
    if not pallas_cpb_supported(32, g["side"], g["side"], g["j"], 2):
        refused += pairs * flops._cpb_per_pair(32, training, executed)
    pad_rows = fused_attention_padding(g["n_grid"], g["j"], 64, 2, training)
    if pad_rows is None or (not training and pad_rows):
        refused += pairs * flops._epilogue_per_pair(64, training, executed)
    assert got == want + refused
    assert got > 0 and (refused == 0 or training is False)
    assert flops.a100_roofline_bags_per_sec(8, fixdim) == \
        j_flops.a100_roofline_bags_per_sec(8, fixdim)
