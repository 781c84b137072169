"""The port's reference-checkpoint converter (``utils/torch_compat.py``) against
the JAX package's.  The torch reference is not part of this repository, so each
mode's reference ``state_dict`` is built from the variables of the mode
(the JAX init's tree and shapes, seeded values) by
``chip_smoke.reference_state_dict`` (the key names and layouts that
``sml_tpu/utils/torch_compat.py`` reads).  JAX's converter maps it onto that
exact tree, which checks ``reference_state_dict``; the port's converter gives the
identical tree; an extra key raises in both; and the port model loaded by
``load_reference_state_dict`` gives the JAX model's eval outputs (f32, 1e-4)
for deformpathomic, TransMIL, MCAT and CMTA at small width."""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from chip_smoke import reference_state_dict
from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import model_inputs as j_model_inputs
from sml_tpu.utils.torch_compat import convert_reference_state_dict as j_convert
from sml_tpu_torch.bridge import flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net, model_inputs
from sml_tpu_torch.train.evaluate import batch_to_device
from sml_tpu_torch.utils.torch_compat import (convert_reference_state_dict,
                                              load_reference_state_dict, reference_mode)

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
SMALL = dict(dataset="synthetic", fixdim=64, input_path_dim=24, path_dim=32, omic_dim=32,
             mmhid=32, synthetic_size=8, batch_size=2, use_pallas=False)
CASES = {
    "deformpathomic": dict(mode="deformpathomic"),
    "deformpathomic_1d_pofusion": dict(mode="deformpathomic", attn_dim=1,
                                       return_vgrid=False, fusion_type="pofusion"),
    "transmil": dict(mode="path", path_arch="transmil"),
    "mcat": dict(mode="mcat", task_type="survival"),
    "mcat_bilinear": dict(mode="mcat", task_type="survival", coattn_fusion="bilinear"),
    "cmta": dict(mode="cmta", task_type="survival"),
    "omic": dict(mode="omic"),
    "path": dict(mode="path"),
    "pathomic_pofusion": dict(mode="pathomic", fusion_type="pofusion"),
    "pathomic_original": dict(mode="pathomic_original"),
}


@functools.lru_cache(maxsize=None)
def _jax(case):
    """(config, JAX model, variables, one eval batch): the shapes of the mode's
    init, filled from a seeded normal (scale 0.05; BatchNorm variances
    positive)."""
    flags = dict(SMALL, **CASES[case])
    jcfg = JConfig(**flags)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch = next(iter(JLoader(j_build_datasets(jcfg, "Test"), jcfg.batch_size)))
    batch.pop("sample_mask")
    jmodel = j_define_net(jcfg)
    shapes = jax.eval_shape(functools.partial(jmodel.init, deterministic=True),
                            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            **j_model_inputs(jcfg, batch))
    rng = np.random.default_rng(len(case))

    def fill(path, leaf):
        value = (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return np.abs(value) + 0.5 if str(path[-1]) == "['var']" else value

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    return Config(**flags), jmodel, variables, batch


def _convert(fn, config, sd):
    return fn(reference_mode(config), sd, attn_dim=config.attn_dim,
              fusion_type=config.fusion_type)


def _assert_same_tree(got, want):
    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_converters_give_the_jax_init_tree(case):
    config, _, variables, _ = _jax(case)
    sd = reference_state_dict(variables, reference_mode(config), config.attn_dim)
    _assert_same_tree(_convert(j_convert, config, sd), variables)
    _assert_same_tree(_convert(convert_reference_state_dict, config, sd), variables)
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_same_tree(_convert(convert_reference_state_dict, config, torch_sd), variables)
    extra = dict(sd, **{"classifier.extra.weight": np.zeros(3, np.float32)})
    for fn in (j_convert, convert_reference_state_dict):
        with pytest.raises(ValueError, match="unconverted reference keys"):
            _convert(fn, config, extra)


@pytest.mark.parametrize("case", ["deformpathomic", "transmil", "mcat", "cmta"])
def test_loaded_reference_weights_give_the_jax_outputs(case):
    config, jmodel, variables, batch = _jax(case)
    want = jax.jit(functools.partial(jmodel.apply, deterministic=True))(
        variables, **j_model_inputs(config, batch))
    sd = reference_state_dict(variables, reference_mode(config), config.attn_dim)
    model = define_net(config, CPU, seed=0)
    load_reference_state_dict(model, {k: torch.from_numpy(v) for k, v in sd.items()},
                              config)
    with torch.inference_mode():
        got = model(**model_inputs(config, batch_to_device(config, batch, CPU)))
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TOL)
