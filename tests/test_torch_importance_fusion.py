"""The port's exact DeepLIFT through the fused pathomic heads against the JAX
package's on bridged weights (the setup of ``test_torch_importance.py``):
within 1e-5 of the largest attribution, its attributions summing to
logit(x) - logit(ref) per pair."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from sml_tpu.utils import importance as j_imp
from sml_tpu_torch.utils import importance as imp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_importance import _close, _items, _logit, _setup  # noqa: E402

PATHOMIC = [("concat", 0), ("add", 0), ("pofusion", 1)]


@pytest.mark.parametrize("fusion_type, skip", PATHOMIC)
def test_deep_shap_pathomic_matches_jax_and_sums_to_delta(fusion_type, skip):
    jcfg, jmodel, variables, cfg, model, batches = _setup(
        _items(mode="pathomic", fusion_type=fusion_type, skip=skip))
    b = batches[0]
    out = jmodel.apply(variables, x_path=jnp.asarray(b["x_path"]),
                       x_omic=jnp.asarray(b["x_omic"]), deterministic=True)
    path_vec = np.asarray(out["path_vec"])
    background = np.concatenate([bb["x_omic"] for bb in batches])
    for c in (0, cfg.label_dim - 1):       # each class is a JAX compile of its own
        got = imp.deep_shap_pathomic(model, b["x_omic"], background, path_vec,
                                     class_index=c, fusion_type=fusion_type, skip=skip)
        want = j_imp.deep_shap_pathomic(variables, b["x_omic"], background, path_vec,
                                        class_index=c, fusion_type=fusion_type, skip=skip)
        _close(got, want, 1e-5)
    ref = background[-1:]
    pair = imp.deep_shap_pathomic(model, b["x_omic"], ref, path_vec, class_index=2,
                                  fusion_type=fusion_type, skip=skip)
    delta = (_logit(model, cfg, b, b["x_omic"], 2)
             - _logit(model, cfg, b, np.repeat(ref, len(b["x_omic"]), 0), 2))
    np.testing.assert_allclose(pair.sum(axis=1), delta, rtol=1e-4, atol=1e-5)
