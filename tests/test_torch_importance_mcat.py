"""MCAT's signature-group attribution (integrated gradients of the survival
risk, summed per signature group) against the JAX package's on bridged
weights, within 1e-4 of the largest attribution."""

import os
import sys

import jax

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu.utils import importance as j_imp
from sml_tpu_torch.bridge import load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.utils import importance as imp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_importance import CPU, _close, _perturbed  # noqa: E402


def test_mcat_group_attribution_matches_jax():
    flags = dict(dataset="synthetic", mode="mcat", task_type="survival", fixdim=16,
                 input_path_dim=24, synthetic_size=16, batch_size=4, seed=4)
    jcfg = JConfig(**flags)
    jmodel = j_define_net(jcfg)
    batches = list(JLoader(j_build_datasets(jcfg, "Test"), 4))
    init = dict(batches[0])
    init.pop("sample_mask")
    variables = _perturbed(j_init_model(jcfg, jmodel, jax.random.PRNGKey(7), init))
    model = define_net(Config(**flags), CPU, seed=0)
    load_flax_params(model, variables)
    got = imp.mcat_group_attribution(model, batches)
    want = j_imp.mcat_group_attribution(jmodel, variables, batches)
    assert got[0].shape == (431,) and got[1].shape == (4,)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)
