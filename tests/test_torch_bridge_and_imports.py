"""The PyTorch port's weight bridge, import hygiene, config defaults and data
pipeline, held against the JAX package."""

import dataclasses
import functools
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

import sml_tpu_torch
from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import init_model as j_init_model
from sml_tpu_torch.bridge import (export_flax_params, flatten_params, load_flax_params,
                                  unflatten_params)
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
             path_dim=32, batch_size=3)


@functools.lru_cache(maxsize=1)
def _jax_params():
    cfg = JConfig(**SMALL)
    model = j_define_net(cfg)
    batch = next(iter(JLoader(j_build_datasets(cfg, "Test"), cfg.batch_size)))
    batch.pop("sample_mask")
    variables = j_init_model(cfg, model, jax.random.PRNGKey(3), batch)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def test_bridge_round_trips_the_flax_tree():
    params = _jax_params()
    flat = flatten_params(params)
    assert all("/" in k for k in flat)
    back = flatten_params(unflatten_params(flat))
    assert back.keys() == flat.keys()
    model = define_net(Config(**SMALL), "cpu", seed=0)
    load_flax_params(model, params)
    exported = flatten_params(export_flax_params(model))
    assert exported.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_bridge_raises_on_missing_or_extra_leaf(change):
    flat = dict(flatten_params(_jax_params()))
    if change == "missing":
        flat.pop("pathomic_net_tumor/layer3/attn2d/rel_pos_bias/w1")
    else:
        flat["pathomic_net_tumor/layer3/attn2d/extra"] = np.zeros(3, np.float32)
    model = define_net(Config(**SMALL), "cpu", seed=0)
    with pytest.raises(ValueError, match="missing|unused"):
        load_flax_params(model, unflatten_params(flat))


@pytest.mark.parametrize("extra", [dict(fusion_type="pofusion"),
                                   dict(fusion_type="pofusion", attn_dim=1,
                                        return_vgrid=False)])
def test_bridge_round_trips_batch_stats_and_the_new_leaf_kinds(extra, tmp_path):
    """A deformpathomic model with a BilinearFusion head (BatchNorm scale / bias
    and its ``batch_stats``, ``Bilinear`` weights) and, with ``attn_dim`` 1,
    the 1-D convolutions, ``CPB1D``'s raw weights and the cls tokens: the JAX
    variables tree loads leaf by leaf, exports back equal, and survives
    ``save_weights`` -> ``load_npz``."""
    from sml_tpu_torch.bridge import export_flax_batch_stats, load_npz
    from sml_tpu_torch.train.loop import save_weights

    cfg = JConfig(**SMALL, mmhid=32, **extra)
    model = j_define_net(cfg)
    batch = next(iter(JLoader(j_build_datasets(cfg, "Test"), cfg.batch_size)))
    batch.pop("sample_mask")
    variables = jax.tree_util.tree_map(
        np.asarray, j_init_model(cfg, model, jax.random.PRNGKey(3), batch))
    assert set(variables) == {"params", "batch_stats"}
    stats = jax.tree_util.tree_map(lambda v: v + np.arange(v.size, dtype=v.dtype) * 1e-3,
                                   variables["batch_stats"])
    flat = flatten_params(variables["params"])
    kinds = {k.rsplit("/", 1)[-1] for k in flat}
    assert {"scale", "weight", "kernel", "bias"} <= kinds
    if extra.get("attn_dim") == 1:
        assert flat["pathomic_net_tumor/layer3/attn1d/offset_conv/kernel"].ndim == 3
        assert "pathomic_net_tumor/cls_token" in flat
    torch_model = define_net(Config(**SMALL, mmhid=32, **extra), "cpu", seed=0)
    load_flax_params(torch_model, {"params": variables["params"], "batch_stats": stats})
    exported = flatten_params(export_flax_params(torch_model))
    assert exported.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    want_stats = flatten_params(stats)
    got_stats = flatten_params(export_flax_batch_stats(torch_model))
    assert got_stats.keys() == want_stats.keys() == {
        "fusion/bn1/mean", "fusion/bn1/var", "fusion/bn2/mean", "fusion/bn2/var"}
    for k, v in want_stats.items():
        np.testing.assert_array_equal(got_stats[k], v, err_msg=k)
    save_weights(torch_model, str(tmp_path / "w.npz"))
    again = define_net(Config(**SMALL, mmhid=32, **extra), "cpu", seed=1)
    load_npz(again, str(tmp_path / "w.npz"))
    for (name, a), b in zip(torch_model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="batch_stats"):
        load_flax_params(again, variables["params"])         # the statistics are missing


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sml_tpu", "yaml", "sklearn",
            "h5py", "pandas", "PIL", "openpyxl", "torchvision")

_BLOCK = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
"""

_IMPORT_PROBE = _BLOCK + r"""
import sml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sml_tpu_torch.__path__, "sml_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {f"sml_tpu_torch.utils.{m}" for m in ("flops", "profiling", "regularize",
                                             "torch_compat")} <= set(names)
assert {f"sml_tpu_torch.parallel.{m}" for m in ("distributed", "mesh", "collectives",
                                                "batchnorm", "seq_parallel",
                                                "seq_deform")} <= set(names)
print(len(names))
"""


def test_port_imports_no_jax_no_sml_tpu_no_host_only_libraries():
    """Every module of sml_tpu_torch imports with the JAX stack, sml_tpu and
    yaml / sklearn / h5py / pandas blocked by exact top-level name."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE, ",".join(_BLOCKED)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = len(list(pkgutil.walk_packages(sml_tpu_torch.__path__, "sml_tpu_torch.")))
    assert int(proc.stdout.split()[-1]) == n_modules >= 20


# the cohort, packed, attribution and device-loop paths run under the same
# block, so that an import inside a function (pandas, h5py, PIL, ...) fails as
# well.  torch's optimizers import ``torch._dynamo`` on first use, which asks
# ``find_spec`` for pandas and others: on a machine without them that returns
# None, under the block it raises, so it is imported before the block
_PATH_PROBE = "import torch._dynamo\n" + _BLOCK + r"""
from sml_tpu_torch import inference
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import build_datasets
from sml_tpu_torch.data.packed import PackedLoader, pack_dataset

root, out = sys.argv[2], sys.argv[3]
genes = dict(input_size_omic=12, input_size_omic_tumor=5, input_size_omic_immune=7)
ds = build_datasets(Config(dataset="both", dataDir=root, fixdim=16, **genes), "Train")
assert ds[0]["x_path"].shape == (16, 1024)
pack_dataset(ds, out + "/Train.bin")
assert next(iter(PackedLoader(out + "/Train.bin", 2, workers=2)))["x_omic"].shape == (2, 12)
argv = ["--dataset=both", f"--dataDir={root}", "--fixdim=16", "--mode=omic", "--batch_size=4",
        "--device=cpu", "--debug", f"--checkpoints={out}", "--attribution=ablation"]
assert inference.main(argv + [f"--{k}={v}" for k, v in genes.items()]) == 0
from sml_tpu_torch import main
argv = [a for a in argv if not a.startswith("--attribution")]
assert main.main(argv + ["--epochs=1", "--device_loop=true", "--device_loop_chunk=2"]
                 + [f"--{k}={v}" for k, v in genes.items()]) == 0
print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""


def test_cohort_packed_and_attribution_paths_import_no_blocked_library(tmp_path):
    """The readers, the packer, the native prefetcher, ``--attribution`` and
    a ``--device_loop`` train run work with the blocked libraries
    unimportable."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_data import _write_fake_corpus

    _write_fake_corpus(str(tmp_path), fixdim=16, n_patients=8)
    proc = subprocess.run([sys.executable, "-c", _PATH_PROBE, ",".join(_BLOCKED),
                           str(tmp_path) + "/", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "[]"
    assert os.path.exists(tmp_path / "difference_acc_list.csv")


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for name in _BLOCKED:
        assert f"import {name}" not in src and f"from {name} " not in src
        assert f"from {name}." not in src


def test_config_defaults_equal_config_mine_yaml():
    with open(os.path.join(REPO, "config", "config_mine.yaml")) as f:
        yaml_cfg = yaml.safe_load(f)
    defaults = dataclasses.asdict(Config())
    for key, value in yaml_cfg.items():
        assert key in defaults, key
        assert defaults[key] == value and type(defaults[key]) is type(value), key


def test_config_parser_builds_from_fields():
    from sml_tpu_torch.config import build_parser

    args = vars(build_parser().parse_args(["--fixdim", "4096", "--return_vgrid", "false",
                                           "--compute_dtype", "bfloat16"]))
    cfg = Config(**args)
    assert (cfg.fixdim, cfg.return_vgrid, cfg.compute_dtype) == (4096, False, "bfloat16")
    assert set(args) == {f.name for f in dataclasses.fields(Config)}
    with pytest.raises(ValueError):
        Config(mode="nonsense")


@pytest.mark.parametrize("argv", [[], ["--image_size", "96"], ["--image_size=224,224"]])
def test_image_size_parses_as_jax(argv):
    """``image_size``, the last field of the JAX ``Config``, with its default
    and parsed from the CLI as the JAX parser parses a tuple flag
    (``tuple(str)``, one item per character)."""
    from sml_tpu.config import build_parser as j_build_parser
    from sml_tpu.config import full_cli_config

    from sml_tpu_torch.config import build_parser

    want = vars(j_build_parser(full_cli_config({})).parse_args(argv))["image_size"]
    got = vars(build_parser().parse_args(argv))["image_size"]
    assert got == want and type(got) is type(want) is tuple
    assert Config(image_size=got).image_size == JConfig(image_size=want).image_size
    assert {f.name for f in dataclasses.fields(Config)} >= set(full_cli_config({})) - {"debug"}


@pytest.mark.parametrize("phase", ["Train", "Test"])
def test_synthetic_dataset_and_loader_match_jax(phase):
    jcfg, cfg = JConfig(**SMALL), Config(**SMALL)
    jds, ds = j_build_datasets(jcfg, phase), build_datasets(cfg, phase)
    assert len(ds) == len(jds)
    for i in (0, len(ds) - 1):
        a, b = ds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jbatches = list(JLoader(jds, 3))
    batches = list(Loader(ds, 3))
    assert len(batches) == len(jbatches) == len(Loader(ds, 3))
    for a, b in zip(batches, jbatches):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert batches[-1]["sample_mask"].min() == (0.0 if len(ds) % 3 else 1.0)
