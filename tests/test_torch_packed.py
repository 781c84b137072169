"""The port's packed format and loader (``sml_tpu_torch/data/packed.py``, the
native prefetcher in ``sml_tpu_torch/runtime``) against the JAX package's:
the same files byte for byte, the same batches natively and through numpy,
and a failed build or a short read raising."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.data.packed import PackedLoader as JPackedLoader
from sml_tpu.data.packed import pack_dataset as j_pack_dataset
from sml_tpu_torch import runtime
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.data.packed import PackedDataset, PackedLoader, pack_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import _write_fake_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(dataset="synthetic", synthetic_size=21, fixdim=16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    _write_fake_corpus(root, fixdim=16, n_patients=12)
    return root + "/"


def _files(path):
    return open(path, "rb").read(), open(path + ".json", "rb").read()


@pytest.mark.parametrize("source", ["synthetic", "corpus"])
def test_pack_dataset_writes_the_jax_files(source, corpus, tmp_path):
    kw = SYNTH if source == "synthetic" else dict(dataset="both", dataDir=corpus, fixdim=16)
    j_pack_dataset(j_build_datasets(JConfig(**kw), "Train"), str(tmp_path / "j.bin"))
    meta = pack_dataset(build_datasets(Config(**kw), "Train"), str(tmp_path / "p.bin"))
    assert _files(str(tmp_path / "p.bin")) == _files(str(tmp_path / "j.bin"))
    ds = PackedDataset(str(tmp_path / "p.bin"))
    assert len(ds) == meta["n_records"] > 0
    want = build_datasets(Config(**kw), "Train")[len(ds) - 1]
    for k, v in ds[len(ds) - 1].items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("packed") / "Train.bin")
    pack_dataset(build_datasets(Config(**SYNTH), "Train"), path)
    return path


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_packed_loader_gives_the_jax_batches(workers, train, packed):
    """Two epochs; train mode shuffles and drops the last partial batch, eval
    mode pads it with ``sample_mask`` 0."""
    kw = dict(shuffle=True, drop_last=True, seed=3) if train else {}
    want = JPackedLoader(packed, 4, use_native=False, **kw)
    got = PackedLoader(packed, 4, workers=workers, queue_depth=2, **kw)
    assert len(got) == len(want) == (5 if train else 6)
    epochs = []
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        w, g = list(want), list(got)
        assert len(g) == len(w) == len(got)
        for a, b in zip(g, w):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        epochs.append(g)
    if train:
        assert not np.array_equal(epochs[0][0]["x_omic"], epochs[1][0]["x_omic"])
    else:
        assert epochs[0][-1]["sample_mask"].tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("train", [True, False])
def test_packed_loader_gives_the_loaders_batches(train, packed):
    kw = dict(shuffle=True, drop_last=True, seed=3) if train else {}
    want = Loader(build_datasets(Config(**SYNTH), "Train"), 4, **kw)
    got = PackedLoader(packed, 4, workers=2, **kw)
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        w, g = list(want), list(got)
        assert len(g) == len(w) == len(want)
        for a, b in zip(g, w):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_failed_prefetcher_build_raises(packed, tmp_path, monkeypatch):
    broken = tmp_path / "prefetch.cpp"
    shutil.copy(runtime.SRC, broken)
    broken.write_text(broken.read_text().replace("int64_t pf_submit(", "int64_t pf_submit(#"))
    monkeypatch.setattr(runtime, "SRC", broken)
    loader = PackedLoader(packed, 4, workers=2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(iter(loader))
    assert not runtime.library_path(broken).exists()


def test_a_short_read_raises(packed, tmp_path):
    path = str(tmp_path / "short.bin")
    shutil.copy(packed + ".json", path + ".json")
    with open(packed, "rb") as f:                 # the last record cut in half
        data = f.read()
    rb = PackedDataset(packed).record_bytes
    with open(path, "wb") as f:
        f.write(data[: len(data) - rb // 2])
    with pytest.raises(OSError, match="short read"):
        list(PackedLoader(path, 4, workers=2))


@pytest.mark.parametrize("source", ["synthetic", "corpus"])
def test_pack_data_cli_writes_what_the_jax_script_writes(source, corpus, tmp_path):
    args = (["--dataset", "synthetic", "--synthetic_size", "10", "--fixdim", "8"]
            if source == "synthetic"
            else ["--dataset", "both", "--dataDir", corpus, "--fixdim", "16", "--seed", "3"])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for cmd, out in (([sys.executable, "scripts/pack_data.py"], "jax"),
                     ([sys.executable, "-m", "sml_tpu_torch.pack_data"], "port")):
        proc = subprocess.run(cmd + args + ["--out", str(tmp_path / out)], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "Test.bin", "Test.bin.json", "Train.bin", "Train.bin.json", "Val.bin",
        "Val.bin.json"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
