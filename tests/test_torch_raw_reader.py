"""The port's ``RawPatchReader`` (``sml_tpu_torch/data/datasets.py``) against
the JAX package's on the fixture layout of ``tests/test_raw_reader.py``: bit
for bit at bag sizes below, at and above the slide's patch count (the uniform
subsample and the repetition branches), its row map, a ragged bag, the
``Loader`` over its tensors (the collate and ``--workers``' thread), and the
reader with JAX, PIL and torchvision unimportable."""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sml_tpu.data.datasets import RawPatchReader as JRawPatchReader
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.datasets import RawPatchReader, bag_rows
from sml_tpu_torch.data.loader import Loader
from sml_tpu_torch.train.evaluate import batch_to_device

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS, "data", "jpeg")
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "scripts"))
from make_jpeg_fixtures import BAG_LAYOUTS  # noqa: E402

N_PATCHES = 5


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_slide(cohort, wsi_root, slide, n, layouts=BAG_LAYOUTS, first=0):
    """``read_details/{slide}.npy`` listing n coordinates (i, 10 i), as in
    ``tests/test_raw_reader.py``, and a copy of a committed fixture per
    coordinate, the layouts in turn from ``first``."""
    os.makedirs(os.path.join(cohort, "read_details"), exist_ok=True)
    sdir = os.path.join(wsi_root, slide)
    os.makedirs(sdir, exist_ok=True)
    coords = np.array([[i, i * 10] for i in range(n)], dtype=object)
    np.save(os.path.join(cohort, "read_details", f"{slide}.npy"),
            np.array([coords], dtype=object), allow_pickle=True)
    for i in range(n):
        layout = layouts[(first + i) % len(layouts)]
        shutil.copy(os.path.join(FIXTURES, f"{layout}.jpg"),
                    os.path.join(sdir, f"{i}_{i * 10}.jpg"))


@pytest.fixture()
def fake_slide(tmp_path):
    cohort, wsi_root = str(tmp_path / "cohort"), str(tmp_path / "wsi")
    write_slide(cohort, wsi_root, "S0", N_PATCHES)
    return cohort, wsi_root, "S0"


@pytest.mark.parametrize("fixdim", [2, 3, N_PATCHES, 8, 12])
def test_reader_matches_jax(fixdim, fake_slide, one_thread):
    cohort, wsi_root, slide = fake_slide
    want = JRawPatchReader(cohort, wsi_root, fixdim)(slide)
    got = RawPatchReader(cohort, wsi_root, fixdim, device="cpu")(slide)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (fixdim, 224 * 224 * 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num, max_num, rows", [
    (3, 8, [0, 1, 2, 0, 1, 2, 0, 1]),
    (4, 4, [0, 1, 2, 3]),
    (10, 4, [0, 2, 5, 8]),            # 2.5 -> 2 and 7.5 -> 8: half to even
    (5, 2, [0, 2]),                   # 2.5 -> 2
    (7, 3, [0, 2, 5]),
])
def test_bag_rows_are_jaxs_row_map(num, max_num, rows):
    assert bag_rows(num, max_num) == rows


def test_a_ragged_bag_raises_as_in_jax(tmp_path):
    cohort, wsi_root = str(tmp_path / "cohort"), str(tmp_path / "wsi")
    write_slide(cohort, wsi_root, "S1", 3, layouts=("q75_420", "q75_420_100x60"))
    with pytest.raises(ValueError):
        JRawPatchReader(cohort, wsi_root, 4)("S1")
    with pytest.raises(ValueError, match="1_10.jpg: a 100x60 patch"):
        RawPatchReader(cohort, wsi_root, 4, device="cpu")("S1")


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_collates_the_bags_as_jax_stacks_them(workers, tmp_path, one_thread):
    """Three slides in batches of 2 (the last padded by repetition): the
    port's batches hold the bags as tensors, equal to the JAX reader's arrays
    stacked, with the thread of ``--workers`` too; ``batch_to_device`` passes a
    tensor through and casts it."""
    cohort, wsi_root = str(tmp_path / "cohort"), str(tmp_path / "wsi")
    for s in range(3):
        write_slide(cohort, wsi_root, f"S{s}", 2 + s, first=s)
    reader = RawPatchReader(cohort, wsi_root, 4, device="cpu")
    jreader = JRawPatchReader(cohort, wsi_root, 4)
    data = [{"x_path": reader(f"S{s}"), "labels": np.full(2, s, np.float32)}
            for s in range(3)]
    batches = list(Loader(data, 2, workers=workers))
    assert len(batches) == 2 and batches[1]["sample_mask"].tolist() == [1.0, 0.0]
    want = [jreader(f"S{s}") for s in (0, 1, 2, 2)]
    got = torch.cat([b["x_path"] for b in batches])
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert isinstance(batches[0]["labels"], np.ndarray)
    cfg = Config(compute_dtype="bfloat16")
    moved = batch_to_device(cfg, batches[0], torch.device("cpu"))
    assert moved["x_path"].dtype == torch.bfloat16
    assert torch.equal(moved["x_path"], batches[0]["x_path"].bfloat16())


_NO_PIL = r"""
import hashlib, importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from sml_tpu_torch.data.datasets import RawPatchReader
bag = RawPatchReader(sys.argv[2], sys.argv[3], 7, device="cpu")("S0")
print(tuple(bag.shape), hashlib.sha256(bag.numpy().tobytes()).hexdigest())
"""


def test_reader_runs_without_jax_pil_or_torchvision(fake_slide):
    cohort, wsi_root, slide = fake_slide
    blocked = "jax,jaxlib,flax,sml_tpu,PIL,torchvision"
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, blocked, cohort, wsi_root],
                          cwd=os.path.dirname(TESTS), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = JRawPatchReader(cohort, wsi_root, 7)(slide)
    assert proc.stdout.split()[-1] == hashlib.sha256(want.tobytes()).hexdigest()
    assert proc.stdout.startswith(str(want.shape))
