"""The real-data workflow through the port's CLIs on the CPU, after
``tests/test_dress_rehearsal.py``: ``sml_tpu_torch.main`` trains pathomic on
the fake IvYGAP + TCGA corpus, ``sml_tpu_torch.inference --attribution
ablation`` reads the best weights back and writes the per-gene CSV, and the
same training from ``--packed_dir`` gives the same epochs; a cohort or a
packed directory with ``--bucket_sizes`` is refused."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sml_tpu.config import Config as JConfig
from sml_tpu.train.loop import setup as j_setup
from sml_tpu_torch import inference
from sml_tpu_torch import main as train_main
from sml_tpu_torch.config import Config
from sml_tpu_torch.train.loop import setup

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import _write_fake_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENES = dict(input_size_omic=12, input_size_omic_tumor=5, input_size_omic_immune=7)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    _write_fake_corpus(root, fixdim=16, n_patients=16)
    return root + "/"


def _flags(corpus, ckpt, **extra):
    # seed 7: a split whose Val epochs score above 0, so best_modal.npz is written
    flags = dict(dataset="both", dataDir=corpus, fixdim=16, batch_size=8, mode="pathomic",
                 task_type="diag2021", seed=7, checkpoints=ckpt, **GENES, **extra)
    return [f"--{k}={v}" for k, v in flags.items()] + ["--device=cpu"]


def _epochs(printed):
    return [ln for ln in printed.splitlines() if re.match(r"epoch \d+/\d+ ", ln)]


def test_train_then_attribution_then_packed(corpus, tmp_path, capsys):
    ck = str(tmp_path / "ckpts")
    assert train_main.main(_flags(corpus, ck) + ["--epochs=2"]) == 0
    readers = _epochs(capsys.readouterr().out)
    assert len(readers) == 4
    assert {"best_modal.npz", "metrics.jsonl", "last_state.pt"} <= set(os.listdir(ck))

    assert inference.main(_flags(corpus, ck) + [f"--weights={ck}/best_modal.npz",
                                                "--attribution=ablation"]) == 0
    with open(os.path.join(ck, "difference_acc_list.csv")) as f:   # the reference's name
        lines = f.read().strip().splitlines()
    assert lines[0] == "gene_index,importance" and len(lines) == 13
    assert [int(ln.split(",")[0]) for ln in lines[1:]] == list(range(12))
    assert np.isfinite([float(ln.split(",")[1]) for ln in lines[1:]]).all()
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    assert "test/acc" in records[-2] and "attribution/ablation" in records[-1]
    printed = capsys.readouterr().out
    assert "ablation attribution over 12 genes written to" in printed

    packed = str(tmp_path / "packed")
    proc = subprocess.run([sys.executable, "-m", "sml_tpu_torch.pack_data", "--dataset=both",
                           f"--dataDir={corpus}", "--fixdim=16", "--seed=7", f"--out={packed}"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ck2 = str(tmp_path / "ckpts_packed")
    assert train_main.main(_flags(corpus, ck2, packed_dir=packed) + ["--epochs=2"]) == 0
    from_packed = _epochs(capsys.readouterr().out)
    strip = lambda lines: [re.sub(r" elapsed_sec=\S+", "", ln) for ln in lines]
    assert strip(from_packed) == strip(readers)


def test_a_cohort_with_bucket_sizes_raises_as_jax(corpus, tmp_path):
    kw = dict(dataset="both", dataDir=corpus, fixdim=16, bucket_sizes="8,16",
              checkpoints=str(tmp_path), **GENES)
    with pytest.raises(ValueError) as want:
        j_setup(JConfig(**kw))
    with pytest.raises(ValueError) as got:
        setup(Config(**kw), "cpu")
    assert str(got.value) == str(want.value)
    assert "bucket_of" in str(got.value)


def test_packed_dir_with_bucket_sizes_raises(tmp_path):
    cfg = Config(dataset="synthetic", packed_dir=str(tmp_path), bucket_sizes="8,16",
                 checkpoints=str(tmp_path))
    with pytest.raises(ValueError, match="bucket_sizes needs the datasets"):
        setup(cfg, "cpu")
