"""Checkpoint and resume, ``--reload`` and mid-epoch evaluation of the port's
training loop: a run stopped after an epoch's save and resumed is bit for bit
the uninterrupted run (dropout on, both generators), and an omic run with
``eval_every_iters``, plateau and SGD, stopped and resumed on both sides,
matches the JAX package's (``use_pallas=False``) in its parameters (1e-4), its
resume meta, its ``metrics.jsonl`` records and its checkpoint files."""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.train import checkpoint as j_ckpt
from sml_tpu.train import loop as j_loop
from sml_tpu.utils.logging import MetricLogger as JMetricLogger
from sml_tpu.utils.logging import sigmoid_rampup as j_sigmoid_rampup
from sml_tpu_torch.bridge import export_flax_params, flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.train import checkpoint as ckpt
from sml_tpu_torch.train.loop import save_weights, setup, train
from sml_tpu_torch.utils.logging import MetricLogger, sigmoid_rampup

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
# deformpathomic at the small width, dropout on: AlphaDropout draws from the
# device generator, the attention's Philox seeds from the host one
DEFORM = dict(dataset="synthetic", fixdim=64, synthetic_size=8, input_path_dim=64,
              path_dim=32, mmhid=32, batch_size=4, dropout_rate=0.1, debug=True)
OMIC = dict(dataset="synthetic", synthetic_size=32, fixdim=64, batch_size=8, epochs=3,
            mode="omic", dropout_rate=0.0, eval_every_iters=2, lr_policy="plateau",
            optimizer="sgd")


class Stop(Exception):
    pass


def _stop_after_epoch(monkeypatch, module, epoch):
    """Make ``module.save_resume_meta`` raise right after it saved ``epoch``."""
    save = module.save_resume_meta

    def save_then_stop(checkpoints_dir, meta):
        save(checkpoints_dir, meta)
        if meta["epoch"] == epoch:
            raise Stop

    monkeypatch.setattr(module, "save_resume_meta", save_then_stop)


def _tensors(tree, prefix=""):
    """{path: tensor} of every tensor in a nested state dict."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) \
        if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def test_resume_is_bit_for_bit_the_uninterrupted_run(tmp_path, monkeypatch):
    state_a, best_a = train(Config(**DEFORM, epochs=3, checkpoints=str(tmp_path / "a")),
                            CPU)
    with monkeypatch.context() as m:
        _stop_after_epoch(m, ckpt, epoch=1)
        with pytest.raises(Stop):
            train(Config(**DEFORM, epochs=3, checkpoints=str(tmp_path / "b")), CPU)
    state_b, best_b = train(Config(**DEFORM, epochs=3, resume=True,
                                   checkpoints=str(tmp_path / "b")), CPU)
    assert state_b.step == state_a.step == 3 * 2
    assert state_b.scheduler.last_epoch == state_a.scheduler.last_epoch == 6
    assert best_b == pytest.approx(best_a, rel=0, abs=0)
    a, b = _tensors(state_a.state_dict()), _tensors(state_b.state_dict())
    assert a.keys() == b.keys()
    assert {"rng.device", "rng.host"} <= a.keys()
    assert any(k.startswith("optimizer.state.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_with_more_epochs_is_the_longer_run(tmp_path):
    """A 1-epoch run resumed with ``--epochs 2`` is the 2-epoch run bit for
    bit: the cosine rate of epoch 0 does not depend on ``epochs``, and the
    resumed state takes the rate of its next update from the new schedule."""
    state_a, _ = train(Config(**DEFORM, epochs=2, checkpoints=str(tmp_path / "a")), CPU)
    train(Config(**DEFORM, epochs=1, checkpoints=str(tmp_path / "b")), CPU)
    state_b, _ = train(Config(**DEFORM, epochs=2, resume=True,
                              checkpoints=str(tmp_path / "b")), CPU)
    a, b = _tensors(state_a.state_dict()), _tensors(state_b.state_dict())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    config = Config(**DEFORM, epochs=1, resume=True, checkpoints=str(tmp_path / "ck"))
    state, best = train(config, CPU)
    assert best and state.step == 2
    assert "resuming" not in capsys.readouterr().out
    assert ckpt.has_resume_state(config.checkpoints)
    assert state.model.state_dict().keys() == torch.load(
        tmp_path / "ck" / ckpt.LAST_STATE, weights_only=True)["model"].keys()


def test_reload_best_modal(tmp_path):
    config = Config(**DEFORM, epochs=1, checkpoints=str(tmp_path / "ck"))
    train(config, CPU)
    state = setup(Config(**DEFORM, epochs=1, reload=True, checkpoints=config.checkpoints),
                  CPU)[0]
    got = flatten_params(export_flax_params(state.model))
    with np.load(tmp_path / "ck" / "best_modal.npz") as data:
        assert set(data.files) == set(got)
        for k in got:
            np.testing.assert_array_equal(got[k], data[k], err_msg=k)
    fresh = flatten_params(export_flax_params(setup(config, CPU)[0].model))
    assert any(not np.array_equal(fresh[k], got[k]) for k in got)


def _close(got, want, path=""):
    """Same keys; ints equal, floats at TOL."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _files(path):
    """{name without the port's suffix: the numbers in it} of a checkpoint dir."""
    names = {re.sub(r"\.(npz|pt)$", "", n) for n in os.listdir(path)}
    return {re.sub(r"\d+\.\d+", "#", n): [float(x) for x in re.findall(r"\d+\.\d+", n)]
            for n in names}


def test_stopped_and_resumed_run_matches_jax(tmp_path, monkeypatch):
    """Both runs start from the JAX init (the port reloads it from
    ``best_modal.npz``), stop after epoch 2's save and resume."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JConfig(**OMIC, checkpoints=str(jdir), use_pallas=False)
    init = jax.tree_util.tree_map(np.asarray, j_loop.setup(jcfg)[2].model_variables())
    os.makedirs(pdir)
    np.savez(pdir / "best_modal.npz", **flatten_params(init["params"]))

    with monkeypatch.context() as m:
        _stop_after_epoch(m, j_ckpt, epoch=1)
        with pytest.raises(Stop):
            j_loop.train(jcfg, JMetricLogger(out_dir=str(jdir)))
    jstate, jbest = j_loop.train(JConfig(**OMIC, checkpoints=str(jdir), use_pallas=False,
                                         resume=True), JMetricLogger(out_dir=str(jdir)))

    with monkeypatch.context() as m:
        _stop_after_epoch(m, ckpt, epoch=1)
        with pytest.raises(Stop):
            train(Config(**OMIC, reload=True, checkpoints=str(pdir)), CPU)
    state, best = train(Config(**OMIC, resume=True, checkpoints=str(pdir)), CPU)

    assert state.step == int(jstate.step) == 3 * 4
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = flatten_params(export_flax_params(state.model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    _close(best, jbest)
    meta, jmeta = ckpt.load_resume_meta(str(pdir)), j_ckpt.load_resume_meta(str(jdir))
    assert set(jmeta) == {"epoch", "iters", "best", "plateau"}
    _close(meta, jmeta)

    records, jrecords = _records(pdir / "metrics.jsonl"), _records(jdir / "metrics.jsonl")
    assert [r.keys() for r in records] == [r.keys() for r in jrecords]
    assert sum("test/loss" in r and "training/loss" in r for r in records) == 3
    clock = ("t", "elapsed_sec")
    for r, jr in zip(records, jrecords):
        _close({k: v for k, v in r.items() if k not in clock},
               {k: v for k, v in jr.items() if k not in clock})

    files, jfiles = _files(pdir), _files(jdir)
    assert files.keys() == jfiles.keys()
    assert {"best_modal", "last_state", "last_state_meta.json", "metrics.jsonl"} < set(files)
    for k in files:
        np.testing.assert_allclose(files[k], jfiles[k], err_msg=k, **TOL)
    assert not os.path.isdir(pdir / "last_state.pt")


def test_best_weights_carry_the_reference_names(tmp_path):
    config = Config(**DEFORM, epochs=1, checkpoints=str(tmp_path))
    model = setup(config, CPU)[0].model
    for task, metrics, want in (
            ("survival", {"cindex": 0.61234567}, "epoch_3_cindex_0.612346_"),
            ("diag2021", {"auc": 0.5, "acc": 0.25, "sens": 1 / 3, "spec": 0.75, "f1": 0.2},
             "epoch_3_AUC_0.500000_ACC_0.250000_Sens_0.333333_Spec_0.750000_F1_0.200000_")):
        name = ckpt.best_checkpoint_name(str(tmp_path), 2, task, metrics)
        assert name == str(tmp_path / want)
        assert name == j_ckpt.best_checkpoint_name(str(tmp_path), 2, task, metrics)
        save_weights(model, name + ".npz")
    assert len(list(tmp_path.glob("epoch_3_*_.npz"))) == 2


@pytest.mark.parametrize("length", [0, 1, 5, 40])
def test_sigmoid_rampup_matches_jax(length):
    for current in (-1, 0, 0.5, 1, 3, 5, 39.5, 40, 100):
        assert sigmoid_rampup(current, length) == pytest.approx(
            j_sigmoid_rampup(current, length), rel=1e-12, abs=0)


def test_metric_logger_writes_the_jax_records(tmp_path):
    record = {"epoch": 2, "test": {"loss": np.float32(0.25), "auc": 0.5},
              "training": {"loss": torch.tensor(1.5)}, "note": "x"}
    for out_dir, cls in ((tmp_path / "port", MetricLogger), (tmp_path / "jax", JMetricLogger)):
        out_dir.mkdir()
        logger = cls(out_dir=str(out_dir))
        logger.log(record)
        logger.close()
    (got,), (want,) = _records(tmp_path / "port" / "metrics.jsonl"), \
        _records(tmp_path / "jax" / "metrics.jsonl")
    assert {k: v for k, v in got.items() if k != "t"} == \
        {k: v for k, v in want.items() if k != "t"}
    disabled = tmp_path / "debug"
    disabled.mkdir()
    MetricLogger(out_dir=str(disabled), disabled=True).log(record)
    assert not os.listdir(disabled)
