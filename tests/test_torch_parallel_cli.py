"""The train CLI on two gloo ranks: ``python -m sml_tpu_torch.main --device cpu
--num_processes 2 --process_id R --coordinator_address 127.0.0.1:PORT`` with
``--reload`` from one bridged init (omic, f32, dropout off; a global batch of
8, 4 a rank), for 2 epochs per step and with ``--device_loop``: rank 0's
``metrics.jsonl`` records (with the device loop its epoch records) equal the
JAX train loop's at ``num_devices`` 2, at 1e-4, and its final parameters the
JAX loop's; rank 1 writes nothing (its
checkpoint directory keeps only the init it read).  Each run ends with the
loop's check that the ranks hold the same state bit for bit."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.train import checkpoint as j_ckpt
from sml_tpu.train import loop as j_loop
from sml_tpu.utils.logging import MetricLogger as JMetricLogger
from sml_tpu_torch.bridge import flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
OMIC = dict(dataset="synthetic", fixdim=64, synthetic_size=40, batch_size=8, mode="omic",
            dropout_rate=0.0, epochs=2, reload=True)
RUNS = {"per_step": {}, "device_loop": dict(device_loop=True, device_loop_chunk=2)}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _start(flags: dict, dirs) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    argv = [f"--{k}={v}" for k, v in flags.items()]
    return [subprocess.Popen([sys.executable, "-m", "sml_tpu_torch.main", *argv,
                              "--device=cpu", "--num_processes=2", f"--process_id={r}",
                              f"--coordinator_address=127.0.0.1:{port}",
                              f"--checkpoints={dirs[r]}"], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


def _finish(procs, timeout=120):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a rank hung past {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX loop at num_devices 2 and the two port launches, the JAX loop
    while the ranks run."""
    d = tmp_path_factory.mktemp("parallel_cli")
    weights = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, j_loop.setup(
        JConfig(**dict(OMIC, reload=False), use_pallas=False))[2].params)
    started = {}
    for name, extra in RUNS.items():
        dirs = [d / name / f"rank{r}" for r in range(2)]
        for p in dirs:
            p.mkdir(parents=True)
            np.savez(p / "best_modal.npz", **flatten_params(weights))
        started[name] = (dirs, _start(dict(OMIC, **extra), dirs))
    jdir = d / "jax"
    j_ckpt.save_weights(str(jdir / "best_modal"), {"params": weights})
    jstate, _ = j_loop.train(JConfig(**OMIC, num_devices=2, checkpoints=str(jdir),
                                     use_pallas=False), JMetricLogger(out_dir=str(jdir)))
    logs = {name: (dirs, _finish(procs)) for name, (dirs, procs) in started.items()}
    return jdir, jstate, logs


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_rank_cli_matches_the_jax_loop_at_two_devices(runs, name):
    jdir, jstate, logs = runs
    (rank0, rank1), (log0, log1) = logs[name]
    assert "distributed: 2 rank(s), backend gloo" in log0
    assert "epoch 2/2" in log0 and "epoch" not in log1       # rank 0 prints alone
    assert sorted(os.listdir(rank1)) == ["best_modal.npz"]     # ... and writes alone
    records, jrecords = _records(rank0 / "metrics.jsonl"), _records(jdir / "metrics.jsonl")
    if name == "device_loop":      # one training record an epoch, not one per 10 steps
        records, jrecords = ([r for r in rs if "epoch" in r] for rs in (records, jrecords))
    assert [r.keys() for r in records] == [r.keys() for r in jrecords]
    assert sum("validation/loss" in r for r in records) == 2
    for got, want in zip(records, jrecords):
        for k in want:
            if k not in ("t", "elapsed_sec"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

    model = define_net(Config(**OMIC), "cpu", seed=0)
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, jstate.params))
    got = torch.load(rank0 / ckpt.LAST_STATE, weights_only=True)["model"]
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
