"""The port's device loop (``--device_loop``, ``--device_loop_chunk``): the train
CLI's records and final parameters against the JAX loop's device-loop run from
one bridged init (omic, f32, dropout off, 1e-4) at a chunk of 2 with a
remainder, a chunk larger than the epoch, and ``eval_every_iters`` 2 with a
chunk of 4 (the gcd clamp, with mid-epoch records); on the CPU the device loop
is bit for bit the per-step run (deformpathomic, dropout on; on MaxNet also
resumed, from ``--packed_dir``, and with SGD and plateau); the stacking of a
chunk; and ``--bucket_sizes`` with ``--device_loop`` raising."""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import Config as JConfig
from sml_tpu.train import checkpoint as j_ckpt
from sml_tpu.train import loop as j_loop
from sml_tpu.utils.logging import MetricLogger as JMetricLogger
from sml_tpu_torch import main as train_main
from sml_tpu_torch.bridge import flatten_params, load_flax_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.train import checkpoint as ckpt
from sml_tpu_torch.train.evaluate import batch_to_device, stack_to_device
from sml_tpu_torch.train.loop import setup, train
from sml_tpu_torch.train.steps import make_epoch_loop

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
OMIC = dict(dataset="synthetic", fixdim=64, batch_size=8, mode="omic", dropout_rate=0.0,
            device_loop=True, reload=True)
# deformpathomic at the small width, dropout on: 3 train steps an epoch
DEFORM = dict(dataset="synthetic", fixdim=64, synthetic_size=12, input_path_dim=64,
              path_dim=32, mmhid=32, batch_size=4, dropout_rate=0.1, debug=True)
# the loop's plumbing (resume, packed files, SGD with plateau) on MaxNet, whose
# AlphaDropout draws from the device generator: 3 train steps an epoch
OMIC_DROPOUT = dict(dataset="synthetic", fixdim=16, synthetic_size=12, batch_size=4,
                    mode="omic", dropout_rate=0.25, debug=True)
# variant: (flags, epochs)
VARIANTS = {"deformpathomic": (DEFORM, 1), "omic_resumed": (OMIC_DROPOUT, 2),
            "omic_packed": (OMIC_DROPOUT, 2),
            "omic_sgd_plateau": (dict(OMIC_DROPOUT, optimizer="sgd", lr_policy="plateau"), 2)}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("case", [
    dict(synthetic_size=40, epochs=2, device_loop_chunk=2),     # 5 steps: 2 + 2 + 1
    dict(synthetic_size=40, epochs=1, device_loop_chunk=8),     # one chunk of 5
    dict(synthetic_size=48, epochs=1, device_loop_chunk=4, eval_every_iters=2),  # 2s
], ids=["chunk2_remainder", "chunk_over_epoch", "eval_every_2"])
def test_device_loop_cli_matches_jax_loop(case, tmp_path):
    kw = dict(OMIC, **case)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JConfig(**kw, checkpoints=str(jdir), use_pallas=False)
    weights = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.02, j_loop.setup(
        JConfig(**dict(kw, reload=False), use_pallas=False))[2].params)
    j_ckpt.save_weights(str(jdir / "best_modal"), {"params": weights})
    pdir.mkdir()
    np.savez(pdir / "best_modal.npz", **flatten_params(weights))
    jstate, _ = j_loop.train(jcfg, JMetricLogger(out_dir=str(jdir)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert train_main.main([f"--{k}={v}" for k, v in kw.items()]
                               + ["--device=cpu", f"--checkpoints={pdir}"]) == 0

    records, jrecords = _records(pdir / "metrics.jsonl"), _records(jdir / "metrics.jsonl")
    assert [r.keys() for r in records] == [r.keys() for r in jrecords]
    assert sum("training/loss" in r for r in records) == kw["epochs"]
    mid = [r for r in records if "test/loss" in r and "epoch" not in r]
    assert len(mid) == (2 if kw.get("eval_every_iters") else 0)
    assert not any("training/loss" in r for r in mid)
    for got, want in zip(records, jrecords):
        for k in want:
            if k not in ("t", "elapsed_sec"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

    model = define_net(Config(**kw), CPU, seed=0)
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, jstate.params))
    want = model.state_dict()
    got = torch.load(pdir / ckpt.LAST_STATE, weights_only=True)["model"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)


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


class Stop(Exception):
    pass


def _pack_splits(config, out_dir):
    from sml_tpu_torch.data.packed import pack_dataset

    for phase in ("Train", "Val", "Test"):
        pack_dataset(build_datasets(config, phase), str(out_dir / f"{phase}.bin"))


@pytest.fixture
def one_thread():
    """One intra-op thread for runs this small: they are bound by dispatch, and
    a thread pool per test worker oversubscribes the cores of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_device_loop_is_bit_for_bit_the_per_step_run(variant, tmp_path, monkeypatch,
                                                     one_thread):
    """Per step against the device loop (chunks of 2 of 3 steps), dropout on:
    the whole train state equal bit for bit for deformpathomic, and on MaxNet
    also when the device-loop run stops after its first epoch and resumes,
    when it reads ``--packed_dir``, and with SGD and the plateau policy."""
    base, epochs = VARIANTS[variant]
    flags = dict(base, epochs=epochs)
    if variant == "omic_packed":
        _pack_splits(Config(**base), tmp_path)
        flags["packed_dir"] = str(tmp_path)
    state_a, best_a = train(Config(**flags, checkpoints=str(tmp_path / "a")), CPU)
    loop_flags = dict(flags, device_loop=True, device_loop_chunk=2,
                      checkpoints=str(tmp_path / "b"))
    if variant == "omic_resumed":
        save = ckpt.save_resume_meta

        def save_then_stop(checkpoints_dir, meta):
            save(checkpoints_dir, meta)
            raise Stop

        with monkeypatch.context() as m:
            m.setattr(ckpt, "save_resume_meta", save_then_stop)
            with pytest.raises(Stop):
                train(Config(**loop_flags), CPU)
        loop_flags["resume"] = True
    state_b, best_b = train(Config(**loop_flags), CPU)
    assert state_b.step == state_a.step == epochs * 3
    assert best_b == pytest.approx(best_a, rel=0, abs=0)
    a, b = _tensors(state_a.state_dict()), _tensors(state_b.state_dict())
    assert a.keys() == b.keys()
    assert {"rng.device", "rng.host"} <= a.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_stack_to_device_and_epoch_loop_on_the_cpu():
    config = Config(**DEFORM, compute_dtype="bfloat16")
    batches = list(Loader(build_datasets(config, "Train"), config.batch_size,
                          drop_last=True))
    stacked = stack_to_device(config, batches, CPU)
    assert stacked.keys() == batches[0].keys()
    for k, v in stacked.items():
        assert v.device == CPU and v.shape == (len(batches), *np.shape(batches[0][k]))
        for i, b in enumerate(batches):
            assert torch.equal(v[i], batch_to_device(config, b, CPU)[k]), k
    assert stacked["x_path"].dtype == torch.bfloat16
    state = setup(Config(**DEFORM), CPU)[0]
    uneven = dict(stacked, x_omic=stacked["x_omic"][:-1])
    with pytest.raises(ValueError, match="unequal lengths"):
        make_epoch_loop(config, state.model)(state, uneven)
    assert state.step == 0


def test_bucket_sizes_with_device_loop_raises():
    config = Config(dataset="synthetic", fixdim=64, synthetic_size=8, input_path_dim=8,
                    variable_bags=True, bucket_sizes="16,36,64", device_loop=True)
    with pytest.raises(ValueError, match=r"bucket_sizes requires per-step dispatch "
                                         r"\(device_loop scans need one static shape\)"):
        setup(config, CPU)
