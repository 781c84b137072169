"""The port's data parallelism (``sml_tpu_torch/parallel``) against the JAX
package's.

- ``sharded_index_batches``, ``Loader``, ``BucketedLoader`` and
  ``PackedLoader`` at 2 and 3 shards give the JAX loaders' batches, with no
  process.
- One group of two gloo ranks (``tests/helpers/torch_parallel_worker.py``,
  torch and the port only, one intra-op thread each) runs:
  ``gather_with_local_grad`` forward and backward against the JAX function
  under ``shard_map`` on 2 devices; ``SyncBatchNorm`` against JAX's (the
  forward and running averages under ``shard_map``, the gradients against
  the same module over the global batch); the Nystrom pinv with its scale
  over the data ranks against the one-process pinv of the whole batch; and
  one deformpathomic train step from one bridged init at a global batch of
  8, 4 a rank (f32, SGD, dropout off, ``ddp`` at w = 2, return_vgrid): with
  pofusion (cross-rank BatchNorm)
  against the JAX train step on a 2-device mesh at 1e-4 and against the
  one-process port step at 1e-5; with concat (gradient modulation on the
  summed gradients) against the one-process port step at 1e-5.  The ranks'
  states are bit-equal after every step; with dropout on, two steps leave
  them bit-equal while the ranks draw different masks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sml_tpu.config import Config as JConfig
from sml_tpu.data.loader import BucketedLoader as JBucketedLoader
from sml_tpu.data.loader import Loader as JLoader
from sml_tpu.data.loader import build_datasets as j_build_datasets
from sml_tpu.data.loader import sharded_index_batches as j_sharded_index_batches
from sml_tpu.data.packed import PackedLoader as JPackedLoader
from sml_tpu.models.factory import define_net as j_define_net
from sml_tpu.models.factory import define_optimizer as j_define_optimizer
from sml_tpu.parallel.batchnorm import SyncBatchNorm as JSyncBatchNorm
from sml_tpu.parallel.collectives import gather_with_local_grad as j_gather
from sml_tpu.parallel.mesh import make_mesh as j_make_mesh
from sml_tpu.parallel.mesh import replicate_tree as j_replicate_tree
from sml_tpu.parallel.mesh import shard_batch as j_shard_batch
from sml_tpu.train import steps as j_steps
from sml_tpu.train.state import TrainState as JTrainState
from sml_tpu_torch.bridge import export_flax_batch_stats, export_flax_params, flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import BucketedLoader, Loader, build_datasets
from sml_tpu_torch.data.loader import sharded_index_batches
from sml_tpu_torch.data.packed import PackedLoader, pack_dataset
from sml_tpu_torch.models.factory import define_net
from sml_tpu_torch.train.loop import save_weights

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
import torch_parallel_worker as worker  # noqa: E402

# SGD: Adam's first step maps every gradient under its eps (1e-8) to about
# +-lr by its sign, so float-order noise there would dominate a parameter check
DEFORM = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
              path_dim=32, mmhid=32, batch_size=8, dropout_rate=0.0,
              batchloss_grad_scale="ddp", optimizer="sgd", lr=0.05, debug=True)
POFUSION = dict(DEFORM, fusion_type="pofusion")
DROPOUT = dict(DEFORM, dropout_rate=0.1)


def _batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_loaders_match_jax(shards, tmp_path):
    idx = np.random.default_rng(0).permutation(23)
    for drop in (False, True):
        for sid in range(shards):
            got = sharded_index_batches(idx, 3, shards, sid, drop)
            want = j_sharded_index_batches(idx, 3, shards, sid, drop)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    fixed = dict(dataset="synthetic", fixdim=16, synthetic_size=20)
    bucketed = dict(fixed, variable_bags=True, bucket_sizes="9,16")
    datasets = {cls: (build_datasets(Config(**cfg), "Train"),
                      j_build_datasets(JConfig(**cfg), "Train"))
                for cls, cfg in ((Loader, fixed), (BucketedLoader, bucketed))}
    pack_dataset(datasets[Loader][0], str(tmp_path / "Train.bin"))
    for sid in range(shards):
        kw = dict(shuffle=True, drop_last=True, seed=5, num_shards=shards, shard_id=sid)
        for cls, jcls in ((Loader, JLoader), (BucketedLoader, JBucketedLoader)):
            ds, jds = datasets[cls]
            got, want = cls(ds, 2, **kw), jcls(jds, 2, **kw)
            got.set_epoch(1), want.set_epoch(1)
            assert len(got) == len(want)
            _batches_equal(got, want)
        got = PackedLoader(str(tmp_path / "Train.bin"), 2, workers=0, **kw)
        want = JPackedLoader(str(tmp_path / "Train.bin"), 2, workers=0, **kw)
        got.set_epoch(2), want.set_epoch(2)
        assert len(got) == len(want)
        _batches_equal(got, want)


def _init(flags, path, seed):
    """A seeded port init of ``flags``'s model written to ``path``; its flax
    variables."""
    model = define_net(Config(**flags), "cpu", seed=seed)
    save_weights(model, str(path))
    return {"params": export_flax_params(model), "batch_stats": export_flax_batch_stats(model)}


def _jax_mesh_step(flags, variables, batch):
    """The JAX train step of ``flags`` on a 2-device mesh from ``variables``."""
    jcfg = JConfig(**flags, num_devices=2, use_pallas=False)
    mesh, jmodel = j_make_mesh(jcfg), j_define_net(jcfg)
    tx = j_define_optimizer(jcfg, 1)
    jstate = j_replicate_tree(mesh, JTrainState.create(variables, tx, jax.random.PRNGKey(1)))
    return j_steps.make_train_step(jcfg, jmodel, tx)(jstate, j_shard_batch(mesh, batch))[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank group over every task; (the inputs and the JAX step's state,
    the one-process port runs, the ranks' outputs)."""
    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    inputs = {"gather_x": rng.normal(size=(4, 3)).astype(np.float32),
              "gather_w": rng.normal(size=(4, 3)).astype(np.float32),
              "bn_x": (rng.normal(size=(8, 5)) * 3 + 2).astype(np.float32),
              "bn_w": rng.normal(size=(8, 5)).astype(np.float32),
              "bn_scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bn_bias": rng.normal(size=5).astype(np.float32),
              # a softmax kernel's rows sum to 1: the pinv's case
              "pinv_x": np.asarray(torch.softmax(torch.from_numpy(
                  rng.normal(size=(4, 2, 8, 8)).astype(np.float32)), -1)),
              "pinv_w": rng.normal(size=(4, 2, 8, 8)).astype(np.float32)}
    batch = next(iter(Loader(build_datasets(Config(**DEFORM), "Train"), 8, shuffle=True,
                             drop_last=True, seed=42)))
    batch.pop("sample_mask")
    inputs.update({f"batch/{k}": v for k, v in batch.items()})
    np.savez(d / "inputs.npz", **inputs)
    variables = _init(POFUSION, d / "pofusion.npz", seed=1)
    _init(DEFORM, d / "concat.npz", seed=2)
    runs = [dict(name="pofusion", flags=POFUSION, weights=str(d / "pofusion.npz")),
            dict(name="concat", flags=DEFORM, weights=str(d / "concat.npz")),
            dict(name="dropout", flags=DROPOUT, weights=str(d / "concat.npz"), steps=2)]
    started = worker.start(2, dict(dir=str(d), seq=0, tasks=["gather", "batchnorm", "pinv", "steps"],
                                   steps=runs))
    jstate = _jax_mesh_step(POFUSION, variables, dict(batch))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # one process: ddp's w = num_devices = 2, the two ranks' w
        single = {run["name"]: worker.train_step(dict(run["flags"], num_devices=2),
                                                 run["weights"], batch)
                  for run in runs[:2]}
    finally:
        torch.set_num_threads(threads)
    return dict(inputs=inputs, jstate=jstate), single, worker.finish(started)


def test_gather_with_local_grad_matches_jax_under_shard_map(ranks):
    from jax import shard_map

    inputs, _, got = ranks[0]["inputs"], ranks[1], ranks[2]
    x, w = jnp.asarray(inputs["gather_x"]), jnp.asarray(inputs["gather_w"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def per_device(xl):
        y = j_gather(xl, "data")
        return y[None], (y * w).sum()[None]

    run = shard_map(per_device, mesh=mesh, in_specs=P("data"),
                    out_specs=(P("data"), P("data")), check_vma=False)
    ys, _ = run(x)
    dx = jax.grad(lambda x: run(x)[1].sum())(x)
    for r in range(2):
        np.testing.assert_array_equal(got[r]["gather_y"], np.asarray(ys[r]))
    np.testing.assert_allclose(np.concatenate([g["gather_dx"] for g in got]),
                               np.asarray(dx), rtol=1e-6, atol=1e-6)


def test_sync_batchnorm_matches_jax(ranks):
    from jax import shard_map

    inputs, got = ranks[0]["inputs"], ranks[2]
    x, w = jnp.asarray(inputs["bn_x"]), jnp.asarray(inputs["bn_w"])
    params = {"scale": jnp.asarray(inputs["bn_scale"]), "bias": jnp.asarray(inputs["bn_bias"])}
    stats = {"mean": jnp.zeros(5), "var": jnp.ones(5)}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    sync = JSyncBatchNorm(axis_name="data")

    def per_device(xl):
        y, new = sync.apply({"params": params, "batch_stats": stats}, xl,
                            mutable=["batch_stats"])
        return y, new["batch_stats"]["mean"][None], new["batch_stats"]["var"][None]

    y, mean, var = shard_map(per_device, mesh=mesh, in_specs=P("data"),
                             out_specs=(P("data"), P("data"), P("data")),
                             check_vma=False)(x)
    # the gradients of the same function, over the global batch on one device
    def loss(x, p):
        out, _ = JSyncBatchNorm().apply({"params": p, "batch_stats": stats}, x,
                                        mutable=["batch_stats"])
        return (out * w).sum()

    dx, dp = jax.grad(loss, argnums=(0, 1))(x, params)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["bn_y"] for g in got]), np.asarray(y), **tol)
    np.testing.assert_allclose(np.concatenate([g["bn_dx"] for g in got]), np.asarray(dx),
                               **tol)
    for g in got:
        np.testing.assert_allclose(g["bn_dscale"], np.asarray(dp["scale"]), **tol)
        np.testing.assert_allclose(g["bn_dbias"], np.asarray(dp["bias"]), **tol)
        np.testing.assert_allclose(g["bn_mean"], np.asarray(mean[0]), **tol)
        np.testing.assert_allclose(g["bn_var"], np.asarray(var[0]), **tol)


def test_pinv_scale_spans_the_data_ranks(ranks):
    """The Newton-Schulz pinv of each rank's matrices with its scale over the
    data group is the one-process pinv of the whole batch (whose scale is the
    batch's largest row and column sums), values and gradients; a softmax
    kernel's row sums tie across the batch, so the scale's gradient is split
    among the ties of both ranks."""
    from sml_tpu_torch.ops.linear_algebra import moore_penrose_pinv

    inputs, got = ranks[0]["inputs"], ranks[2]
    x = torch.from_numpy(inputs["pinv_x"]).requires_grad_(True)
    z = moore_penrose_pinv(x, 6)
    (z * torch.from_numpy(inputs["pinv_w"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g["pinv_z"] for g in got]),
                               z.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([g["pinv_dx"] for g in got]),
                               x.grad.numpy(), **tol)


def _state(got, name):
    return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in got.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", ["pofusion", "concat"])
def test_two_rank_train_step_is_the_one_process_step(ranks, name):
    """Loss, the summed (and, with concat, modulated) gradients within 1e-5 of
    the largest gradient, parameters and running averages at 1e-5."""
    _, single, got = ranks
    want, _, metrics, _ = single[name]
    top = max(float(v.abs().max()) for k, v in want.items() if k.startswith("grad/"))
    for g in got:
        assert bool(g[f"{name}:equal"])
        np.testing.assert_allclose(g[f"{name}:loss"], metrics["loss"], rtol=1e-5)
        state = _state(g, name)
        assert state.keys() == want.keys()
        for k in want:
            scale = top if k.startswith("grad/") else 1.0
            np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
    for k, v in _state(got[0], name).items():
        assert torch.equal(v, _state(got[1], name)[k]), k


def test_two_rank_pofusion_step_matches_the_jax_mesh_step(ranks):
    """Parameters and the BatchNorms' running averages after one step against
    the JAX train step on a 2-device mesh (global-batch BatchNorm, ddp w = 2)."""
    jstate2, got = ranks[0]["jstate"], ranks[2]
    model = define_net(Config(**POFUSION), "cpu", seed=0)
    model.load_state_dict({k: v for k, v in _state(got[0], "pofusion").items()
                           if not k.startswith("grad/")})
    params = flatten_params(export_flax_params(model))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate2.params))
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(params[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    stats = flatten_params(export_flax_batch_stats(model))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jstate2.batch_stats))
    assert stats.keys() == want.keys() and stats
    for k in want:
        np.testing.assert_allclose(stats[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_dropout_ranks_draw_their_own_streams_and_stay_equal(ranks):
    got = ranks[2]
    assert all(bool(g["dropout:equal"]) for g in got)
    assert not np.array_equal(got[0]["dropout:dropout_logits"],
                              got[1]["dropout:dropout_logits"])
    for k, v in _state(got[0], "dropout").items():
        assert torch.equal(v, _state(got[1], "dropout")[k]), k
