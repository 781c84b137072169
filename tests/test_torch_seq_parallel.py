"""The port's sequence parallelism (``parallel/seq_parallel.py``,
``parallel/seq_deform.py``) against the JAX package's.

One group of four gloo ranks, a (data 2, seq 2) grid
(``tests/helpers/torch_parallel_worker.py``):

- the Nystrom attention (b 2, 256 tokens, 32 landmarks, 4 heads of 8; with
  and without a mask; chain 1 in plain products and through the kernels'
  plain versions, the span form with the mask) and the 2-D deformable
  cross-attention (b 2, a 16 x 16 grid, 8 heads of 64; with and without a
  mask) sharded over each seq group of 2: the output, the vgrid and every
  input and parameter gradient against the JAX modules on a seq mesh of 2
  (``run_seq_parallel_nystrom`` / ``run_seq_parallel_deform2d`` under
  ``shard_map``) at 2e-4 / 2e-5 (``tests/test_seq_parallel.py``,
  ``tests/test_seq_deform.py``), a gradient's atol in units of its largest
  magnitude where that is over 1;
- one deformpathomic train step on the 2 x 2 grid (f32, dropout off, a global
  batch of 8, 4 a data rank, ``ddp`` at w = 4) equal to the one-process step
  from the same init, the four ranks bit-equal.

With no process: ``seq_checks`` refuses as the JAX ``_seq_mesh`` does, with
its messages; ``seq_devices`` without a process group and ``return_attn``
under sequence parallelism raise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sml_tpu.config import Config as JConfig
from sml_tpu.models import factory as j_factory
from sml_tpu.ops.deformable import DeformCrossAttention2D as JDeform2D
from sml_tpu.ops.nystrom import NystromAttention as JNystrom
from sml_tpu_torch.bridge import flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net, seq_checks
from sml_tpu_torch.ops.nystrom import NystromAttention
from sml_tpu_torch.parallel.mesh import Grid
from sml_tpu_torch.train.loop import save_weights

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
import torch_parallel_worker as worker  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
NYSTROM = dict(dim=32, dim_head=8, heads=4, num_landmarks=32)
DEFORM = dict(dim=32, dim_head=64, heads=8, offset_groups=8, dropout=0.0)
STEP = dict(dataset="synthetic", fixdim=64, synthetic_size=16, input_path_dim=64,
            path_dim=32, mmhid=32, batch_size=8, dropout_rate=0.0,
            batchloss_grad_scale="ddp", optimizer="sgd", lr=0.05, debug=True)


def _seq_mesh():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))


def _cases():
    """(name, kind, masked, chain 1 through the kernels)."""
    return [("nystrom", "nystrom", False, False), ("nystrom_masked", "nystrom", True, False),
            ("nystrom_fused", "nystrom", False, True),
            ("nystrom_fused_masked", "nystrom", True, True),
            ("deform", "deform", False, False), ("deform_masked", "deform", True, False)]


def _jax_sharded(kind, variables, inputs, masked):
    """(out, vgrid or None, input grads, flat param grads) of the JAX module
    on a seq mesh of 2."""
    mesh = _seq_mesh()
    mask = jnp.asarray(inputs[f"{kind}_mask"]) if masked else None
    if kind == "nystrom":
        mod = JNystrom(**NYSTROM, seq_mesh=mesh)

        def loss(p, x):
            out = mod.apply({"params": p}, x, mask=mask, deterministic=True)
            return (out * inputs["nystrom_w"]).sum(), (out, None)

        args = (jnp.asarray(inputs["nystrom_x"]),)
    else:
        mod = JDeform2D(**DEFORM, cpb_query_chunk=128, seq_mesh=mesh)

        def loss(p, x, x2):
            out, vgrid = mod.apply({"params": p}, x, x2, return_vgrid=True,
                                   deterministic=True, mask=mask)
            return ((out * inputs["deform_w"]).sum()
                    + (vgrid * inputs["deform_vw"]).sum()), (out, vgrid)

        args = (jnp.asarray(inputs["deform_x"]), jnp.asarray(inputs["deform_x2"]))
    grads, (out, vgrid) = jax.jit(jax.grad(loss, argnums=tuple(range(len(args) + 1)),
                                           has_aux=True))(variables["params"], *args)
    return (np.asarray(out), None if vgrid is None else np.asarray(vgrid),
            [np.asarray(g) for g in grads[1:]],
            flatten_params(jax.tree_util.tree_map(np.asarray, grads[0])))


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """The four ranks' outputs, the JAX results per case, the one-process step."""
    d = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    inputs = {"nystrom_x": rng.normal(size=(2, 256, 32)).astype(np.float32),
              "nystrom_w": rng.normal(size=(2, 256, 32)).astype(np.float32),
              "nystrom_mask": np.arange(256)[None, :] < np.array([[160], [256]]),
              "deform_x": rng.normal(size=(2, 256, 32)).astype(np.float32),
              "deform_x2": rng.normal(size=(2, 256, 32)).astype(np.float32),
              "deform_w": rng.normal(size=(2, 256, 32)).astype(np.float32),
              "deform_vw": rng.normal(size=(2, 8, 4, 4, 2)).astype(np.float32),
              "deform_mask": np.arange(256)[None, :] < np.array([[200], [256]])}
    variables = {}
    for kind, mod, args in (
            ("nystrom", JNystrom(**NYSTROM), (inputs["nystrom_x"],)),
            ("deform", JDeform2D(**DEFORM, cpb_query_chunk=128),
             (inputs["deform_x"], inputs["deform_x2"]))):
        v = mod.init(jax.random.PRNGKey(1), *map(jnp.asarray, args), deterministic=True)
        # non-zero biases, so their gradients are checked too
        variables[kind] = {"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05, v["params"])}
        np.savez(d / f"{kind}.npz", **flatten_params(variables[kind]["params"]))
    batch = next(iter(Loader(build_datasets(Config(**STEP), "Train"), 8, shuffle=True,
                             drop_last=True, seed=42)))
    batch.pop("sample_mask")
    inputs.update({f"batch/{k}": v for k, v in batch.items()})
    np.savez(d / "inputs.npz", **inputs)
    save_weights(define_net(Config(**STEP), "cpu", seed=4), str(d / "step.npz"))
    attention = [dict(name=name, kind=kind, masked=masked, fused=fused,
                      kwargs=NYSTROM if kind == "nystrom" else DEFORM,
                      weights=str(d / f"{kind}.npz"))
                 for name, kind, masked, fused in _cases()]
    steps = [dict(name="grid", flags=dict(STEP, seq_devices=2), weights=str(d / "step.npz"))]
    started = worker.start(4, dict(dir=str(d), seq=2, tasks=["seq_attention", "steps"],
                                   attention=attention, steps=steps))
    want = {name: _jax_sharded(kind, variables[kind], inputs, masked)
            for name, kind, masked, _ in _cases() if not name.startswith("nystrom_fused")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:      # one process: ddp's w = num_devices = 4, the grid's ranks
        single = worker.train_step(dict(STEP, num_devices=4), str(d / "step.npz"), batch)
    finally:
        torch.set_num_threads(threads)
    return worker.finish(started, timeout=180), want, single


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_sharded_attention_matches_jax_on_a_seq_mesh(grid4, name):
    got, want, _ = grid4
    out, vgrid, dxs, dparams = want[name.replace("_fused", "")]
    for g in got:                                     # every seq group alike
        if name.startswith("nystrom"):
            assert int(g[f"{name}:chain1"]) == ("fused" in name)
        np.testing.assert_allclose(g[f"{name}:out"], out, **TOL)
        if vgrid is not None:
            np.testing.assert_allclose(g[f"{name}:vgrid"], vgrid, **TOL)
        for i, dx in enumerate(dxs):
            _close_grad(g[f"{name}:dx{i}"], dx, f"dx{i}")
        grads = {k.split("/", 1)[1]: v for k, v in g.items() if k.startswith(name + "/")}
        assert grads.keys() == dparams.keys()
        for k in dparams:
            _close_grad(grads[k], dparams[k], k)


def _close_grad(got, want, what):
    """A gradient at TOL, its atol in units of the tensor's largest magnitude
    where that is over 1 (sums of thousands of terms in another order: the
    grid_sample path's offset gradients reach |g| ~ 1e2)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                               err_msg=what)


def test_two_by_two_train_step_is_the_one_process_step(grid4):
    got, _, (want, _, metrics, _) = grid4
    top = max(float(v.abs().max()) for k, v in want.items() if k.startswith("grad/"))
    states = []
    for g in got:
        assert bool(g["grid:equal"])
        np.testing.assert_allclose(g["grid:loss"], metrics["loss"], rtol=1e-5)
        state = {k.split("/", 1)[1]: v for k, v in g.items() if k.startswith("grid/")}
        assert state.keys() == want.keys()
        for k in want:
            scale = top if k.startswith("grad/") else 1.0
            np.testing.assert_allclose(state[k], want[k].numpy(), rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
        states.append(state)
    for state in states[1:]:
        for k, v in state.items():
            np.testing.assert_array_equal(v, states[0][k], err_msg=k)


@pytest.mark.parametrize("flags", [
    dict(mode="path", path_arch="transmil", seq_devices=3),
    dict(mode="cmta", task_type="survival", seq_devices=3),
    dict(mode="deformpathomic", attn_dim=1, return_vgrid=False, seq_devices=2),
    dict(mode="deformpathomic", fixdim=2500, seq_devices=2),
], ids=["transmil_landmarks", "cmta_landmarks", "deform_attn_dim_1", "deform_grid_side"])
def test_seq_checks_refuse_as_jax_does(flags):
    with pytest.raises(ValueError) as want:
        j_factory._seq_mesh(JConfig(**flags))
    with pytest.raises(ValueError) as got:
        seq_checks(Config(**flags))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="seq_devices"):
        define_net(Config(**flags), "cpu")


def test_seq_devices_without_ranks_and_return_attn_raise():
    with pytest.raises(ValueError, match="--num_processes"):
        define_net(Config(mode="path", path_arch="transmil", seq_devices=2), "cpu")
    mod = NystromAttention(**NYSTROM)
    mod.seq = Grid(world=2, seq=2)
    with pytest.raises(ValueError, match="return_attn"):
        mod(torch.zeros(1, 64, 32), return_attn=True)
