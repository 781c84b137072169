"""The port's deformable cross-attention against the JAX module, on the same bridged
weights, in f32 at the repo's parity tolerance (1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sml_tpu.ops import deformable as jdef
from sml_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from sml_tpu_torch.bridge import load_flax_params
from sml_tpu_torch.ops import deformable as tdef
from sml_tpu_torch.ops.grid_sample import grid_sample_2d

TOL = dict(rtol=1e-4, atol=1e-4)
DIM = 32          # path_dim of the small model: CPB width dm = 8


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, DIM)).astype(np.float32) for _ in range(2)]


def _jax_module(use_pallas):
    return jdef.DeformCrossAttention2D(dim=DIM, dim_head=64, heads=8, dropout=0.1,
                                       offset_scale=4.0, offset_groups=8,
                                       use_pallas=use_pallas,
                                       pallas_interpret=use_pallas)


def _port_module(params):
    mod = tdef.DeformCrossAttention2D(DIM)
    load_flax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    return mod.eval()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("b,n", [(2, 64), (2, 256)])
def test_deform_cross_attention_2d_matches_jax(use_pallas, b, n):
    x1, x2 = _inputs(b, n, n)
    jmod = _jax_module(use_pallas)
    variables = jmod.init(jax.random.PRNGKey(n), jnp.asarray(x1), jnp.asarray(x2),
                          deterministic=True)
    # non-zero biases so the bridge's bias leaves are exercised too
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 if "b" in str(p[-1]) else v, variables["params"])
    want, want_vgrid = jmod.apply({"params": params}, jnp.asarray(x1), jnp.asarray(x2),
                                  return_vgrid=True, deterministic=True)
    with torch.inference_mode():
        got, vgrid = _port_module(params)(torch.from_numpy(x1), torch.from_numpy(x2),
                                          return_vgrid=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(vgrid.numpy(), np.asarray(want_vgrid), **TOL)


def test_cpb_factors_and_naive_match_jax():
    rng = np.random.default_rng(7)
    h = w = 8
    bg, j, dm = 8, 9, 8
    grid_kv = rng.uniform(-1.2, 1.2, size=(bg, j, 2)).astype(np.float32)
    x_axis = (2.0 * np.arange(w) / (w - 1) - 1.0).astype(np.float32)
    y_axis = (2.0 * np.arange(h) / (h - 1) - 1.0).astype(np.float32)
    jcpb = jdef.CPB2D(dm, heads=8, offset_groups=8, impl="naive")
    args = (jnp.asarray(x_axis), jnp.asarray(y_axis), jnp.asarray(grid_kv))
    variables = jcpb.init(jax.random.PRNGKey(0), *args, batch=1)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.1, variables["params"])
    want_factors = jcpb.apply({"params": params}, *args, method=jdef.CPB2D.factors)
    want_naive = jcpb.apply({"params": params}, *args, [params[f"w{i}"] for i in range(3)],
                            [params[f"b{i}"] for i in range(3)], jnp.float32, 1,
                            method=jdef.CPB2D._naive)
    cpb = tdef.CPB2D(dm, heads=8, offset_groups=8)
    load_flax_params(cpb, params)
    targs = [torch.from_numpy(a) for a in (x_axis, y_axis, grid_kv)]
    with torch.inference_mode():
        for got, want in zip(cpb.factors(*targs), want_factors):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cpb.naive(*targs, query_chunk=24).numpy(),
                                   np.asarray(want_naive), **TOL)


def test_grid_sample_matches_jax_gather_form():
    rng = np.random.default_rng(3)
    inp = rng.normal(size=(3, 9, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(3, 4, 6, 2)).astype(np.float32)
    want = j_grid_sample_2d(jnp.asarray(inp), jnp.asarray(grid))
    got = grid_sample_2d(torch.from_numpy(inp), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_group_ungroup_round_trip_matches_jax():
    x = np.arange(2 * 3 * 4 * 16, dtype=np.float32).reshape(2, 3, 4, 16)
    got = tdef._group(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdef._group(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(tdef._ungroup(got, 8).numpy(), x)


def test_non_square_bag_raises():
    mod = tdef.DeformCrossAttention2D(DIM)
    x = torch.zeros(1, 50, DIM)
    with pytest.raises(ValueError, match="perfect square"):
        mod(x, x)
