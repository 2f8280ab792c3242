"""Port ops vs their JAX counterparts at small sizes, edge cases included.

Same numpy inputs through both packages on the CPU. Integer outputs (voxel
maps, rulebooks, ball-query ids, pack indices) must be exactly equal; float
outputs agree to 1e-5 (the ops sum in the same order; matmuls reassociate).
Covers the pad rows and sinks the JAX code reaches by clamped gathers:
voxel capacity overflow, out-of-grid coords, masked points, empty windows.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import geoformer_tpu.ops.sparse_conv as jsc
from geoformer_tpu.ops.voxelize import devoxelize as jax_devoxelize
from geoformer_tpu.ops.voxelize import voxel_mean_pool as jax_voxel_mean_pool
from geoformer_tpu.ops.voxelize import voxelize as jax_voxelize
from geoformer_tpu.models.blocks import _chunked_attention as jax_chunked_attention
from geoformer_tpu.models.geoformer import pack_by_mask as jax_pack_by_mask
from geoformer_tpu.models.geoformer import strided_pack_by_mask as jax_strided_pack
from geoformer_tpu.ops.ball_query import ball_query as jax_ball_query
from geoformer_tpu.ops.geodesic import geodesic_distance_hier as jax_geo_hier
import geoformer_tpu_torch.ops.sparse_conv as tsc
import geoformer_tpu_torch.ops.voxelize as tvox
from geoformer_tpu_torch.models.blocks import _chunked_attention
from geoformer_tpu_torch.models.geoformer import pack_by_mask, strided_pack_by_mask
from geoformer_tpu_torch.ops.ball_query import ball_query
from geoformer_tpu_torch.ops.geodesic import geodesic_distance_hier
from geoformer_tpu_torch.ops.radius_graph import radius_knn
from geoformer_tpu_torch.synthetic import room_points


def _t(a):
    return torch.from_numpy(np.array(a))


def _coords(seed, b=2, p=300, spatial=32):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, spatial // 2, size=(b, p, 3)).astype(np.int32)
    c[0, :5] = [spatial + 3, 1, 1]      # outside the grid (counted in n_oor)
    c[1, 7] = [-1, 2, 2]
    mask = rng.random((b, p)) < 0.9
    return c, mask


@pytest.mark.parametrize("num_voxels", [64, 512])
def test_voxelize_matches_jax(num_voxels):
    """All VoxelGrid fields exactly equal, with and without capacity overflow."""
    c, mask = _coords(num_voxels)
    want = jax.jit(jax_voxelize, static_argnums=(2, 3))(jnp.asarray(c), jnp.asarray(mask),
                                                        num_voxels, 32)
    got = tvox.voxelize(_t(c), _t(mask), num_voxels, 32)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if num_voxels == 64:
        assert np.asarray(want.n_overflow).sum() > 0
    rng = np.random.default_rng(1)
    f = rng.normal(size=(2, 300, 5)).astype(np.float32)
    pooled = tvox.voxel_mean_pool(_t(f), got)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jax_voxel_mean_pool(jnp.asarray(f), want)),
                               atol=1e-5, rtol=0)
    back = tvox.devoxelize(pooled, got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_devoxelize(jnp.asarray(pooled.numpy()), want)),
                               atol=1e-6, rtol=0)


def test_sparse_conv_plan_and_convs_match_jax():
    """Rulebooks exactly equal; subm/down/up convs to 1e-5."""
    c, mask = _coords(3, spatial=32)
    caps = jsc.voxel_capacities(256, 3, 0.5)
    jplan = jax.jit(lambda c, m: jsc.build_grid_plan(c, m, 32, 3, caps))(jnp.asarray(c),
                                                                         jnp.asarray(mask))
    tplan = tsc.build_grid_plan(_t(c), _t(mask), 32, 3, caps)
    for lvl in range(3):
        np.testing.assert_array_equal(tplan.subm[lvl].numpy(), np.asarray(jplan.subm[lvl]))
    for jl, tl in zip(jplan.links, tplan.links):
        np.testing.assert_array_equal(tl.parent.numpy(), np.asarray(jl.parent))
        np.testing.assert_array_equal(tl.children.numpy(), np.asarray(jl.children))
        np.testing.assert_array_equal(tl.offset_idx.numpy(), np.asarray(jl.offset_idx))
    for k, v in jsc.plan_stats(jplan).items():
        np.testing.assert_array_equal(tsc.plan_stats(tplan)[k].numpy(), np.asarray(v), err_msg=k)

    rng = np.random.default_rng(4)
    f = rng.normal(size=(2, 256, 6)).astype(np.float32)
    w = rng.normal(size=(27, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tsc.subm_conv(_t(f), tplan.subm[0], _t(w)).numpy(),
        np.asarray(jsc.subm_conv(jnp.asarray(f), jplan.subm[0], jnp.asarray(w))),
        atol=1e-5, rtol=0)
    wd = rng.normal(size=(8, 6, 4)).astype(np.float32)
    down_t = tsc.down_conv(_t(f), tplan.links[0], _t(wd))
    down_j = jsc.down_conv(jnp.asarray(f), jplan.links[0], jnp.asarray(wd))
    np.testing.assert_allclose(down_t.numpy(), np.asarray(down_j), atol=1e-5, rtol=0)
    wu = rng.normal(size=(8, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tsc.up_conv(down_t, tplan.links[0], _t(wu)).numpy(),
        np.asarray(jsc.up_conv(down_j, jplan.links[0], jnp.asarray(wu))), atol=1e-5, rtol=0)


def test_ball_query_hash_matches_jax():
    """First-nsample-in-index-order ids and hits exactly equal, including
    centers whose window is empty."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, size=(2, 400, 3)).astype(np.float32)
    mask = rng.random((2, 400)) < 0.8
    centers = np.concatenate([pts[:, :30], np.full((2, 2, 3), 5.0, np.float32)], axis=1)
    ji, jh = jax.jit(lambda c, p, m: jax_ball_query(c, p, m, 0.2, 16, cell_cap=8))(
        jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(mask))
    ti, th = ball_query(_t(centers), _t(pts), _t(mask), 0.2, 16, cell_cap=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert not np.asarray(jh)[:, -2:].any() and np.asarray(jh).any()


def test_geodesic_hier_matches_jax():
    """Two-level solve on a room-scan graph: 1e-5, -1 pattern equal."""
    rng = np.random.default_rng(6)
    pts = (room_points(rng, 1500) * 0.5).astype(np.float32)[None]
    mask = np.ones((1, 1500), bool)
    mask[0, -100:] = False
    d2, idx, _, _ = radius_knn(_t(pts), _t(mask), 0.05, 8, cell_cap=24, cell_div=2)
    nd = torch.sqrt(d2.clamp(max=4.0).clamp(min=0.0)).numpy()
    idx = idx.numpy().astype(np.int32)
    seeds = rng.choice(1400, size=(1, 12), replace=False).astype(np.int32)
    smask = np.ones((1, 12), bool)
    smask[0, -1] = False
    kw = dict(fine_sweeps=2, cell_factor=2.0, k_sub=8, fine_k=16, coarse_eps=0.0)
    want = np.asarray(jax_geo_hier(jnp.asarray(idx), jnp.asarray(nd), jnp.asarray(seeds),
                                   jnp.asarray(smask), jnp.asarray(mask), 0.05, 64,
                                   jnp.asarray(pts), **kw))
    got, passes = geodesic_distance_hier(_t(idx).long(), _t(nd), _t(seeds).long(), _t(smask),
                                         _t(mask), 0.05, 64, _t(pts), **kw)
    got = got.numpy()
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (want > 0).mean() > 0.3 and passes[0][1] == 2


def test_pack_by_mask_variants_match_jax():
    rng = np.random.default_rng(7)
    m = rng.random((2, 100)) < 0.6
    for cap in (16, 100):
        ji, jv = jax.vmap(lambda x: jax_pack_by_mask(x, cap))(jnp.asarray(m))
        ti, tv = pack_by_mask(_t(m), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    prefix = np.zeros((2, 500), bool)
    prefix[0, :300] = True
    prefix[1, :40] = True
    for cap in (64, 300, 640):
        ji, jv = jax.vmap(lambda x: jax_strided_pack(x, cap))(jnp.asarray(prefix))
        ti, tv = strided_pack_by_mask(_t(prefix), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_chunked_attention_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 1100, 4, 8)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 1100)) < 0.7
    want = jax_chunked_attention(*map(jnp.asarray, (q, k, v, mask)))
    got = _chunked_attention(*map(_t, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
