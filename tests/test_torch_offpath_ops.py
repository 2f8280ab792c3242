"""The port's off-path ops (the branches that config keys reach) vs JAX.

Same seeded numpy inputs through the JAX function and its port, on the CPU,
each JAX program compiled once by XLA without backend optimisation
(``_jit_exact``: op-by-op rounding). Tolerances:

* the exact geodesic table (float32 and int16 fixed point): bit-equal,
  including ``symmetrize=True`` with a reverse-edge cap that overflows and
  ``positions=None``; a split of the seed columns equals the whole;
* every ``radius_knn`` arm (``dense_grid`` 0, ``cellwin``, ``window``,
  ``select`` passes / topk / approx, ``sort=False``): ids, d2 and both
  counters exactly equal; ``ranked_lookup`` equal to ``torch.searchsorted``;
* the brute-force ball query: ids and hits exactly equal;
* the compact slot tables exactly equal, the compact conv within 1e-5 in
  float32 (sums in another order: JAX routes each slot's weight by a one-hot
  product, the port runs the 27-slot rulebook conv) and 1e-3 relative in
  bf16 (as tests/test_torch_losses.py holds the bf16 conv).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.ops.ball_query import ball_query as jax_ball_query
from geoformer_tpu.ops import geodesic as jax_geo
from geoformer_tpu.ops import radius_graph as jax_rg
from geoformer_tpu.ops import sparse_conv as jax_sc
from geoformer_tpu_torch.ops import ball_query, geodesic, radius_graph, sparse_conv

RADIUS = 0.06


def _jit_exact(f, *args):
    """f(*args) compiled by XLA without backend optimisation: one program,
    with the rounding of op-by-op execution (no contracted multiply-adds)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scene(seed=0, b=2, p=700):
    """Two scenes of points in a 0.5 m box with a dense clump and exact
    duplicates; the second scene's last 50 points invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 0.5, (b, p, 3))
    pts[:, :60] = 0.25 + rng.normal(0, 2e-3, (b, 60, 3))
    pts[:, 60:66] = 0.4
    mask = np.ones((b, p), bool)
    mask[1, -50:] = False
    return pts.astype(np.float32), mask


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


@pytest.fixture(scope="module")
def graph():
    """The radius-kNN table (the port's topk arm, held against JAX below),
    its euclidean edge lengths, and seeds: 8 a scene, one masked."""
    pts, mask = _scene()
    d2, idx, _, _ = radius_graph.radius_knn(_t(pts), _t(mask), RADIUS, 8, cell_cap=16,
                                            select="topk")
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, pts.shape[1], (2, 8)).astype(np.int32)
    seed_mask = np.ones((2, 8), bool)
    seed_mask[0, 3] = False
    return dict(pts=pts, mask=mask, idx=idx.numpy().astype(np.int32),
                dist=torch.sqrt(d2.clamp(0.0, 4.0)).numpy(), seeds=seeds, seed_mask=seed_mask)


def test_symmetrize_graph_matches_jax(graph):
    """Reverse edges bucketed by destination in the stable sort's order,
    with a cap of 3 that drops the overflow as JAX drops it."""
    nb, w = geodesic._prep_edges(_t(graph["idx"][0]), _t(graph["dist"][0]), _t(graph["mask"][0]),
                                 RADIUS)
    want_i, want_w = _np(_jit_exact(lambda a, b: jax_geo.symmetrize_graph(a, b, 3),
                                    jnp.asarray(nb.numpy().astype(np.int32)),
                                    jnp.asarray(w.numpy())))
    got_i, got_w = geodesic.symmetrize_graph(nb, w, 3)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_w.numpy().view(np.int32), want_w.view(np.int32))
    indeg = np.bincount(nb.numpy().ravel(), minlength=nb.shape[0] + 1)[:-1]
    assert indeg.max() > 3, "the cap of 3 reverse slots should overflow"


@pytest.mark.parametrize("int16,symmetrize,positions", [
    (False, False, True),   # the model's exact branch
    (True, False, True),    # ... with tpu_geodesic_int16
    (False, True, False),   # reverse edges (cap 3, overflowing), identity order
    (True, True, False),
])
def test_geodesic_distance_bit_equal(graph, int16, symmetrize, positions):
    """The exact solver's table bit-equal to JAX's (every step is one add and
    a min), its seed columns solved in two halves equal to the whole."""
    args = [graph["idx"], graph["dist"], graph["seeds"], graph["seed_mask"], graph["mask"]]
    if positions:
        args.append(graph["pts"])
    kw = dict(symmetrize=symmetrize, rev_slots=3 if symmetrize else None)

    def jax_solve(*a):
        return jax_geo.geodesic_distance(
            *a[:5], RADIUS, 40, positions=a[5] if positions else None,
            relax_dtype=jnp.int16 if int16 else None, **kw)

    want = np.asarray(_jit_exact(jax_solve, *map(jnp.asarray, args)))

    def solve(cols):
        t = [_t(a) for a in args]
        return geodesic.geodesic_distance(
            t[0], t[1], t[2][:, cols], t[3][:, cols], t[4], RADIUS, 40,
            positions=t[5] if positions else None, int16=int16, **kw)

    got, sweeps = solve(slice(None))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    halves = torch.cat([solve(slice(0, 3))[0], solve(slice(3, None))[0]], dim=2)
    assert torch.equal(halves.view(torch.int32), got.view(torch.int32))
    assert 4 <= min(sweeps) and max(sweeps) < 40, sweeps
    assert 0.5 < (want > 0).mean() and (want[0, :, 3] == -1).all()


def test_ranked_lookup_is_searchsorted():
    """The two-level compare-count rank equals torch.searchsorted(side=
    'left') on a sorted key table: queries below, between, on and above the
    keys, across segment edges."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(np.unique(rng.integers(0, 1 << 30, 1000)))
    queries = torch.cat([table[::7], table[::11] + 1, table[::13] - 1,
                         torch.tensor([-5, 0, 1 << 31, int(table[-1]) + 1])])
    got = radius_graph.ranked_lookup(table, queries.reshape(-1, 3)[:, :2])
    want = torch.searchsorted(table, queries.reshape(-1, 3)[:, :2].contiguous(), side="left")
    assert torch.equal(got, want)
    assert torch.equal(radius_graph.ranked_lookup(table[:128], queries),
                       torch.searchsorted(table[:128], queries))


def test_window_lookups_match_the_per_slot_oracle():
    """The run-compressed window lookup (dense_grid = 0) and the per-slot
    oracle equal each other and JAX's per-slot oracle."""
    pts, mask = _scene(3)
    pts, mask = _t(pts[0]), _t(mask[0])
    p = pts.shape[0]
    grid, _, _, _, _ = radius_graph.build_cell_table(pts, mask, RADIUS, p, 8)
    args = (grid.voxel_keys[0], grid.n_voxels[0], p, grid.voxel_coords[0], grid.voxel_mask[0])
    run = radius_graph.window_lookup(*args)
    slot = radius_graph._window_lookup_per_slot(*args)
    want = _jit_exact(lambda k, n, c, m: jax_rg._window_lookup_per_slot(k, n, p, c, m),
                      *(jnp.asarray(a.numpy().astype(np.int32)) for a in
                        (args[0], args[1], args[3])), jnp.asarray(args[4].numpy()))
    assert torch.equal(run, slot)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want))
    assert (slot < p).sum() > 3 * grid.n_voxels[0]


ARMS = {
    "dense_grid0": dict(dense_grid=0, select="topk"),
    "cellwin": dict(cellwin=True, select="topk"),
    "passes": dict(select="passes"),
    "topk": dict(select="topk"),
    "approx": dict(select="approx"),
    "window_exact": dict(window=200, select="topk"),
    "window_overflow": dict(window=24, select="topk"),
    "unsorted": dict(sort=False),
    "pallas_grid0_cellwin": dict(dense_grid=0, cellwin=True, select="pallas"),
}


@pytest.mark.parametrize("name", ARMS)
def test_radius_knn_arm_matches_jax(name):
    """Every arm's d2 and ids, and both counters, exactly equal to JAX's
    (approx: lax.approx_max_k off the TPU, XLA's exact fallback)."""
    pts, mask = _scene(4)
    k, cap = 8, 8
    kw = dict(dict(dense_grid=256), **ARMS[name])
    jd, ji, jdrop, jwin = _np(_jit_exact(
        lambda p, m: jax_rg.radius_knn(p, m, RADIUS, k, cell_cap=cap, with_stats=True, **kw),
        jnp.asarray(pts), jnp.asarray(mask)))
    td, ti, tdrop, twin = radius_graph.radius_knn(_t(pts), _t(mask), RADIUS, k, cell_cap=cap,
                                                  **kw)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy().view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(tdrop.numpy(), jdrop)
    np.testing.assert_array_equal(twin.numpy(), jwin)
    n_edges = (ji < pts.shape[1]).sum(-1)
    assert (n_edges == k).any() and (n_edges < k).any()
    if name == "window_overflow":
        assert twin.min() > 0
    else:
        assert twin.max() == 0


def test_select_min_k_matches_jax():
    """k argmin passes: values and lanes exactly equal to JAX's, the same
    _BIG lane repeated on exhausted rows."""
    rng = np.random.default_rng(5)
    d2 = (rng.integers(0, 5, (40, 30)) / 4).astype(np.float32)
    d2[rng.random((40, 30)) < 0.4] = 1e30
    d2[3] = 1e30
    d2[4, 2:] = 1e30
    wv, wp = _np(_jit_exact(lambda d: jax_rg.select_min_k(d, 6), jnp.asarray(d2)))
    gv, gp = radius_graph.select_min_k(torch.from_numpy(d2), 6)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gp.numpy(), wp)
    assert (wp[3] == wp[3, 0]).all()


def test_brute_ball_query_matches_jax():
    """tpu_ball_cell_cap 0: the first nsample in-radius points in index
    order, exactly as JAX's, over two chunks of 512 centers; centers with no
    hit repeat lane 0."""
    pts, mask = _scene(6)
    rng = np.random.default_rng(7)
    centers = np.concatenate([pts[:, rng.choice(700, 560, replace=False)],
                              np.full((2, 40, 3), 3.0, np.float32)], axis=1)
    wi, wh = _np(_jit_exact(lambda c, p, m: jax_ball_query(c, p, m, 0.1, 16, cell_cap=0),
                            jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(mask)))
    gi, gh = ball_query.ball_query(_t(centers), _t(pts), _t(mask), 0.1, 16, 0)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gh.numpy(), wh)
    assert wh.all(-1).any() and (~wh).all(-1).any() and (wh.any(-1) & ~wh.all(-1)).any()


@pytest.fixture(scope="module")
def conv_plan():
    """A two-level grid plan of a surface-like scene, built by both packages
    with subm_k = 9 (which binds: voxels with more live neighbours)."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 1, (2, 600, 3))
    pts[..., 2] = pts[..., 0] * 0.3 + rng.normal(0, 0.02, (2, 600))
    coords = np.floor(pts * 16).astype(np.int32)
    mask = np.ones((2, 600), bool)
    mask[1, -80:] = False
    caps = [512, 256]
    want = _jit_exact(lambda c, m: jax_sc.build_grid_plan(c, m, 32, 2, caps, subm_k=9),
                      jnp.asarray(coords), jnp.asarray(mask))
    got = sparse_conv.build_grid_plan(_t(coords), _t(mask), 32, 2, caps, subm_k=9)
    return got, _np(want)


def test_compact_tables_match_jax(conv_plan):
    got, want = conv_plan
    for lvl, ((gi, go), (wi, wo)) in enumerate(zip(got.subm_compact, want.subm_compact)):
        np.testing.assert_array_equal(gi.numpy(), wi, err_msg=f"idx level {lvl}")
        np.testing.assert_array_equal(go.numpy(), wo, err_msg=f"oid level {lvl}")
    live = (got.subm[0] < got.subm[0].shape[1]).sum(-1)
    assert live.max() > 9 and (live <= 9).any()


@pytest.mark.parametrize("bf16", [False, True])
def test_compact_conv_matches_jax(conv_plan, bf16):
    got, want = conv_plan
    idx, oid = got.subm_compact[0]
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(2, idx.shape[1], 5)).astype(np.float32)
    w = (rng.normal(size=(27, 5, 6)) / 5).astype(np.float32)
    dt = jnp.bfloat16 if bf16 else None
    ref = np.asarray(_jit_exact(
        lambda f, i, o, ww: jax_sc.subm_conv_compact(f, i, o, ww, compute_dtype=dt),
        jnp.asarray(feats), jnp.asarray(want.subm_compact[0][0]),
        jnp.asarray(want.subm_compact[0][1]), jnp.asarray(w)))
    out = sparse_conv.apply_subm(_t(feats), (idx, oid), _t(w),
                                 torch.bfloat16 if bf16 else None)
    assert out.dtype == torch.float32
    tol = 1e-3 * np.abs(ref).max() if bf16 else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)
    exact = sparse_conv.subm_conv(_t(feats), got.subm[0], _t(w)).numpy()
    assert np.abs(exact - out.numpy()).max() > 1e-3, "dropped offsets should change the output"
