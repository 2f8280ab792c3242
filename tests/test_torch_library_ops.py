"""The port's library point ops vs JAX: kNN, 3-NN interpolation, segment
reductions, IoU, greedy NMS and clustering (geoformer_tpu/ops/{knn,
interpolate,segment_ops,nms,cluster}.py and their names in ops/__init__.py).

Same seeded numpy inputs through both packages on the CPU; each JAX program
compiled once without backend optimisation (``_jit_exact``: op-by-op
rounding). Tolerances:

* exact: ``gather_points``, ``group_points``, ``sec_min``, ``sec_max``,
  ``roipool``, ``get_iou`` (its products count 0/1 entries, exact in float32
  below 2^24), ``greedy_nms``, ``ballquery_dense``, ``connected_components``
  and ``bfs_cluster``;
* ``knn``: indices equal, the dead slots of a scene with fewer than k valid
  points (index 0 at 1e30) too; squared distances to rtol 1e-6. An index may
  differ only at a near-tie (the exact gap between the k-th and (k+1)-th
  neighbour under 1e-5 relative), which the matmul trick's rounding can swap:
  such rows are counted and reported, any other mismatch fails;
* ``three_nn`` as ``knn``; ``three_interpolate`` rtol 1e-5; ``sec_mean``
  rtol 1e-6; ``roipool``'s gradient against ``jax.grad`` (split evenly over
  tied maxima) rtol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import geoformer_tpu.ops as jops
from geoformer_tpu.ops import cluster as jax_cluster
from geoformer_tpu.ops import nms as jax_nms
from geoformer_tpu.ops import segment_ops as jax_seg
from geoformer_tpu.ops.knn import knn as jax_knn
import geoformer_tpu_torch.ops as tops
from geoformer_tpu_torch.ops import cluster, interpolate, nms, segment_ops
from geoformer_tpu_torch.ops.knn import knn


def _jit_exact(f, *args):
    """f(*args) compiled by XLA without backend optimisation: one program,
    with the rounding of op-by-op execution (no contracted multiply-adds)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def test_ops_exports_match_jax():
    """Every name of geoformer_tpu.ops; the three that are also module names
    of the port's ops package through their module."""
    module_named = {"voxelize", "ball_query", "knn"}
    for name in jops.__all__:
        got = getattr(tops, name)
        if name in module_named:
            got = getattr(got, name)
        assert callable(got), name
    assert set(jops.__all__) == set(tops.__all__[4:]) | module_named


def _knn_inputs(seed=0, b=2, q=300, p=300):
    """Two scenes: exact duplicate points (exact distance ties) in the
    first; only 5 valid points in the second (fewer than k)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (b, p, 3)).astype(np.float32)
    pts[0, 40:60] = pts[0, 0:20]
    queries = rng.uniform(0, 1, (b, q, 3)).astype(np.float32)
    queries[0, :10] = pts[0, :10]
    mask = np.ones((b, p), bool)
    mask[0, 250:] = False
    mask[1] = False
    mask[1, [3, 70, 71, 150, 299]] = True
    return queries, pts, mask


def _hold_knn(got_d, got_i, want_d, want_i, queries, pts, mask, k):
    """The kNN contract of the module docstring; returns the near-tie rows."""
    assert got_i.shape == want_i.shape
    near_ties = 0
    for b in range(want_i.shape[0]):
        exact = ((queries[b][:, None, :].astype(np.float64)
                  - pts[b][None, :, :].astype(np.float64)) ** 2).sum(-1)
        exact = np.where(mask[b][None, :], exact, np.inf)
        srt = np.sort(exact, axis=1)
        for r in np.nonzero((got_i[b] != want_i[b]).any(-1))[0]:
            kth, nxt = srt[r, k - 1], srt[r, k]
            assert np.isfinite(nxt) and nxt - kth <= 1e-5 * max(kth, 1e-12), (b, r)
            assert set(got_i[b, r]) ^ set(want_i[b, r]) <= set(np.nonzero(
                np.abs(exact[r] - kth) <= 1e-5 * max(kth, 1e-12))[0]), (b, r)
            near_ties += 1
    same = got_i == want_i
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-6)
    return near_ties


@pytest.mark.parametrize("tiles", [(1024, 16384), (128, 128)])
def test_knn_matches_jax(tiles):
    """Default tiles (clamped to one 384-lane tile) and 128-wide ones (three
    key tiles, P = 300 not a multiple: padded keys)."""
    k = 8
    queries, pts, mask = _knn_inputs()
    want_d, want_i = _np(_jit_exact(lambda q, p, m: jax_knn(q, p, m, k, *tiles),
                                    queries, pts, mask))
    got_d, got_i = (x.numpy() for x in knn(_t(queries), _t(pts), _t(mask), k, *tiles))
    near_ties = _hold_knn(got_d, got_i, want_d, want_i, queries, pts, mask, k)
    print(f"knn tiles {tiles}: {near_ties} near-tie rows")
    # the second scene has 5 valid points: the other 3 slots are (0, 1e30)
    np.testing.assert_array_equal(got_i[1, :, 5:], 0)
    np.testing.assert_array_equal(got_d[1, :, 5:], np.float32(1e30))
    np.testing.assert_array_equal(want_i[1, :, 5:], 0)
    # exact ties (duplicates) go to the lower index first
    dup = got_i[0, :10]
    assert all(list(r).index(q) < list(r).index(q + 40) for q, r in enumerate(dup) if q + 40 in r)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.default_rng(5)
    unknown = rng.normal(size=(2, 100, 3)).astype(np.float32)
    known = rng.normal(size=(2, 40, 3)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[1, 30:] = False
    feats = rng.normal(size=(2, 5, 40)).astype(np.float32)

    def jax_fn(u, kn, m, f):
        d, i = jops.three_nn(u, kn, m)
        w = jops.three_interpolate_weights(d)
        return d, i, w, jops.three_interpolate(f, i, w)

    wd, wi, ww, wout = _np(_jit_exact(jax_fn, unknown, known, mask, feats))
    d, i = interpolate.three_nn(_t(unknown), _t(known), _t(mask))
    w = interpolate.three_interpolate_weights(d)
    out = interpolate.three_interpolate(_t(feats), i, w)
    _hold_knn(d.numpy() ** 2, i.numpy(), wd ** 2, wi, unknown, known, mask, 3)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_allclose(d.numpy(), wd, rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), ww, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), wout, rtol=1e-5, atol=1e-6)


def test_gather_and_group_points_exact():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 4, 30)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 7)).astype(np.int32)
    gidx = rng.integers(0, 30, (2, 5, 6)).astype(np.int32)
    np.testing.assert_array_equal(interpolate.gather_points(_t(feats), _t(idx)).numpy(),
                                  np.asarray(jops.gather_points(feats, idx)))
    got = interpolate.group_points(_t(feats), _t(gidx)).numpy()
    assert got.shape == (2, 4, 5, 6)
    np.testing.assert_array_equal(got, np.asarray(jops.group_points(feats, gidx)))


def _segments():
    """Rows 0..39 of 3 channels over offsets with an empty segment, a
    segment with a tied maximum in every channel and overflow rows 37-39."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(40, 3)).astype(np.float32)
    feats[20] = feats[24] = feats[20:30].max(0) + 1.0
    offsets = np.array([0, 5, 5, 12, 20, 30, 37], np.int32)
    return feats, offsets


def test_segment_reductions_match_jax():
    feats, offsets = _segments()
    want = _np(_jit_exact(lambda f, o: (jax_seg.sec_mean(f, o), jax_seg.sec_min(f, o),
                                        jax_seg.sec_max(f, o), jax_seg.roipool(f, o)),
                          feats, offsets))
    f, o = _t(feats), torch.from_numpy(offsets)
    got = [segment_ops.sec_mean(f, o), segment_ops.sec_min(f, o), segment_ops.sec_max(f, o),
           segment_ops.roipool(f, o)]
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[2][1] == 0).all() and (got[1][1] == 0).all()  # the empty segment


def test_roipool_gradient_matches_jax_grad():
    """jax.grad through segment_max splits a segment's gradient evenly over
    the rows at its maximum (here two in segment 4); overflow rows get 0."""
    feats, offsets = _segments()
    g = np.random.default_rng(8).normal(size=(6, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax_seg.roipool(x, offsets) * g))(feats))
    x = _t(feats).requires_grad_(True)
    (segment_ops.roipool(x, torch.from_numpy(offsets)) * _t(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(want[20], g[4] / 2, rtol=1e-6)  # the tie is split
    assert (want[37:] == 0).all()


def test_get_iou_matches_jax():
    rng = np.random.default_rng(9)
    prop = rng.random((12, 500)) > 0.5
    gt = rng.random((4, 500)) > 0.7
    sizes = gt.sum(1).astype(np.int32) + 3
    for s in (None, sizes):
        want = np.asarray(jax_seg.get_iou(prop, gt, s))
        got = segment_ops.get_iou(_t(prop), _t(gt), None if s is None else _t(s)).numpy()
        np.testing.assert_array_equal(got, want)


def _proposals(seed=10, q=40, p=300):
    """Overlapping masks of 4 blobs, tied scores, invalid proposals."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, p, 4)
    masks = np.zeros((q, p), bool)
    for i in range(q):
        c = centers[i % 4] + rng.integers(-20, 20)
        masks[i, max(c - rng.integers(10, 60), 0):c + rng.integers(10, 60)] = True
    scores = np.round(rng.random(q), 1).astype(np.float32)  # many exact ties
    valid = rng.random(q) > 0.2
    return masks, scores, valid


@pytest.mark.parametrize("thresh", [0.3, 0.6])
def test_greedy_nms_matches_jax(thresh):
    masks, scores, valid = _proposals()
    want = np.asarray(_jit_exact(lambda m, s, v: jax_nms.greedy_nms(m, s, v, thresh),
                                 masks, scores, valid))
    got = nms.greedy_nms(_t(masks), _t(scores), _t(valid), thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()  # some proposals were suppressed


def _cluster_scene(seed=11):
    """Three blobs of points and a sparse chain; two semantic labels inside
    one blob, background and invalid points."""
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(c, 0.03, (60, 3)) for c in ((0, 0, 0), (1, 0, 0), (0, 1, 0))]
    chain = np.stack([np.linspace(2, 4, 60), np.zeros(60), np.zeros(60)], 1)
    pts = np.concatenate(blobs + [chain]).astype(np.float32)
    sem = np.repeat(np.array([1, 2, 1, 3], np.int32), 60)
    sem[30:60] = 4
    sem[rng.integers(0, 240, 10)] = -100
    valid = rng.random(240) > 0.05
    valid[180:] = True  # an unbroken chain
    return pts, sem, valid


def test_ballquery_dense_matches_jax():
    pts, _, valid = _cluster_scene()
    want = _np(_jit_exact(lambda p, m: jax_cluster.ballquery_dense(p, m, 0.05, 16), pts, valid))
    got = cluster.ballquery_dense(_t(pts), _t(valid), 0.05, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("max_rounds", [None, 2])
def test_connected_components_matches_jax(max_rounds):
    """The chain's diameter (59 hops) outlasts 2 rounds: both packages stop
    there with the same partial labels; with the default rounds both
    converge."""
    pts, _, valid = _cluster_scene()
    idx, _, nbr_valid = jax_cluster.ballquery_dense(jnp.asarray(pts), jnp.asarray(valid), 0.05,
                                                   16)
    idx, nbr_valid = np.asarray(idx), np.asarray(nbr_valid)
    want = np.asarray(_jit_exact(
        lambda i, nv, v: jax_cluster.connected_components(i, nv, v, max_rounds),
        idx, nbr_valid, valid))
    got = cluster.connected_components(_t(idx), _t(nbr_valid), _t(valid), max_rounds).numpy()
    np.testing.assert_array_equal(got, want)
    n_chain_labels = len(np.unique(got[180:][valid[180:]]))
    assert (n_chain_labels > 1) == (max_rounds == 2)


def test_bfs_cluster_matches_jax():
    pts, sem, valid = _cluster_scene()
    want = _np(_jit_exact(lambda s, p, v: jax_cluster.bfs_cluster(s, p, v, 0.05, 16, 25),
                          sem, pts, valid))
    got = cluster.bfs_cluster(_t(sem), _t(pts), _t(valid), 0.05, 16, 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    roots, keep = got
    assert keep.any() and not keep.all()
    assert roots[0] != roots[45]  # one blob, two labels: two clusters
