"""Port K2 (furthest point sampling) vs JAX.

The port's plain version (geoformer_tpu_torch/kernels/fps.py) is held
exactly against geoformer_tpu/ops/fps.py:_fps_scene and the Pallas kernel in
interpret mode (geoformer_tpu/ops/fps_pallas.py); the CUDA kernel against
the plain version on the card (marker ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from geoformer_tpu.ops.fps import _fps_scene
from geoformer_tpu.ops.fps_pallas import fps_pallas_scene
from geoformer_tpu_torch.kernels.edge_cases import fps_cases
from geoformer_tpu_torch.kernels.fps import cluster_size, fps, fps_plain
from geoformer_tpu_torch.ops.fps import furthest_point_sample


def _cases():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 300, 3)).astype(np.float32)
    mask = np.ones((4, 300), bool)
    mask[1, 250:] = False                  # partial (prefix) mask
    mask[2] = rng.random(300) < 0.4        # scattered mask
    mask[3] = False                        # empty scene
    grid = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    ties = np.zeros((1, 300, 3), np.float32)
    ties[0, :125] = grid                   # integer lattice: exact distance ties
    ties[0, 125:] = grid[rng.integers(0, 125, 175)]  # duplicated points
    tmask = np.ones((1, 300), bool)
    return np.concatenate([pts, ties]), np.concatenate([mask, tmask])


@pytest.mark.parametrize("n_samples", [32, 120])
def test_plain_matches_jax(n_samples):
    pts, mask = _cases()
    got_i, got_v = furthest_point_sample(torch.from_numpy(pts), torch.from_numpy(mask), n_samples)
    for b in range(pts.shape[0]):
        want_i, want_v = _fps_scene(jnp.asarray(pts[b]), jnp.asarray(mask[b]), n_samples)
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))


def test_plain_matches_pallas_interpret():
    pts, mask = _cases()
    got = fps(torch.from_numpy(pts), torch.from_numpy(mask), 40).numpy()
    for b in range(pts.shape[0]):
        want = fps_pallas_scene(jnp.asarray(pts[b]), jnp.asarray(mask[b]), 40, interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))


def _chunk_edge_cases():
    """4,100 points: the card samples them on 4 CTAs of 1,025 (chunks of at
    most 2,048 points, a power-of-two count). Lattice duplicates repeat
    across every chunk edge, so the max ties across CTAs and the lowest
    index must win; invalid runs straddle the edges."""
    rng = np.random.default_rng(5)
    grid = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    p = 4100
    dup = np.tile(grid, (p // len(grid) + 1, 1))[:p].astype(np.float32)
    mask = np.ones(p, bool)
    for edge in range(1025, p, 1025):
        mask[edge - 9:edge + 13] = False
    pts = rng.normal(size=(p, 3)).astype(np.float32)
    return {"duplicates": (dup, np.ones(p, bool)), "invalid_across_edges": (pts, mask)}


@pytest.mark.parametrize("case", ["duplicates", "invalid_across_edges"])
def test_plain_matches_jax_across_chunk_edges(case):
    pts, mask = _chunk_edge_cases()[case]
    got = fps_plain(torch.from_numpy(pts[None]), torch.from_numpy(mask[None]), 48)[0].numpy()
    want_i, _ = _fps_scene(jnp.asarray(pts), jnp.asarray(mask), 48)
    np.testing.assert_array_equal(got, np.asarray(want_i))
    want = fps_pallas_scene(jnp.asarray(pts), jnp.asarray(mask), 48, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_empty_scene_repeats_index_zero():
    pts, mask = _cases()
    got = fps_plain(torch.from_numpy(pts[3:4]), torch.from_numpy(mask[3:4]), 16)
    assert got.tolist() == [[0] * 16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [300, 1000, 5003])
def test_kernel_matches_plain_on_card(cuda, p):
    rng = np.random.default_rng(p)
    pts = torch.from_numpy(rng.normal(size=(3, p, 3)).astype(np.float32)).to(cuda)
    mask = torch.ones(3, p, dtype=torch.bool, device=cuda)
    mask[1, p // 2:] = False
    mask[2] = False
    before = fps.launches
    k = fps(pts, mask, 64)
    torch.cuda.synchronize()
    assert fps.launches == before + 1
    assert torch.equal(k, fps_plain(pts, mask, 64))


@pytest.mark.cuda
def test_kernel_matches_plain_on_corner_cases(cuda):
    """Every corner case of the cluster design (kernels/edge_cases.py),
    bit-equal to the plain version; the 4,100-point scene of the CPU test
    runs on 4 CTAs, the 100,000-point one above the one-CTA design's cap."""
    assert cluster_size(4100) == 4 and cluster_size(100000) == 16
    for name, pts, mask, n in fps_cases():
        pts, mask = torch.from_numpy(pts).to(cuda), torch.from_numpy(mask).to(cuda)
        assert torch.equal(fps(pts, mask, n), fps_plain(pts, mask, n)), name
