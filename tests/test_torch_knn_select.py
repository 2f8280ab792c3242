"""Port K1 (k-smallest candidate selection) and the radius graph vs JAX.

The port's plain version of geoformer_tpu_torch/kernels/knn_select.py is
held exactly against the Pallas kernel in interpret mode
(geoformer_tpu/ops/knn_select_pallas.py) and against lax.top_k; the port's
radius_knn against the JAX radius_knn with select="pallas". The CUDA kernel
itself is held against the plain version on the card (marker ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.ops.knn_select_pallas import select_min_k_cand as jax_select
from geoformer_tpu.ops.radius_graph import radius_knn as jax_radius_knn
from geoformer_tpu_torch.kernels.edge_cases import knn_cases, knn_rows
from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand, select_min_k_cand_plain
from geoformer_tpu_torch.ops.radius_graph import radius_knn


def _table(seed, n, w):
    rng = np.random.default_rng(seed)
    d2 = rng.uniform(0, 1, size=(n, w)).astype(np.float32)
    d2[rng.random((n, w)) < 0.3] = 1e30
    d2[5] = 1e30                      # fully dead row
    d2[7, :6] = 0.25                  # ties
    d2[9, ::7] = 0.5                  # ties spread over the row
    d2[12] = 1e30
    d2[12, :3] = [0.1, 0.2, 0.3]      # fewer than k live lanes
    cand = rng.integers(0, 1000, size=(n, w)).astype(np.int32)
    return d2, cand


@pytest.mark.parametrize("n,w,k", [(300, 70, 16), (64, 200, 8), (40, 648, 16)])
def test_plain_matches_pallas_and_topk(n, w, k):
    """Values exactly equal to the Pallas kernel and to lax.top_k; ids
    exactly equal to lax.top_k everywhere and to the Pallas kernel on live
    lanes (on exhausted rows the Pallas kernel repeats one dead lane, the
    stable order takes the next dead lanes; both die at the caller's gate)."""
    d2, cand = _table(n + w, n, w)
    got_v, got_i = select_min_k_cand(torch.from_numpy(d2), torch.from_numpy(cand), k)
    got_v, got_i = got_v.numpy(), got_i.numpy()

    neg, pos = jax.lax.top_k(-jnp.asarray(d2), k)
    top_v = np.asarray(-neg)
    top_i = np.asarray(jnp.take_along_axis(jnp.asarray(cand), pos, axis=1))
    np.testing.assert_array_equal(got_v, top_v)
    np.testing.assert_array_equal(got_i, top_i)

    pal_v, pal_i = jax_select(jnp.asarray(d2), jnp.asarray(cand), k, block_rows=64,
                              interpret=True)
    live = top_v < 1e30
    np.testing.assert_array_equal(got_v, np.asarray(pal_v))
    np.testing.assert_array_equal(got_i[live], np.asarray(pal_i)[live])


@pytest.mark.parametrize("w", [70, 648])
def test_plain_matches_jax_at_threshold_ties_and_exhausted_rows(w):
    """The corner rows of the card kernel's threshold design (ties at the
    16th value, 8 equal values then dead lanes, fewer than 16 live lanes,
    fully dead rows, the smallest values in one or in 15 threads' slots),
    NaN and signed-zero rows left out: values exactly equal to lax.top_k and
    to the Pallas kernel, ids to lax.top_k everywhere and to the Pallas
    kernel on live lanes."""
    d2 = knn_rows(w)
    d2 = d2[~np.isnan(d2).any(1)]
    cand = np.random.default_rng(w).integers(0, 1 << 20, d2.shape).astype(np.int32)
    got_v, got_i = select_min_k_cand(torch.from_numpy(d2), torch.from_numpy(cand), 16)
    neg, pos = jax.lax.top_k(-jnp.asarray(d2), 16)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(-neg))
    np.testing.assert_array_equal(
        got_i.numpy(), np.asarray(jnp.take_along_axis(jnp.asarray(cand), pos, axis=1)))
    pal_v, pal_i = jax_select(jnp.asarray(d2), jnp.asarray(cand), 16, block_rows=64,
                              interpret=True)
    live = got_v.numpy() < 1e30
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(pal_v))
    np.testing.assert_array_equal(got_i.numpy()[live], np.asarray(pal_i)[live])
    assert (~live).any() and live.any()


def _jit_exact(f, *args):
    """f(*args) compiled by XLA without backend optimisation: one program,
    with the rounding of op-by-op execution (no contracted multiply-adds)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _scene(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        rng.uniform(0, 0.6, size=(400, 3)),
        np.full((40, 3), 0.3) + rng.normal(0, 1e-3, size=(40, 3)),  # dense clump
        np.full((8, 3), 0.45),                                       # exact duplicates
    ]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[-11:-3] = False
    return pts, mask


@pytest.mark.parametrize("cap,k,div", [(16, 8, 2), (24, 16, 1), (4, 16, 2)])
def test_radius_knn_matches_jax(cap, k, div):
    """d2 and ids exactly equal to the JAX radius_knn with the Pallas
    selection (interpret mode), and the drop counters equal."""
    pts, mask = _scene(cap * k)
    jd, ji, jdrop, jwin = _jit_exact(
        lambda p, m: jax_radius_knn(p, m, 0.1, k, cell_cap=cap, cell_div=div, dense_grid=256,
                                    select="pallas", with_stats=True),
        jnp.asarray(pts[None]), jnp.asarray(mask[None]))
    td, ti, tdrop, twin = radius_knn(
        torch.from_numpy(pts[None]), torch.from_numpy(mask[None]), 0.1, k, cell_cap=cap,
        cell_div=div, dense_grid=256, select="pallas")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,k", [(300, 70, 16), (1000, 648, 16), (33, 1024, 8)])
def test_kernel_matches_plain_on_card(cuda, n, w, k):
    d2, cand = _table(n * 3 + w, n, w)
    d2 = torch.from_numpy(d2).to(cuda)
    cand = torch.from_numpy(cand).to(cuda)
    before = select_min_k_cand.launches
    kv, ki = select_min_k_cand(d2, cand, k)
    pv, pi = select_min_k_cand_plain(d2, cand, k)
    torch.cuda.synchronize()
    assert select_min_k_cand.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.cuda
def test_kernel_matches_plain_on_corner_cases(cuda):
    """Every corner case of the threshold design (kernels/edge_cases.py: ties
    at the threshold, exhausted and dead rows, the smallest values in one
    thread's slots or in 15, NaN and -0.0, W = 16, 70, 648, 1024, k = W),
    bit-equal to the plain version; both of the kernel's paths run."""
    exact = {}
    for name, d2, cand, k in knn_cases():
        d2, cand = torch.from_numpy(d2).to(cuda), torch.from_numpy(cand).to(cuda)
        rows = torch.zeros(1, dtype=torch.int32, device=cuda)
        kv, ki = select_min_k_cand(d2, cand, k, exact_rows=rows)
        pv, pi = select_min_k_cand_plain(d2, cand, k)
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32)), name
        assert torch.equal(ki, pi), name
        exact[name] = int(rows)
    assert exact["w70_k70"] == exact["w1024_k1024"] == 32  # k > 32: every row
    assert exact["w648_k16"] > 0 and exact["w648_k1"] == 0
