"""Port K4 (the submanifold conv's forward, input gradient and weight
gradient): its maps, its plain path, its check, and the kernels on the card.

On the CPU: the plan's transposed maps (the mirrored map on a full plan,
the exact transpose on a compacted one), the plain conv (the CPU path) and
its autograd through ``kernels/edge_cases.py:subm_check`` (within its
limits of the float64 reference, and each planted fault above them), its
bf16 roundings, and the compacted path. On the card (marker ``cuda``): each
kernel within ``subm_check``'s limits, every planted fault above them,
deterministic, and its refusals. No JAX here, so the card tests run where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_subm_conv.py
"""

import numpy as np
import pytest
import torch

from geoformer_tpu_torch import kernels
from geoformer_tpu_torch.kernels import subm_conv as k4
from geoformer_tpu_torch.kernels.edge_cases import (
    SUBM_CASES,
    subm_check,
    subm_operands,
    subm_plain_run,
    subm_plans,
)
from geoformer_tpu_torch.ops import sparse_conv
from geoformer_tpu_torch.ops.sparse_conv import build_grid_plan, voxel_capacities


def _plan(subm_k=None, seed=0):
    """Two small scans (the second partly masked) at 2 levels."""
    rng = np.random.default_rng(seed)
    coords = torch.as_tensor(rng.integers(0, 12, (2, 500, 3)))
    mask = torch.ones(2, 500, dtype=torch.bool)
    mask[1, 350:] = False
    return build_grid_plan(coords, mask, 12, 2, voxel_capacities(640, 2), subm_k=subm_k)


def test_plan_maps_are_int32_and_their_transpose_is_the_mirror():
    """A full plan's rulebooks: the map itself (int32) and its transpose
    from one scatter, built when first asked for, equal to the mirrored map
    nbr[:, :, 26 - k]."""
    plan = _plan()
    for nbr, rb, grid in zip(plan.subm, plan.rulebooks, plan.grids):
        assert rb.nbr is nbr and "nbr_t" not in vars(rb)
        assert nbr.dtype == rb.nbr_t.dtype == rb.n_voxels.dtype == torch.int32
        assert rb.nbr_t is rb.nbr_t and rb.nbr_t.is_contiguous()
        assert torch.equal(rb.nbr_t, nbr.flip(-1))
        assert torch.equal(rb.n_voxels, grid.n_voxels.int())
        # rows past a scene's voxels neither read nor are read
        past = torch.arange(nbr.shape[1])[None] >= grid.n_voxels[:, None]
        v = nbr.shape[1]
        assert bool((nbr[past] == v).all()) and bool((rb.nbr_t[past] == v).all())
        assert bool((nbr < v).any())


def test_transpose_is_exact_on_a_compacted_plan():
    """tpu_subm_k = 4 drops live offsets, so the expanded map is no longer
    symmetric: its transpose differs from its mirror, and is exact (entry
    [b, i, k] = o just where the map has [b, o, k] = i)."""
    plan = _plan(subm_k=4)
    dropped = False
    for rb, (idx, oid) in zip(plan.rulebooks, plan.subm_compact):
        nbr = rb.nbr.numpy()
        assert torch.equal(rb.nbr, sparse_conv.expand_compact(idx, oid))
        b, v, k = nbr.shape
        want = np.full_like(nbr, v)
        for s, o, kk in zip(*np.nonzero(nbr < v)):
            assert want[s, nbr[s, o, kk], kk] == v  # one reader a (row, offset)
            want[s, nbr[s, o, kk], kk] = o
        np.testing.assert_array_equal(rb.nbr_t.numpy(), want)
        dropped |= not np.array_equal(want, nbr[:, :, ::-1])
    assert dropped


def _grads(feats, rb, w, cd, grad):
    """The CPU path (``apply_subm`` over a plan's Rulebook) and its autograd."""
    f, ww = feats.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = sparse_conv.apply_subm(f, rb, ww, cd)
    out.backward(grad)
    return out.detach(), f.grad, ww.grad


@pytest.mark.parametrize("cd", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(6, 16), (16, 16), (32, 16), (48, 24)])
def test_check_passes_the_plain_conv_and_catches_planted_faults(cd, cin, cout):
    """subm_check on the plain conv and its autograd (1, 2 and 4 chunks of
    offsets wide at 48, 32 and 16 channels): deterministic, each gap to the
    float64 reference within K4's limit, and each planted fault (an offset
    dropped, half the row tiles skipped, a dW slab zeroed) above it. The
    bf16 input gradient, which also rounds each chunk's sum, reads above
    K4's limit and below every fault's gap. The CPU path through a plan's
    Rulebook gives the same bits."""
    rb = _plan().rulebooks[0]
    feats, w, grad = subm_operands(rb, cin, cout, seed=cin + cout)
    res = subm_check(feats, rb, w, grad, cd, run=subm_plain_run(rb, cd))
    faults = res["faults"]
    assert all(r is not None and r > 1.0 for r in faults.values()), faults
    for name in ("fwd", "dgrad", "wgrad"):
        r = res[name]
        assert r["deterministic"], name
        if name == "dgrad" and cd is not None:
            least = min(v for f, v in faults.items() if f.startswith("dgrad"))
            assert 1.0 < r["ratio"] < least, (r, faults)
        else:
            assert r["ratio"] <= 1.0, (name, r)
    run = subm_plain_run(rb, cd)
    got = _grads(feats, rb, w, cd, grad)
    for name, g in zip(("fwd", "dgrad", "wgrad"), got):
        assert g.dtype == torch.float32 and torch.equal(g, run[name](feats, w, grad))


def test_plain_gradients_round_each_read_and_chunk_to_bf16():
    """With bf16 operands the CPU path's input gradient is a sum of bf16
    values (each read's gradient and each chunk's sum rounded), so it is a
    bf16 value itself, and it differs from the float32 operands' gradient;
    a map as the JAX tests pass it (int64) gives the same, and no kernel is
    launched."""
    rb = _plan().rulebooks[1]
    feats, w, grad = subm_operands(rb, 16, 16, seed=3)
    before = kernels.launches()
    _, dx, dw = _grads(feats, rb, w, torch.bfloat16, grad)
    assert torch.equal(dx, dx.bfloat16().float())
    assert not torch.equal(dx, _grads(feats, rb, w, None, grad)[1])
    long_map = sparse_conv.Rulebook(rb.nbr.long(), rb.n_voxels)
    assert torch.equal(dx, _grads(feats, long_map, w, torch.bfloat16, grad)[1])
    assert torch.equal(dw, dw.bfloat16().float())
    assert kernels.launches() == before


def test_compact_rulebook_conv_equals_the_table_conv():
    """The U-Net's compacted path (the plan's Rulebook of the expanded map)
    and ``subm_conv_compact`` on the (idx, oid) table give the same conv."""
    plan = _plan(subm_k=4)
    rb, (idx, oid) = plan.rulebooks[0], plan.subm_compact[0]
    feats, w, _ = subm_operands(rb, 16, 8, seed=5)
    assert torch.equal(sparse_conv.apply_subm(feats, rb, w, torch.bfloat16),
                       sparse_conv.subm_conv_compact(feats, idx, oid, w, torch.bfloat16))


# ---------------- on the card ----------------


@pytest.fixture(scope="module")
def plans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return subm_plans("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [c[0] for c in SUBM_CASES])
def test_kernels_match_plain_on_card(plans, case, cd):
    """Forward, input and weight gradient within subm_check's limits of the
    float64 reference, each kernel bit-equal to itself on a second run,
    every planted fault that changes a result above the limit (at level 0,
    all six change it), and each launch counted."""
    _, plan, level, cin, cout = next(c for c in SUBM_CASES if c[0] == case)
    rb = plans[plan].rulebooks[level]
    feats, w, grad = subm_operands(rb, cin, cout, seed=level)
    before = kernels.launches()
    res = subm_check(feats, rb, w, grad, cd)
    torch.cuda.synchronize()
    after = kernels.launches()
    for name in ("subm_conv", "subm_conv_dgrad", "subm_conv_wgrad"):
        assert after[name] == before[name] + 3, name
    for name in ("fwd", "dgrad", "wgrad"):
        assert res[name]["deterministic"], name
        assert res[name]["ratio"] <= 1.0, (name, res[name])
    assert all(r is None or r > 1.0 for r in res["faults"].values()), res["faults"]
    if level == 0:
        assert None not in res["faults"].values(), res["faults"]


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(plans):
    """float64 operands, a non-contiguous feature table, a CPU map with a
    CUDA table, an int64 map and an input gradient without the transposed
    map raise, and launch nothing."""
    rb = plans["pads"].rulebooks[0]
    feats, w, grad = subm_operands(rb, 16, 16)
    before = kernels.launches()
    wide = torch.cat([feats, feats], -1)[..., :16]
    for f, n, ww in ((feats.double(), rb.nbr, w.double()), (wide, rb.nbr, w),
                     (feats, rb.nbr.cpu(), w), (feats, rb.nbr.long(), w)):
        with pytest.raises(ValueError):
            k4.subm_fwd(f, n, ww, torch.bfloat16, rb.n_voxels)
    with pytest.raises(ValueError):
        k4.subm_dgrad(grad.double(), rb.nbr_t, w.double())
    with pytest.raises(ValueError):
        k4.subm_dgrad(grad, None, w)
    with pytest.raises(ValueError):
        k4.subm_wgrad(feats, rb.nbr.cpu(), grad, w)
    assert kernels.launches() == before
