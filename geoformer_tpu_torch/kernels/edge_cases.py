"""Corner cases of the K1, K2 and K3 kernels' designs, as seeded numpy inputs,
and K4's (the submanifold conv) rulebooks and operands with its check.

Each case names what it exercises. The card tests
(``tests/test_torch_{fps,knn_select,gather}.py``) and the ``kernel_edges``
phase of ``chip_smoke.py`` hold each of K1-K3 bit-equal to its plain version on
them,
and K1's exact-path rows to the rows that its design must sort or must send
to its exact path (``knn_path_rows``); the CPU tests hold the plain versions
against JAX on the ones JAX can take. K4 sums in another order than its
plain version, so ``subm_check`` holds it to a float64 reference within
limits set from sound runs, and checks that planted faults exceed them
(``tests/test_torch_subm_conv.py`` and ``kernel_edges`` on ``SUBM_CASES``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_BIG = 1e30  # dead-candidate sentinel of the radius graph


def _lattice(n: int, rng) -> np.ndarray:
    """n points on a 5x5x5 integer lattice: exact distance ties everywhere."""
    grid = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return grid[rng.integers(0, len(grid), n)].astype(np.float32)


def fps_cases(seed: int = 0, large: bool = True) -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """(name, points [B,P,3] f32, mask [B,P] bool, n_samples) for K2.

    Chunk edges are those of the cluster the kernel picks for P (C the
    smallest power of two keeping a CTA at <= 2,048 points, at most 16):
    P = 20,000 runs on 16 CTAs of 1,250 points, P = 16,384 on 8 of 2,048."""
    rng = np.random.default_rng(seed)

    def normal(b, p):
        return rng.normal(size=(b, p, 3)).astype(np.float32)

    cases = []
    # P a multiple of neither the cluster size nor the block
    for p in (5003, 33333):
        cases.append((f"ragged_p{p}", normal(1, p), np.ones((1, p), bool), 128))
    cases.append(("one_point", normal(1, 1), np.ones((1, 1), bool), 8))
    cases.append(("all_invalid", normal(1, 9000), np.zeros((1, 9000), bool), 16))
    # invalid runs across the chunk edges at multiples of 1,250
    m = np.ones((1, 20000), bool)
    for edge in range(1250, 20000, 1250):
        m[0, edge - 37:edge + 41] = False
    m[0, :1] = False  # pick 0 is index 0 even when it is invalid
    cases.append(("invalid_across_chunk_edges", normal(1, 20000), m, 256))
    # duplicates: the same lattice in every chunk, so the max ties across
    # CTAs and the lowest index must win
    dup = np.tile(_lattice(4096, rng), (4, 1))[None]
    cases.append(("duplicates_across_ctas", dup, np.ones((1, 16384), bool), 160))
    cases.append(("lattice_ties", _lattice(20000, rng)[None], np.ones((1, 20000), bool), 160))
    m = np.ones((3, 12000), bool)
    m[1, 7000:] = False
    m[2] = rng.random(12000) < 0.3
    cases.append(("three_scenes", normal(3, 12000), m, 96))
    m = np.zeros((1, 9000), bool)
    m[0, rng.choice(9000, 100, replace=False)] = True
    cases.append(("samples_over_valid", normal(1, 9000), m, 300))
    if large:  # above the one-CTA kernel's 57,856-point cap
        cases.append(("p100000", normal(1, 100000), np.ones((1, 100000), bool), 512))
    return cases


def knn_rows(w: int, seed: int = 0) -> np.ndarray:
    """d2 [n, w] f32 whose rows cycle through the K1 design's corner cases."""
    rng = np.random.default_rng(seed + w)
    rows = []
    lanes = np.arange(w)

    def uniform():
        r = rng.uniform(0, 1, w).astype(np.float32)
        r[rng.random(w) < 0.5] = _BIG
        return r

    for _ in range(4):
        rows.append(uniform())
        # ties at the threshold and at the k-th value: few distinct values
        rows.append((rng.integers(0, 4, w) / 4).astype(np.float32))
        r = np.full(w, _BIG, np.float32)
        r[:8] = 0.5                                  # 8 equal, then exhausted
        rows.append(r)
        # fewer than k live lanes (all others the 1e30 sentinel)
        r = np.full(w, _BIG, np.float32)
        r[rng.choice(w, min(w, 5), replace=False)] = rng.uniform(0, 1, min(w, 5))
        rows.append(r)
        rows.append(np.full(w, _BIG, np.float32))    # fully dead
        # the smallest values all in one thread's slots (lane 5 of the warp)
        r = rng.uniform(1, 2, w).astype(np.float32)
        r[lanes % 32 == 5] = rng.uniform(0, 1, int((lanes % 32 == 5).sum()))
        rows.append(r)
        # the smallest values in 15 threads' slots: many elements below the
        # threshold, the kernel's exact path
        r = rng.uniform(1, 2, w).astype(np.float32)
        few = lanes % 32 < 15
        r[few] = rng.uniform(0, 1, int(few.sum()))
        rows.append(r)
        # NaN and both zeros
        r = uniform()
        r[rng.random(w) < 0.2] = np.nan
        r[rng.random(w) < 0.1] = 0.0
        r[rng.random(w) < 0.1] = -0.0
        r[rng.random(w) < 0.05] = -1.0
        rows.append(r)
    return np.stack(rows).astype(np.float32)


def knn_wide_rows(w: int, seed: int = 0) -> tuple[list[str], np.ndarray]:
    """(labels, d2 [n, w] f32): rows for K1's 32 < k <= 64 design, which
    sorts the elements at or below a threshold taken from the lanes' pair
    values (each lane's two smallest) when there are at most 128 of them.
    Live lanes hold d2 < 1e30, dead lanes the 1e30 sentinel."""
    rng = np.random.default_rng(seed + 7 * w)
    labels, rows = [], []

    def dead():
        return np.full(w, _BIG, np.float32)

    def add(label, r):
        labels.append(label)
        rows.append(r)

    def live_at(lanes):
        r = dead()
        r[lanes] = rng.uniform(0, 1, len(lanes))
        return r

    # the exact geodesic solver's rows: the radius graph's 27 cells of
    # w // 27 slots, each with its points first, some of them in radius
    # (at most 44 lanes live on a real scene's table), 1e30 elsewhere
    cap = w // 27
    for n_live in (1, 5, 20, 33, 44):
        r = dead()
        while (r < _BIG).sum() < n_live:
            cell = rng.integers(27)
            r[cell * cap + rng.integers(min(cap, 8))] = rng.uniform(0, 1)
        add(f"solver_{n_live}_live", r)
    for n_live in (44, 63, 64, 65):                  # spread over the row
        add(f"random_{n_live}_live", live_at(rng.choice(w, n_live, replace=False)))
    # one live lane in slot 0 of each lane: the pairs' seconds are the dead
    # slot 1 (j = 32 + lane), tau among them
    add("pairs_dead_slot1", live_at(np.arange(32)))
    # half the lanes' one live value in a high slot: their pairs hold a
    # dead slot 0
    add("pairs_dead_slot0", live_at(np.r_[np.arange(16), 32 * (w // 64) + np.arange(16, 32)]))
    # ties straddling tau: a few distinct values over 48 and over 100 lanes
    for n_live in (48, 100):
        r = dead()
        r[rng.choice(w, n_live, replace=False)] = rng.integers(1, 4, n_live) / 4
        add(f"ties_{n_live}_live", r)
    # 64 < c <= 128: 90 live lanes, most in the first two slots
    r = live_at(np.r_[np.arange(64), rng.choice(np.arange(64, w), 26, replace=False)])
    add("c_64_to_128", r)
    # live everywhere: c near 128 at k = 64
    add("all_live", rng.uniform(0, 1, w).astype(np.float32))
    # c > 128 at every 32 < k <= 64 (the exact path): the smallest values
    # packed in 7 lanes' slots, more than 128 of them; only 14 pair values
    # lie among them
    r = rng.uniform(1, 2, w).astype(np.float32)
    r[np.arange(w) % 32 < 7] = rng.uniform(0, 1, int((np.arange(w) % 32 < 7).sum()))
    add("packed_in_7_lanes", r)
    # NaN, +0.0 and -0.0 among few live lanes, and a row mostly NaN
    r = live_at(rng.choice(w, 30, replace=False))
    r[rng.choice(w, 40, replace=False)] = np.nan
    r[rng.choice(w, 10, replace=False)] = 0.0
    r[rng.choice(w, 10, replace=False)] = -0.0
    add("nan_and_zeros", r)
    r = np.full(w, np.nan, np.float32)
    r[rng.choice(w, 20, replace=False)] = rng.choice([0.0, -0.0, 0.5], 20)
    add("mostly_nan", r)
    return labels, np.stack(rows).astype(np.float32)


def knn_path_rows(name: str, d2: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows K1 must sort, rows it must send to its exact path) of the case
    ``name`` of ``knn_cases``, as boolean masks, by construction: k = 1
    sorts every row (one element at or below the least lane minimum); for
    32 < k <= 64, every row with fewer than 64 lanes below 1e30 (and no
    NaN) sorts (see csrc/knn_select.cu: c <= L + 64), as does the wide row
    live in slots 0 and 1 of every lane, and the rows packed in 7 lanes
    take the exact path; k > 64 takes the exact path on every row. Rows
    in neither mask may go either way."""
    n = len(d2)
    none = np.zeros(n, bool)
    if k > 64:
        return none, ~none
    if k == 1:
        return ~none, none
    if k <= 32:
        return none, none
    few = ((d2 < _BIG).sum(1) < 64) & ~np.isnan(d2).any(1)
    if "_wide_" not in name:
        return few, none
    labels = np.array(knn_wide_rows(d2.shape[1])[0])
    return few | (labels == "c_64_to_128"), labels == "packed_in_7_lanes"


def knn_cases(seed: int = 0) -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """(name, d2 [n,W] f32, cand [n,W] i32, k) for K1: W = 16, 70, 648 and
    1024, k from 1 to W, on the rows of ``knn_rows``; and W = 648 with
    k = 33, 48, 63, 64 and W = 1024 with k = 64 on the rows of
    ``knn_wide_rows``. W = 648 with k = 64 is the exact geodesic solver's
    graph."""
    cases = []
    for w, ks in ((16, (1, 16)), (70, (16, 32, 70)), (648, (1, 8, 16, 32, 64)),
                  (1024, (16, 1024))):
        d2 = knn_rows(w, seed)
        cand = np.random.default_rng(seed + 1).integers(0, 1 << 20, d2.shape).astype(np.int32)
        for k in ks:
            cases.append((f"w{w}_k{k}", d2, cand, k))
    for w, ks in ((648, (33, 48, 63, 64)), (1024, (64,))):
        d2 = knn_wide_rows(w, seed)[1]
        cand = np.random.default_rng(seed + 2).integers(0, 1 << 20, d2.shape).astype(np.int32)
        for k in ks:
            cases.append((f"w{w}_wide_k{k}", d2, cand, k))
    return cases


# K3's width classes (csrc/row_gather.cu): as 16-byte units (q a multiple
# of 4, aligned) rows of 1, 2, 4, 8, 16, 32 units (G lanes a row), 33-64
# (two units a lane) and over 64 (the per-unit kernel); as words the same
# classes at odd q and in misaligned views
GATHER_WIDTHS = (1, 2, 3, 4, 7, 8, 13, 16, 27, 32, 50, 64, 128, 256, 1000)
# ids enough that every class at or under 64 units takes R = 4 rows a
# thread on a card of 132 SMs (n x G / 32 warps >= 2112); 777 ids take R = 1
GATHER_MANY_IDS = 40000


@functools.lru_cache(maxsize=2)
def gather_cases(seed: int = 0) -> tuple[tuple[str, np.ndarray, np.ndarray, bool], ...]:
    """(name, x [P,q] f32, idx [n] i32, misaligned) for K3: every width class
    of its design (``GATHER_WIDTHS``) by 777 ids, aligned and as a
    16-byte-misaligned table view (``gather_table``, which takes words), and
    by ``GATHER_MANY_IDS`` ids, so that each instantiation the kernel picks
    runs on either side of its R threshold; the probe's and the foreground
    gather's shapes; more rows than one wave of blocks covers at q = 128 (the
    grid-stride loop); n = 1, P = 1 and one id repeated. Tables hold NaNs
    with a payload and -0.0; ids include 0 and P - 1, repeated."""
    rng = np.random.default_rng(seed)

    def table(p, q):
        x = rng.normal(size=(p, q)).astype(np.float32)
        x.reshape(-1).view(np.uint32)[::3] |= 0x7FC00123  # NaNs with a payload
        x[p // 2] = -0.0
        return x

    def ids(p, n):
        i = rng.integers(0, p, n).astype(np.int32)
        i[:4] = (0, p - 1, p - 1, 0)
        return i

    cases = []
    for q in GATHER_WIDTHS:
        x, i = table(997, q), ids(997, 777)
        cases += [(f"q{q}", x, i, False), (f"q{q}_misaligned", x, i, True)]
        if q <= 256:  # wider rows take the per-unit kernel at any count
            cases.append((f"q{q}_n{GATHER_MANY_IDS}", x, ids(997, GATHER_MANY_IDS), False))
    cases += [("probe_512x128_n256", table(512, 128), ids(512, 256), False),
              ("fg_250000x16_n131072", table(250000, 16), ids(250000, 131072), False),
              ("grid_stride_q128_n60000", table(5000, 128), ids(5000, 60000), False),
              ("n1", table(50, 16), np.array([49], np.int32), False),
              ("p1", table(1, 128), np.zeros(5, np.int32), False),
              ("n1_p1_q3", table(1, 3), np.zeros(1, np.int32), True),
              ("one_id_repeated", table(300, 16), np.full(1000, 17, np.int32), False)]
    return tuple(cases)


def gather_table(x: np.ndarray, misaligned: bool, device) -> torch.Tensor:
    """x as a contiguous [P, q] f32 tensor on ``device``; ``misaligned``: a
    view that starts one word into its buffer, so not 16-byte aligned."""
    flat = torch.empty(x.size + 1, dtype=torch.float32, device=device)
    view = flat[int(misaligned):int(misaligned) + x.size].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


# ---------------- K4: the submanifold conv ----------------

# (name, plan, level, Cin, Cout): the training cell's level-0 convs (the
# input conv's Cin = 6, a block's 16, a tail's 2c = 32), a level-5 tail and
# level 6 (V = 4,096, 112 wide), one scene, a compacted (tpu_subm_k = 8) map,
# and scenes with pad rows and an empty scene at widths off every tile edge
SUBM_CASES = (
    ("cell_l0_16x16", "cell", 0, 16, 16),
    ("cell_l0_input_6x16", "cell", 0, 6, 16),
    ("cell_l0_tail_32x16", "cell", 0, 32, 16),
    ("cell_l5_tail_192x96", "cell", 5, 192, 96),
    ("cell_l6_112x112", "cell", 6, 112, 112),
    ("b1_l1_32x32", "b1", 1, 32, 32),
    ("compact_k8_l0_16x16", "compact", 0, 16, 16),
    ("pads_l0_24x40", "pads", 0, 24, 40),
    ("pads_l1_7x9", "pads", 1, 7, 9),
)
SUBM_SCALE, SUBM_SPATIAL = 50, 1024  # the configs' 2 cm voxels on a 1,024 grid


def _scan_coords(rng, n_scenes: int, points: int) -> np.ndarray:
    """[n, points, 3] int voxel coords of synthetic room scans."""
    from geoformer_tpu_torch.synthetic import room_points

    limit = (SUBM_SPATIAL - 1) / SUBM_SCALE - 0.05
    pts = np.stack([np.clip(room_points(rng, points), 0.05, limit) for _ in range(n_scenes)])
    return np.floor(pts * SUBM_SCALE).astype(np.int64)


def subm_plans(device, seed: int = 0) -> dict:
    """The plans of ``SUBM_CASES``: ``cell``, 8 scans of 250,000 points at
    the shipped capacities (262,144 voxels, depth 7); ``b1``, one of them;
    ``compact``, that one with tpu_subm_k = 8; ``pads``, 3 scans of 20,000
    points at 32,768 voxels, depth 2, the second scene empty and the third
    half masked."""
    from geoformer_tpu_torch.ops.sparse_conv import build_grid_plan, voxel_capacities

    rng = np.random.default_rng(seed)
    cell = torch.from_numpy(_scan_coords(rng, 8, 250000)).to(device)
    full = torch.ones(cell.shape[:2], dtype=torch.bool, device=device)
    caps = voxel_capacities(262144, 7)
    small = torch.from_numpy(_scan_coords(rng, 3, 20000)).to(device)
    mask = torch.ones(small.shape[:2], dtype=torch.bool, device=device)
    mask[1] = False
    mask[2, 10000:] = False
    return {
        "cell": build_grid_plan(cell, full, SUBM_SPATIAL, 7, caps),
        "b1": build_grid_plan(cell[:1], full[:1], SUBM_SPATIAL, 7, caps),
        "compact": build_grid_plan(cell[:1], full[:1], SUBM_SPATIAL, 7, caps, subm_k=8),
        "pads": build_grid_plan(small, mask, SUBM_SPATIAL, 2, voxel_capacities(32768, 2)),
    }


def subm_operands(rb, cin: int, cout: int, seed: int = 0):
    """(feats [B,V,Cin], w [27,Cin,Cout], grad [B,V,Cout]) f32 on the
    rulebook's device, normal; rows past a scene's voxels hold values too,
    which nothing may read."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, v = rb.nbr.shape[:2]
    feats = torch.randn(b, v, cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5
    grad = torch.randn(b, v, cout, generator=g)
    return tuple(t.to(rb.nbr.device) for t in (feats, w, grad))


# The largest gap that a run of K4 may read, by direction and operand
# type: the norm of (result - float64 reference) over the reference's norm,
# in each slab (a scene's rows of the forward and the input gradient, an
# offset's dW[k] of the weight gradient; ``subm_check``). Each is the first
# of 1, 2, 3, 5 x 10^n at or above ten times the largest reading of the
# kernel on every case of ``SUBM_CASES`` at three seeds on an H100 (PERF.md,
# K4): 9.3e-7, 2.9e-6 (the tensor cores' sums), 2.0e-7, 1.2e-4, 7.2e-7 and
# 3.9e-4 (a few dW values one bf16 step off, up to 2^-8 of a slab's norm).
# The planted faults read 6e-2 and more. The plain versions read within
# them, except the bf16 input gradient (up to 5.0e-3): its autograd also
# rounds each chunk's sum of offsets.
SUBM_LIMITS = {
    ("fwd", "float32"): 1e-5, ("fwd", "bfloat16"): 3e-5,
    ("dgrad", "float32"): 3e-6, ("dgrad", "bfloat16"): 2e-3,
    ("wgrad", "float32"): 1e-5, ("wgrad", "bfloat16"): 5e-3,
}
SUBM_TILE = 64  # rows of a tile, as the kernels' blocks take them


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B,V,C], idx [B,V] in [0, V] -> t[b, idx[b, o]], zeros for V."""
    b, _, c = t.shape
    padded = torch.cat([t, t.new_zeros(b, 1, c)], 1)
    return torch.gather(padded, 1, idx.long()[..., None].expand(-1, -1, c))


def subm_reference(feats, rb, w, grad, compute_dtype) -> dict:
    """The conv's forward, input gradient and weight gradient in float64,
    offset by offset over the rulebook ``rb``, on the operands as the
    kernels take them (features and weights rounded to ``compute_dtype``;
    the output gradient float32) and at the kernels' rounding points: with
    bf16, each read's gradient (one offset's product) is rounded to bf16 and
    so are the input gradient's sum and the weight gradient."""
    nbr = rb.nbr
    b, v, cin = feats.shape
    cout = w.shape[-1]
    cd = compute_dtype

    def rounded(t):
        return t.double() if cd is None else t.to(cd).double()

    x, wk, g = rounded(feats), rounded(w), grad.double()
    fwd = torch.zeros(b, v, cout, dtype=torch.float64, device=feats.device)
    dx = torch.zeros(b, v + 1, cin, dtype=torch.float64, device=feats.device)
    dw = torch.zeros(w.shape, dtype=torch.float64, device=feats.device)
    for k in range(w.shape[0]):
        read = _rows(x, nbr[..., k])
        fwd += read @ wk[k]
        dx.scatter_add_(1, nbr[..., k].long()[..., None].expand(-1, -1, cin),
                        rounded(g @ wk[k].T))  # reads of the zero row land in row V
        dw[k] = read.reshape(-1, cin).T @ g.reshape(-1, cout)
    return {"fwd": fwd, "dgrad": rounded(dx[:, :v]), "wgrad": rounded(dw)}


def subm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap over the slabs of dim 0: |got - want| / |want| (2-norms;
    0 where both are zero, inf where only the reference is)."""
    diff = (got.double() - want).flatten(1).norm(dim=1)
    norm = want.flatten(1).norm(dim=1)
    gap = torch.where(norm > 0, diff / norm.clamp_min(1e-300),
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(gap.max()) if gap.numel() else 0.0


def subm_kernel_run(rb, compute_dtype) -> dict:
    """K4's three launches over ``rb``, each as f(feats, w, grad)."""
    from geoformer_tpu_torch.kernels import subm_conv as k4

    cd, nv = compute_dtype, rb.n_voxels
    return {"fwd": lambda f, w, g: k4.subm_fwd(f, rb.nbr, w, cd, nv),
            "dgrad": lambda f, w, g: k4.subm_dgrad(g, rb.nbr_t, w, cd, nv),
            "wgrad": lambda f, w, g: k4.subm_wgrad(f, rb.nbr, g, w, cd, nv)}


def subm_plain_run(rb, compute_dtype) -> dict:
    """The plain conv over ``rb`` and its autograd, as ``subm_kernel_run``."""
    from geoformer_tpu_torch.ops.sparse_conv import subm_conv_plain

    def grad_of(f, w, g, which):
        f, w = f.detach().requires_grad_(which == 0), w.detach().requires_grad_(which == 1)
        out = subm_conv_plain(f, rb.nbr, w, compute_dtype)
        return torch.autograd.grad(out, (f, w)[which], g)[0]

    return {"fwd": lambda f, w, g: subm_conv_plain(f, rb.nbr, w, compute_dtype),
            "dgrad": lambda f, w, g: grad_of(f, w, g, 0),
            "wgrad": lambda f, w, g: grad_of(f, w, g, 1)}


def subm_check(feats, rb, w, grad, compute_dtype, run=None) -> dict:
    """K4 (or ``run``: ``subm_plain_run`` for the plain versions) against
    ``subm_reference`` on one rulebook -> per direction its ``gap``
    (``subm_gap``), the ``limit`` (``SUBM_LIMITS``), ``ratio`` = gap / limit
    (at most 1 to pass) and whether a second run is bit-equal; and under
    ``faults`` the ratio of each planted fault (None where it changes
    nothing), each of which must read above 1: the offset with the fewest
    reads dropped from the forward and from the input gradient (its
    weights zeroed), every other tile of 64 rows of a scene left out of
    each direction (the forward's and the input gradient's rows zeroed, the
    weight gradient's sum over rows without them), and that offset's dW
    slab zeroed.

    Why the sound gaps are small: bf16 products are exact in float32, so
    the forward differs from the reference only by the order and rounding
    of its float32 sums (27 Cin terms a value), as do the float32 input
    gradient (Cout terms a read, then 27 reads) and the weight gradient (a
    sum over every row). With bf16 the input gradient rounds each read and
    the sum to bf16 in both: they part only where a float32 sum and the
    exact one round to neighbouring bf16 values, and the plain version
    rounds each chunk's sum of offsets too. The weight gradient's bf16
    rounding likewise."""
    cd = compute_dtype
    run = run or subm_kernel_run(rb, cd)
    precision = "float32" if cd is None else str(cd).split(".")[-1]
    want = subm_reference(feats, rb, w, grad, cd)
    out, got = {}, {}
    for name in ("fwd", "dgrad", "wgrad"):
        got[name], again = run[name](feats, w, grad), run[name](feats, w, grad)
        gap, limit = subm_gap(got[name], want[name]), SUBM_LIMITS[(name, precision)]
        out[name] = {"gap": gap, "limit": limit, "ratio": gap / limit,
                     "deterministic": bool(torch.equal(got[name].view(torch.int32),
                                                       again.view(torch.int32)))}
    v = rb.nbr.shape[1]
    reads = (rb.nbr < v).sum((0, 1))
    k0 = int(torch.where(reads > 0, reads, reads.max() + 1).argmin())
    w_dropped = w.clone()
    w_dropped[k0] = 0
    odd = ((torch.arange(v, device=feats.device) // SUBM_TILE) % 2 == 1)[None, :, None]
    slab = got["wgrad"].clone()
    slab[k0] = 0
    faults = {
        "fwd_offset_dropped": ("fwd", run["fwd"](feats, w_dropped, grad)),
        "fwd_tiles_skipped": ("fwd", got["fwd"].masked_fill(odd, 0)),
        "dgrad_offset_dropped": ("dgrad", run["dgrad"](feats, w_dropped, grad)),
        "dgrad_tiles_skipped": ("dgrad", got["dgrad"].masked_fill(odd, 0)),
        "wgrad_slab_zeroed": ("wgrad", slab),
        "wgrad_tiles_skipped": ("wgrad", run["wgrad"](feats, w, grad.masked_fill(odd, 0))),
    }
    out["faults"] = {
        f: None if torch.equal(bad, got[name])
        else subm_gap(bad, want[name]) / out[name]["limit"]
        for f, (name, bad) in faults.items()}
    return out
