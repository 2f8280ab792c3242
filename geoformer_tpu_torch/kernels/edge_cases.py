"""Corner cases of the K1, K2 and K3 kernels' designs, as seeded numpy inputs.

Each case names what it exercises. The card tests
(``tests/test_torch_{fps,knn_select,gather}.py``) and the ``kernel_edges``
phase of ``chip_smoke.py`` hold each kernel bit-equal to its plain version on
them,
and K1's exact-path rows to the rows that its design must sort or must send
to its exact path (``knn_path_rows``); the CPU tests hold the plain versions
against JAX on the ones JAX can take.
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
