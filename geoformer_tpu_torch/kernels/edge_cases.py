"""Corner cases of the K1 and K2 kernels' designs, as seeded numpy inputs.

Each case names what it exercises. The card tests
(``tests/test_torch_{fps,knn_select}.py``) and the ``kernel_edges`` phase of
``chip_smoke.py`` hold each kernel bit-equal to its plain version on them;
the CPU tests hold the plain versions against JAX on the ones JAX can take.
"""

from __future__ import annotations

import numpy as np

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


def knn_cases(seed: int = 0) -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """(name, d2 [n,W] f32, cand [n,W] i32, k) for K1: W = 16, 70, 648 and
    1024, k from 1 to W."""
    cases = []
    for w, ks in ((16, (1, 16)), (70, (16, 32, 70)), (648, (1, 8, 16, 32)), (1024, (16, 1024))):
        d2 = knn_rows(w, seed)
        cand = np.random.default_rng(seed + 1).integers(0, 1 << 20, d2.shape).astype(np.int32)
        for k in ks:
            cases.append((f"w{w}_k{k}", d2, cand, k))
    return cases
