"""Frozen work counts: the operations and bytes a call needs, worked out from
its inputs' shapes and from the benchmark's own voxelization, whatever code
computes the call.

* ``knn_select_bytes`` / ``fps_ops`` / ``fps_bytes``: kernels K1 and K2 at one
  call's shapes (the arithmetic of the port's bring-up table: each input byte
  read once and each output byte written once; 9 operations per valid point
  and pick of FPS).
* ``train_step_work``: the dense linear algebra of one training step of the
  prepare phase (forward and backward, no recompute), split by the operand
  type the configuration states: the sparse convolutions in ``bf16`` where
  the configuration narrows them, all else ``f32``. A multiply-add counts
  2. Sparse convolutions count the active (voxel, offset) pairs of each
  level; dense layers count the valid rows that they serve.
"""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


# ---------------- kernels ----------------


def knn_select_bytes(n: int, w: int, k: int) -> int:
    """K1: d2 [n, w] f32 read once, the k picked candidate ids read, vals
    and ids [n, k] written."""
    return n * w * 4 + n * k * 4 + n * k * 8


def fps_ops(n_valid: int, n_samples: int) -> int:
    """K2: each pick after the first updates every valid point's running
    minimum: 3 differences, 3 products, 2 sums, 1 minimum."""
    return (n_samples - 1) * n_valid * 9


def fps_bytes(b: int, p: int, n_samples: int) -> int:
    """K2: points [b, p, 3] f32 and mask [b, p] u8 read once, picks written."""
    return b * p * 13 + b * n_samples * 4


def bound_s(ops: float = 0.0, bytes_: float = 0.0) -> float:
    """The least time the chip could take: the larger of float32 operations
    over the float32 peak and bytes over the memory's rate."""
    return max(ops / PEAK_FLOPS["f32"], bytes_ / HBM_BYTES_PER_S)


# ---------------- voxels ----------------

_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _keys(c: torch.Tensor, spatial: int) -> torch.Tensor:
    return (c[:, 2] * spatial + c[:, 1]) * spatial + c[:, 0]


def level_counts(coords: torch.Tensor, depth: int, spatial: int):
    """coords [P, 3] int voxel coords of one scene's valid points -> (voxels
    [depth], subm pairs [depth]): the occupied voxels of each U-Net level
    (level l+1 halves level l's coords) and the (voxel, offset) pairs of a
    3x3x3 submanifold conv whose neighbour is occupied, the centre
    included."""
    c = torch.unique(coords.long(), dim=0)
    voxels, pairs = [], []
    s = spatial
    for _ in range(depth):
        keys = torch.sort(_keys(c, s))[0]
        n = 0
        for off in _OFFSETS:
            nc = c + torch.tensor(off, device=c.device)
            ok = ((nc >= 0) & (nc < s)).all(1)
            nk = _keys(nc.clamp(0, s - 1), s)
            pos = torch.searchsorted(keys, nk).clamp(max=keys.numel() - 1)
            n += int((ok & (keys[pos] == nk)).sum())
        voxels.append(c.shape[0])
        pairs.append(n)
        c = torch.unique(torch.div(c, 2, rounding_mode="floor"), dim=0)
        s //= 2
    return voxels, pairs


# ---------------- model stages ----------------


def _mm(rows: float, cin: int, cout: int) -> float:
    return 2.0 * rows * cin * cout


def backbone_flops(voxels, pairs, cin: int, m: int, points: int, classes: int) -> float:
    """Sparse U-Net (2 residual blocks a level, k2s2 down and up convs, 2
    tail blocks, the dense transformer of the two deepest levels) and the
    semantic head over the points. -> (sparse conv flops, other flops)."""
    depth = len(voxels)
    conv = _mm(pairs[0], cin, m)
    dense = 0.0
    for lvl in range(depth):
        c, v, pr = m * (lvl + 1), voxels[lvl], pairs[lvl]
        conv += 4 * _mm(pr, c, c)
        if lvl < depth - 1:
            c1 = m * (lvl + 2)
            conv += _mm(v, c, c1) + _mm(v, c1, c)          # down, up
            conv += _mm(pr, 2 * c, c) + 3 * _mm(pr, c, c)  # the tail blocks' convs
            dense += _mm(v, 2 * c, c)                      # the first tail's 1x1 branch
        if lvl >= depth - 2:  # d 128, 4 heads, feed-forward 64, 2 layers
            dense += _mm(v, c, 128) + _mm(v, 128, c) + _mm(v, 3, 128)
            dense += 2 * (4 * _mm(v, 128, 128) + 2 * _mm(v, v, 128) + _mm(v, 128, 64)
                          + _mm(v, 64, 128))
    dense += _mm(points, m, m) * 2 + _mm(points, m, classes)
    return conv, dense


def _split(mc: dict, conv: float, other: float) -> dict:
    narrowed = mc.get("tpu_compute_dtype") == "bfloat16" or mc.get("tpu_bf16", False)
    if narrowed:
        return {"bf16": conv, "f32": other}
    return {"bf16": 0.0, "f32": conv + other}


def add(*works: dict) -> dict:
    return {t: sum(w.get(t, 0.0) for w in works) for t in PEAK_FLOPS}


def scale(work: dict, f: float) -> dict:
    return {t: v * f for t, v in work.items()}


def _backbone(mc: dict, coords: torch.Tensor):
    voxels, pairs = level_counts(coords, mc["tpu_unet_depth"], mc["tpu_spatial_shape"])
    cin = mc["input_channel"] + (3 if mc["use_coords"] else 0)
    return backbone_flops(voxels, pairs, cin, mc["m"], coords.shape[0], mc["classes"])


def train_step_work(mc: dict, coords: list) -> dict:
    """One training step of the prepare phase over a batch (each scene's
    valid voxel coords): forward and backward (twice the forward's
    products), no recompute."""
    works = []
    for c in coords:
        conv, dense = _backbone(mc, c)
        works.append(_split(mc, conv, dense))
    return scale(add(*works), 3.0)


def peak_seconds(work: dict) -> float:
    """The least time the work could take at the chip's peak for each type."""
    return sum(work[t] / PEAK_FLOPS[t] for t in PEAK_FLOPS)
