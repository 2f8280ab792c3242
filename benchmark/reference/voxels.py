"""The voxel levels of a batch of scans, worked out from the points.

Level 0 holds the occupied cells of the points' integer grid coords; level
l + 1 the cells of level l's coords halved (rounded down). A level's voxels
are listed scene by scene, each scene's in ascending (z, y, x) order, every
voxel once. Neighbours are found by joining integer keys with
``torch.unique``: a voxel's key in a table of keys, without a grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the 27 offsets of a 3x3x3 kernel, as (dz, dy, dx); offset k is the
# weight w[k] = w[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)]
OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@dataclass
class Level:
    """One level: ``scene`` [N] and ``zyx`` [N, 3] of its N voxels, each
    scene's voxels in ascending (z, y, x) order; ``slot`` [N], a voxel's
    rank within its scene; ``subm`` [(out, in)] a pair list per kernel
    offset; and, for every level but the last, ``parent`` [N] (the index
    of the voxel's cell at the next level) and ``child_offset`` [N] (its
    place in that cell, z % 2 * 4 + y % 2 * 2 + x % 2)."""

    scene: torch.Tensor
    zyx: torch.Tensor
    slot: torch.Tensor
    per_scene: torch.Tensor
    subm: list
    parent: torch.Tensor | None = None
    child_offset: torch.Tensor | None = None


def _key(scene, zyx, span: int):
    """One int64 per (scene, z, y, x), coords in [-1, span - 1]: no two
    cells, a cell just outside the grid included, share a key."""
    s = span + 2
    z, y, x = (zyx[:, i] + 1 for i in range(3))
    return ((scene * s + z) * s + y) * s + x


def lookup(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The index of each query key in ``table`` (distinct keys), or -1."""
    keys, inverse = torch.unique(torch.cat([table, queries]), return_inverse=True)
    where = torch.full((keys.numel(),), -1, dtype=torch.long, device=table.device)
    where[inverse[: table.numel()]] = torch.arange(table.numel(), device=table.device)
    return where[inverse[table.numel():]]


def _distinct(scene, zyx, span: int, n_scenes: int):
    """The distinct (scene, z, y, x) rows, sorted -> (Level without pairs,
    the inverse map of the rows given)."""
    rows = torch.cat([scene[:, None], zyx], dim=1)
    uniq, inverse = torch.unique(rows, dim=0, return_inverse=True)
    per_scene = torch.bincount(uniq[:, 0], minlength=n_scenes)
    first = torch.cumsum(per_scene, 0) - per_scene
    slot = torch.arange(uniq.shape[0], device=zyx.device) - first[uniq[:, 0]]
    return Level(uniq[:, 0], uniq[:, 1:], slot, per_scene, []), inverse


def _subm_pairs(level: Level, span: int) -> list:
    keys = _key(level.scene, level.zyx, span)
    pairs = []
    for dz, dy, dx in OFFSETS:
        off = torch.tensor([dz, dy, dx], device=keys.device)
        nbr = lookup(keys, _key(level.scene, level.zyx + off, span))
        out = torch.nonzero(nbr >= 0).flatten()
        pairs.append((out, nbr[out]))
    return pairs


def build_levels(coords: torch.Tensor, point_mask: torch.Tensor, depth: int, spatial: int):
    """coords [B, P, 3] int (x, y, z) grid coords, point_mask [B, P] ->
    (levels [depth], point_scene [n], point_voxel [n], the flat indices of
    the n valid points in [B * P])."""
    b, p = point_mask.shape
    flat = torch.nonzero(point_mask.reshape(-1)).flatten()
    scene = flat // p
    xyz = coords.reshape(-1, 3)[flat].long()
    levels = []
    level, point_voxel = _distinct(scene, xyz.flip(1), spatial, b)
    span = spatial
    for lvl in range(depth):
        level.subm = _subm_pairs(level, span)
        levels.append(level)
        if lvl == depth - 1:
            break
        z, y, x = level.zyx.unbind(1)
        level.child_offset = (z % 2) * 4 + (y % 2) * 2 + x % 2
        nxt, level.parent = _distinct(level.scene, torch.div(level.zyx, 2, rounding_mode="floor"),
                                      span // 2, b)
        level, span = nxt, span // 2
    return levels, scene, point_voxel, flat
