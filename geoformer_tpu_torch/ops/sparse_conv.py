"""Sparse 3D convolution as rulebook gather + GEMM (port of
geoformer_tpu/ops/sparse_conv.py, rulebook form only).

The JAX package also builds dense-brick plans (ops/brick.py) for the TPU's
layout; those equal the rulebook path while no brick overflows and are not
ported: on the card the gather/GEMM/scatter-free rulebook form is the
natural one. ``plan_stats`` reports ``n_brick_overflow`` as zeros.

Weight layouts (as in the JAX module):
  subm k3:  w[27, Cin, Cout], offset index = (dz+1)*9 + (dy+1)*3 + (dx+1)
  down/up:  w[8, Cin, Cout],  offset index = cz%2*4 + cy%2*2 + cx%2
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from geoformer_tpu_torch.ops import gather_rows, pad_row
from geoformer_tpu_torch.ops.voxelize import VoxelGrid, pack_key, voxelize

SUBM_OFFSETS = np.array(
    [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int64,
)  # [27, 3] as (dz, dy, dx)


def build_subm_neighbors(grid: VoxelGrid, spatial: int) -> torch.Tensor:
    """[B, V, 27] gather map; entry = input voxel slot or V (pad).

    The JAX module ranks the neighbor keys with radius_graph.ranked_lookup,
    a compare-count form of searchsorted(side="left") on the sorted key
    table; here it is ``torch.searchsorted``."""
    keys = grid.voxel_keys
    b, v = keys.shape
    offs = torch.as_tensor(SUBM_OFFSETS[:, ::-1].copy(), device=keys.device)  # (x,y,z)
    nc = grid.voxel_coords[:, :, None, :] + offs[None, None]  # [B,V,27,3]
    in_range = ((nc >= 0) & (nc < spatial)).all(-1) & grid.voxel_mask[..., None]
    nkey = pack_key(nc.clamp(0, spatial - 1), spatial)
    idx = torch.searchsorted(keys, nkey.reshape(b, -1)).reshape(b, v, 27)
    idx = idx.clamp(max=v - 1)
    hit = torch.gather(keys, 1, idx.reshape(b, -1)).reshape(b, v, 27) == nkey
    found = in_range & hit & (idx < grid.n_voxels[:, None, None])
    return torch.where(found, idx, v)


class DownLink(NamedTuple):
    """Connectivity between a level and its 2x-downsampled parent level.

    parent [B,Vc] (pad -> Vp), offset_idx [B,Vc] in [0,8), children
    [B,Vp,8] (pad -> Vc), parent_grid: VoxelGrid of the parent level."""

    parent: torch.Tensor
    offset_idx: torch.Tensor
    children: torch.Tensor
    parent_grid: VoxelGrid


def build_downsample(grid: VoxelGrid, spatial: int, num_parent_voxels: int) -> DownLink:
    c = grid.voxel_coords
    half = torch.where(grid.voxel_mask[..., None], torch.div(c, 2, rounding_mode="floor"), 0)
    pgrid = voxelize(half, grid.voxel_mask, num_parent_voxels, spatial // 2)
    offset_idx = (c[..., 2] % 2) * 4 + (c[..., 1] % 2) * 2 + (c[..., 0] % 2)
    offset_idx = torch.where(grid.voxel_mask, offset_idx, 0)

    # children of parent j are pgrid.order[starts[j] : starts[j+1]] (<= 8)
    vc = grid.voxel_keys.shape[1]
    eight = torch.arange(8, device=c.device)
    idx = pgrid.starts[:, :-1, None] + eight
    ok = eight < pgrid.counts[..., None]
    child = gather_rows(pgrid.order, idx.clamp(max=vc - 1))
    children = torch.where(ok, child, vc)
    return DownLink(parent=pgrid.p2v, offset_idx=offset_idx, children=children,
                    parent_grid=pgrid)


def subm_conv(feats: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Submanifold conv. feats [B,V,Cin], nbr [B,V,K], w [K,Cin,Cout].

    Offsets go in chunks of 128 // Cin (as in the JAX module) so the gathered
    buffer stays bounded; missing neighbors read the explicit zero row V."""
    k, cin, cout = w.shape
    fpad = pad_row(feats)
    chunk = max(1, 128 // max(cin, 1))
    out = None
    for s in range(0, k, chunk):
        e = min(s + chunk, k)
        g = gather_rows(fpad, nbr[:, :, s:e])  # [B,V,c,Cin]
        part = g.reshape(g.shape[0], g.shape[1], -1) @ w[s:e].reshape(-1, cout)
        out = part if out is None else out + part
    return out


def dense_1x1(feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SubMConv3d kernel_size=1 (residual identity branch) == matmul."""
    return feats @ w


def _offset_gemm(feats: torch.Tensor, offset_idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[v] = feats[v] @ w[offset_idx[v]] via 8 masked GEMMs."""
    out = feats.new_zeros(feats.shape[:-1] + (w.shape[-1],))
    for k in range(w.shape[0]):
        sel = (offset_idx == k).to(feats.dtype)[..., None]
        out = out + sel * (feats @ w[k])
    return out


def down_conv(feats: torch.Tensor, link: DownLink, w: torch.Tensor) -> torch.Tensor:
    """Strided k=2 s=2 conv: child feats [B,Vc,Cin] -> parent [B,Vp,Cout],
    reduced over the <=8-slot children rulebook (pad children read zeros)."""
    transformed = pad_row(_offset_gemm(feats, link.offset_idx, w))
    return gather_rows(transformed, link.children).sum(dim=2)


def up_conv(parent_feats: torch.Tensor, link: DownLink, w: torch.Tensor) -> torch.Tensor:
    """Inverse k=2 conv: parent feats [B,Vp,Cin] -> child [B,Vc,Cout]."""
    gathered = gather_rows(pad_row(parent_feats), link.parent)
    return _offset_gemm(gathered, link.offset_idx, w)


class GridPlan(NamedTuple):
    """Per-forward connectivity for the whole U-Net, one entry per level:
    grids (level 0 = point-resolution voxels), subm [B,V_l,27] neighbor maps,
    links[l] connecting level l -> l+1."""

    grids: tuple
    subm: tuple
    links: tuple


def plan_stats(plan: GridPlan) -> dict:
    """Capacity-health counters of a built plan, all [B] (see the JAX
    plan_stats). The rulebook path has no bricks: n_brick_overflow is 0."""
    g0 = plan.grids[0]
    zeros = torch.zeros_like(g0.n_overflow)
    deeper = zeros
    saturated = g0.n_voxels >= g0.voxel_keys.shape[1]
    for g in plan.grids[1:]:
        deeper = deeper + g.n_overflow
        saturated = saturated | (g.n_voxels >= g.voxel_keys.shape[1])
    return {
        "n_voxels": g0.n_voxels,
        "capacity": torch.full_like(g0.n_voxels, g0.voxel_keys.shape[1]),
        "n_overflow_points": g0.n_overflow,
        "n_oor_points": g0.n_oor,
        "n_dropped_voxels_deeper": deeper,
        "n_brick_overflow": zeros,
        "saturated": saturated,
    }


def voxel_capacities(v0: int, depth: int, decay: float = 0.5, floor: int = 64) -> list[int]:
    caps = [int(v0)]
    for _ in range(depth - 1):
        caps.append(max(int(np.ceil(caps[-1] * decay)), floor))
    return caps


def build_grid_plan(coords: torch.Tensor, mask: torch.Tensor, spatial: int, depth: int,
                    caps: list[int]) -> GridPlan:
    """Build all rulebooks for a forward pass. coords [B,P,3] int point grid
    coords, mask [B,P], caps[l] = V_l."""
    assert len(caps) == depth
    grids = [voxelize(coords, mask, caps[0], spatial)]
    links = []
    s = spatial
    for lvl in range(depth - 1):
        link = build_downsample(grids[-1], s, caps[lvl + 1])
        links.append(link)
        grids.append(link.parent_grid)
        s //= 2
    subm = []
    s = spatial
    for lvl in range(depth):
        subm.append(build_subm_neighbors(grids[lvl], s))
        s //= 2
    return GridPlan(grids=tuple(grids), subm=tuple(subm), links=tuple(links))
