"""Sort-based voxelization (port of geoformer_tpu/ops/voxelize.py).

Same contract as the JAX module: every scene is padded to P points and V
voxel slots; slot V is the zero "pad" voxel that absorbs invalid points and
capacity overflow, and every drop is counted. Keys are sorted with a stable
sort, so points of one voxel stay in index order. Indices are int64 here
(torch indexing); the values equal the JAX int32 ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geoformer_tpu_torch.ops import gather_rows, padded_table, take_rows


class VoxelGrid(NamedTuple):
    """Point->voxel assignment for one padded batch (see the JAX VoxelGrid).

    p2v [B,P] (V = pad slot), voxel_coords [B,V,3] (pads -1), voxel_keys
    [B,V] ascending (pads = sentinel), voxel_mask [B,V], n_voxels [B],
    counts [B,V], order [B,P], starts [B,V+1], n_overflow [B], n_oor [B].
    """

    p2v: torch.Tensor
    voxel_coords: torch.Tensor
    voxel_keys: torch.Tensor
    voxel_mask: torch.Tensor
    n_voxels: torch.Tensor
    counts: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    n_overflow: torch.Tensor
    n_oor: torch.Tensor


def pack_key(coords: torch.Tensor, spatial: int) -> torch.Tensor:
    """Pack [..., 3] int grid coords (x, y, z) into a scalar key (z-major)."""
    return (coords[..., 2] * spatial + coords[..., 1]) * spatial + coords[..., 0]


def unpack_key(key: torch.Tensor, spatial: int) -> torch.Tensor:
    x = key % spatial
    y = (key // spatial) % spatial
    z = key // (spatial * spatial)
    return torch.stack([x, y, z], dim=-1)


def voxelize(coords: torch.Tensor, mask: torch.Tensor, num_voxels: int,
             spatial: int) -> VoxelGrid:
    """Batched voxelization. coords [B,P,3] int, mask [B,P] bool."""
    b, p = mask.shape
    v = num_voxels
    dev = coords.device
    coords = coords.long()
    sentinel = spatial * spatial * spatial  # > any valid key

    # out-of-grid coords would alias another cell's key: pad voxel + counted
    in_range = ((coords >= 0) & (coords < spatial)).all(-1)
    ok = mask & in_range
    n_oor = (mask & ~in_range).sum(1)

    key = torch.where(ok, pack_key(coords, spatial), sentinel)
    skey, order = torch.sort(key, dim=1, stable=True)  # invalid points last

    valid_sorted = skey < sentinel
    prev = torch.cat([skey.new_full((b, 1), -1), skey[:, :-1]], dim=1)
    head = valid_sorted & (skey != prev)
    vox_id_sorted = torch.cumsum(head.long(), dim=1) - 1
    n_vox = head.sum(1)
    n_overflow = (valid_sorted & (vox_id_sorted >= v)).sum(1)
    in_cap = valid_sorted & (vox_id_sorted < v)
    vox_id_sorted = torch.where(in_cap, vox_id_sorted, v)

    p2v = torch.empty_like(vox_id_sorted).scatter_(1, order, vox_id_sorted)

    # segment starts: one scatter of the head positions (each voxel id has
    # exactly one head); non-heads write the discarded column v
    n_valid = in_cap.sum(1)
    pos = torch.arange(p, device=dev).expand(b, p)
    head_tgt = torch.where(head & in_cap, vox_id_sorted, v)
    starts_v = n_valid[:, None].expand(b, v + 1).clone().scatter_(1, head_tgt, pos)
    starts = torch.cat([starts_v[:, :v], n_valid[:, None]], dim=1)
    counts = starts[:, 1:] - starts[:, :-1]

    first = starts[:, :v].clamp(max=p - 1)
    n_vox = n_vox.clamp(max=v)
    slot = torch.arange(v, device=dev)
    voxel_mask = slot[None, :] < n_vox[:, None]
    voxel_keys = torch.where(voxel_mask, torch.gather(skey, 1, first), sentinel)
    voxel_coords = torch.where(voxel_mask[..., None], unpack_key(voxel_keys, spatial), -1)
    return VoxelGrid(p2v, voxel_coords, voxel_keys, voxel_mask, n_vox, counts, order,
                     starts, n_overflow, n_oor)


def _voxelize_scene(coords: torch.Tensor, mask: torch.Tensor, num_voxels: int, spatial: int):
    """Single-scene voxelization: coords [P,3], mask [P] -> the VoxelGrid
    fields of that scene (no batch dimension)."""
    grid = voxelize(coords[None], mask[None], num_voxels, spatial)
    return VoxelGrid(*(t[0] for t in grid))


def voxel_mean_pool(feats: torch.Tensor, grid: VoxelGrid) -> torch.Tensor:
    """Mean of point features per voxel: feats [B,P,C] -> [B,V,C].

    Points sorted by voxel are contiguous, so the reduction is one cumsum and
    two boundary gathers, as in the JAX module."""
    sf = gather_rows(feats, grid.order)  # [B,P,C] sorted by voxel
    csum = torch.cumsum(sf, dim=1)
    csum0 = torch.cat([csum.new_zeros(csum.shape[0], 1, csum.shape[2]), csum], dim=1)
    seg = gather_rows(csum0, grid.starts[:, 1:]) - gather_rows(csum0, grid.starts[:, :-1])
    return seg / grid.counts.clamp(min=1)[..., None].to(seg.dtype)


def devoxelize(voxel_feats: torch.Tensor, grid: VoxelGrid) -> torch.Tensor:
    """Gather voxel features back to points: [B,V,C] -> [B,P,C] (pad slot V,
    an invalid point's, reads the zero row)."""
    return take_rows(padded_table(voxel_feats), grid.p2v, voxel_feats.shape[1])
