"""Sparse 3D convolution as rulebook gather + GEMM (port of
geoformer_tpu/ops/sparse_conv.py, rulebook form and compact slot tables).

The JAX package also builds dense-brick plans (ops/brick.py) for the TPU's
layout; those equal the rulebook path while no brick overflows and are not
ported: on the card the gather/GEMM/scatter-free rulebook form is the
natural one. ``plan_stats`` reports ``n_brick_overflow`` as zeros.

The submanifold conv is kernel K4 on the card (``kernels/subm_conv.py``:
a gather-GEMM forward, the input gradient over the transposed rulebook, the
weight gradient) and ``subm_conv_plain`` on the CPU. ``build_grid_plan``
gives each level a ``Rulebook``: the int32 [B,V,27] map, the voxel counts
and the map's int32 transpose, built once a level by the first conv that
takes a gradient.

``tpu_subm_k`` < 27 without bricks builds the JAX module's compact slot
tables (``compact_subm_neighbors``: the live neighbours packed first, those
past the k-th dropped). ``expand_compact`` turns a table back into a
27-slot map whose dropped offsets read the zero row, and the conv runs on
it: the same sums as JAX's one-hot routing (one weight a live slot), with
no [V, k, Cin, Cout] per-slot weights, and one conv code path for both.

``compute_dtype=torch.bfloat16`` (the configs' ``tpu_compute_dtype: bfloat16``)
narrows features and weights before each product, as the JAX module does;
products accumulate and come out in float32, the JAX module's
``preferred_element_type``. A bf16 ``torch.matmul`` would round its output
to bf16, so the down and up convs widen the narrowed operands back to
float32 (exact) for an f32 product instead (TF32 is off,
``set_fp32_precision``).

Weight layouts (as in the JAX module):
  subm k3:  w[27, Cin, Cout], offset index = (dz+1)*9 + (dy+1)*3 + (dx+1)
  down/up:  w[8, Cin, Cout],  offset index = cz%2*4 + cy%2*2 + cx%2
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from geoformer_tpu_torch.kernels.subm_conv import SubmConv
from geoformer_tpu_torch.ops import gather_rows, padded_table, take_rows
from geoformer_tpu_torch.ops.voxelize import VoxelGrid, pack_key, voxelize

SUBM_OFFSETS = np.array(
    [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int64,
)  # [27, 3] as (dz, dy, dx)


def build_subm_neighbors(grid: VoxelGrid, spatial: int) -> torch.Tensor:
    """[B, V, 27] int32 gather map; entry = input voxel slot or V (pad).

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
    return torch.where(found, idx, v).to(torch.int32)


def transpose_map(nbr: torch.Tensor) -> torch.Tensor:
    """Rulebook nbr [B,V,K] (V: none) -> int32 [B,V,K] with entry [b, i, k]
    = o where nbr[b, o, k] = i, else V: the row that reads row i through
    offset k. One scatter, exact for any rulebook (each (i, k) has at most
    one reader); for the full 27-offset map it is the mirrored map
    nbr[b, i, 26 - k]."""
    b, v, k = nbr.shape
    out = torch.full((b, v + 1, k), v, dtype=torch.int32, device=nbr.device)
    readers = torch.arange(v, dtype=torch.int32, device=nbr.device).view(1, v, 1)
    out.scatter_(1, nbr.long(), readers.expand(b, v, k))  # pads land in row v, dropped
    return out[:, :v].contiguous()


class Rulebook:
    """What a level's submanifold convs read: ``nbr`` the [B,V,27] map (int32
    on the card), ``n_voxels`` [B] int32 or None (every row may read: rows
    at or past a scene's count neither read nor are read, and K4 skips
    them), and ``nbr_t`` the map's transpose (``transpose_map``), built on
    first use and kept: once a level a training forward, never in eval."""

    def __init__(self, nbr: torch.Tensor, n_voxels: torch.Tensor | None = None):
        self.nbr, self.n_voxels = nbr, n_voxels

    @functools.cached_property
    def nbr_t(self) -> torch.Tensor:
        return transpose_map(self.nbr)


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


def _narrow(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype is None else x.to(compute_dtype)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32 (bf16 values widen exactly), or float64 if it is that."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in float32 (float64 for float64
    operands), whatever the operands' dtype."""
    return _wide(a) @ _wide(b)


def subm_conv_plain(feats: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """Submanifold conv in plain PyTorch, on any device and dtype: feats
    [B,V,Cin], nbr [B,V,K], w [K,Cin,Cout] -> [B,V,Cout] float32 (float64
    for float64 operands), differentiable through ``take_rows``.

    Offsets go in chunks of 128 // Cin (as in the JAX module) so the gathered
    buffer stays bounded; missing neighbors read the explicit zero row V.
    Autograd rounds each read's gradient, and each chunk's sum, to the
    table's type."""
    k, cin, cout = w.shape
    v = feats.shape[1]
    table = padded_table(_narrow(feats, compute_dtype))
    w = _narrow(w, compute_dtype)
    chunk = max(1, 128 // max(cin, 1))
    out = None
    for s in range(0, k, chunk):
        e = min(s + chunk, k)
        g = take_rows(table, nbr[:, :, s:e], v)  # [B,V,c,Cin]
        part = _f32_product(g.reshape(g.shape[0], g.shape[1], -1), w[s:e].reshape(-1, cout))
        out = part if out is None else out + part
    return out


def apply_subm(feats: torch.Tensor, rb: Rulebook, w: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
    """A submanifold conv over a level's ``Rulebook`` -> [B,V,Cout] float32:
    ``subm_conv_plain`` for CPU tensors; on the card K4 (``SubmConv``),
    which raises for what it cannot take (float64, an int64 map), with the
    transposed map only where a gradient will be taken."""
    if feats.device.type == "cpu":
        return subm_conv_plain(feats, rb.nbr, w, compute_dtype)
    backward = torch.is_grad_enabled() and (feats.requires_grad or w.requires_grad)
    return SubmConv.apply(feats, w, rb.nbr, rb.nbr_t if backward else None, rb.n_voxels,
                          compute_dtype)


def subm_conv(feats: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Submanifold conv over a [B,V,27] map (``apply_subm`` of its
    ``Rulebook``, every row live)."""
    return apply_subm(feats, Rulebook(nbr), w, compute_dtype)


def compact_subm_neighbors(nbr: torch.Tensor, k: int):
    """Pack live neighbour slots first: [B,V,27] -> (idx [B,V,k], oid
    [B,V,k]). oid is the offset index of each slot (27 = dead); offsets
    beyond the k-th live neighbour are dropped (exact while a voxel's live
    count is <= k)."""
    v = nbr.shape[1]
    ok = nbr < v
    sel = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)[..., :k]
    idx = torch.gather(nbr, -1, sel)
    oid = torch.where(torch.gather(ok, -1, sel), sel, 27)
    return torch.where(oid < 27, idx, v), oid


def expand_compact(idx: torch.Tensor, oid: torch.Tensor) -> torch.Tensor:
    """A compacted slot table (idx, oid [B,V,K], see compact_subm_neighbors)
    -> the 27-slot map it routes (dropped offsets and dead slots -> the zero
    row V; the dead slots land in a 28th column, cut off)."""
    v = idx.shape[1]
    nbr = idx.new_full(idx.shape[:2] + (28,), v)
    nbr.scatter_(2, oid, idx)
    return nbr[..., :27].contiguous()


def subm_conv_compact(feats: torch.Tensor, idx: torch.Tensor, oid: torch.Tensor,
                      w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Submanifold conv over a compacted slot table, w [27,Cin,Cout] ->
    [B,V,Cout] float32: each slot's neighbour routed to its offset's weight,
    by ``subm_conv`` over ``expand_compact``'s map."""
    return subm_conv(feats, expand_compact(idx, oid), w, compute_dtype)


def dense_1x1(feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SubMConv3d kernel_size=1 (residual identity branch) == matmul."""
    return feats @ w


def _offset_gemm(feats: torch.Tensor, offset_idx: torch.Tensor, w: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
    """out[v] = feats[v] @ w[offset_idx[v]] via 8 masked GEMMs (float32 out)."""
    feats, w = _narrow(feats, compute_dtype), _narrow(w, compute_dtype)
    out = torch.zeros(feats.shape[:-1] + (w.shape[-1],), dtype=_wide(feats).dtype,
                      device=feats.device)
    for k in range(w.shape[0]):
        sel = (offset_idx == k).to(out.dtype)[..., None]
        out = out + sel * _f32_product(feats, w[k])
    return out


def down_conv(feats: torch.Tensor, link: DownLink, w: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Strided k=2 s=2 conv: child feats [B,Vc,Cin] -> parent [B,Vp,Cout],
    reduced over the <=8-slot children rulebook (pad children read zeros)."""
    transformed = _offset_gemm(feats, link.offset_idx, w, compute_dtype)
    return take_rows(padded_table(transformed), link.children, feats.shape[1]).sum(dim=2)


def up_conv(parent_feats: torch.Tensor, link: DownLink, w: torch.Tensor,
            compute_dtype=None) -> torch.Tensor:
    """Inverse k=2 conv: parent feats [B,Vp,Cin] -> child [B,Vc,Cout]."""
    gathered = take_rows(padded_table(_narrow(parent_feats, compute_dtype)), link.parent,
                         parent_feats.shape[1])
    return _offset_gemm(gathered, link.offset_idx, w, compute_dtype)


class GridPlan(NamedTuple):
    """Per-forward connectivity for the whole U-Net, one entry per level:
    grids (level 0 = point-resolution voxels), subm [B,V_l,27] int32
    neighbor maps, links[l] connecting level l -> l+1, subm_compact: () or
    the (idx, oid) compacted tables of each level (build_grid_plan's
    subm_k), and rulebooks: the ``Rulebook`` the level's convs read (of
    subm, or of the compacted tables' expanded maps)."""

    grids: tuple
    subm: tuple
    links: tuple
    subm_compact: tuple = ()
    rulebooks: tuple = ()


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
                    caps: list[int], subm_k: int | None = None) -> GridPlan:
    """Build all rulebooks for a forward pass. coords [B,P,3] int point grid
    coords, mask [B,P], caps[l] = V_l. subm_k < 27 also builds the
    compacted slot tables, which the U-Net then convolves over (exact while
    every voxel's live neighbour count is <= subm_k)."""
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
    compact = ()
    maps = subm
    if subm_k is not None and subm_k < 27:
        compact = tuple(compact_subm_neighbors(n, subm_k) for n in subm)
        maps = [expand_compact(idx, oid) for idx, oid in compact]
    return GridPlan(grids=tuple(grids), subm=tuple(subm), links=tuple(links),
                    subm_compact=compact,
                    rulebooks=tuple(Rulebook(n, g.n_voxels.to(torch.int32))
                                    for n, g in zip(maps, grids)))
