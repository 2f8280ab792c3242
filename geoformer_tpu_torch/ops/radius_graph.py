"""Radius-bounded kNN via a voxel hash, the geodesic graph builder (port of
geoformer_tpu/ops/radius_graph.py, the shipped branch).

Points are bucketed into ``radius``-sized cells; every point's candidates
are the members of its 3^3 cell window (27 * cell_cap lanes), found through
a dense scatter grid (``dense_grid`` = 256). The k nearest candidates within
the radius are picked by the CUDA kernel K1 (kernels/knn_select.py), exactly
as the JAX package's Pallas selection picks them. Candidate ids stay integer
tensors throughout (the JAX module packs them as exact f32 values for a TPU
gather; that trick is not needed here).

Ported so far: the full-width candidate path with ``select="pallas"`` and
``dense_grid > 0``. The window/cellwin/topk/passes/approx branches and the
compare-count window lookup for the graph raise until a later slice ports
them. ``window_lookup`` (run-compressed, searchsorted) is ported for the ball
query.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand
from geoformer_tpu_torch.ops import pad_row
from geoformer_tpu_torch.ops.voxelize import voxelize

_BIG = 1e30  # dead-candidate sentinel

# 27 cell offsets (dz, dy, dx)
_WINDOW = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def cell_coords(points: torch.Tensor, origin: torch.Tensor, size: float, hi: int) -> torch.Tensor:
    """clip(floor((points - origin) / size), 0, hi) as int64. The float is
    clamped before the cast so far-away pad points convert safely (the JAX
    cast then clip gives the same cells)."""
    f = torch.floor((points - origin) / size)
    return f.clamp(-1.0, float(hi) + 1.0).long().clamp(0, hi)


def build_cell_table(points, mask, radius, cc, cell_cap, spatial=1024):
    """Bucket one scene's points [P,3] into ``radius``-sized cells.

    Returns (grid [batch of 1], origin, cell_pts [CC, cell_cap] (pad = P),
    cell_xyz [CC, cell_cap*3] member positions with xyz interleaved, and
    n_dropped: valid points not representable as candidates)."""
    p = points.shape[0]
    origin = torch.where(mask[:, None], points, _BIG).amin(dim=0)
    cells = cell_coords(points, origin, radius, spatial - 1)
    grid = voxelize(cells[None], mask[None], cc, spatial)
    p2c = grid.p2v[0]

    order = grid.order[0]
    starts = grid.starts[0]
    sorted_cells = p2c[order]
    rank = torch.arange(p, device=points.device) - starts[sorted_cells.clamp(max=cc)]
    ok = (sorted_cells < cc) & (rank < cell_cap)
    slot = torch.where(ok, sorted_cells * cell_cap + rank, cc * cell_cap)
    cell_pts = torch.full((cc * cell_cap + 1,), p, dtype=torch.long, device=points.device)
    cell_pts[slot] = torch.where(ok, order, p)  # the sink slot is dropped below
    cell_pts = cell_pts[: cc * cell_cap].reshape(cc, cell_cap)

    valid_sorted = mask[order]
    n_dropped = grid.n_overflow[0] + (
        valid_sorted & (sorted_cells < cc) & (rank >= cell_cap)).sum()

    cell_xyz = pad_row(points)[cell_pts.reshape(-1)].reshape(cc, cell_cap * 3)
    return grid, origin, cell_pts, cell_xyz, n_dropped


def window_lookup(cell_keys, n_cells, cc, query_cells, query_valid, spatial=1024):
    """3^3 cell-window lookup: query_cells [N,3] (x,y,z) -> [N,27] cell
    slots into the sorted cell table (cc = not found).

    Each of the 9 (dz,dy) window rows wants three consecutive keys, which
    can only sit at ranks r, r+1, r+2 with r = rank(k-1): one lookup per
    row, a 3-slot gather and a 3x3 equality match."""
    t = cell_keys.shape[0]
    dev = query_cells.device
    x, y, z = query_cells[:, 0], query_cells[:, 1], query_cells[:, 2]
    dyz = torch.tensor([(dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)], device=dev)
    ny = y[:, None] + dyz[None, :, 0]  # [N,9]
    nz = z[:, None] + dyz[None, :, 1]
    row_ok = (ny >= 0) & (ny < spatial) & (nz >= 0) & (nz < spatial) & query_valid[:, None]
    kc = (nz.clamp(0, spatial - 1) * spatial + ny.clamp(0, spatial - 1)) * spatial + x[:, None]
    # rank = searchsorted(side='left'); the JAX module's ranked_lookup
    # computes the same rank with a two-level compare-count
    r = torch.searchsorted(cell_keys, kc - 1)  # [N,9]
    dx3 = torch.arange(-1, 2, device=dev)
    slots = (r[..., None] + (dx3 + 1)).clamp(max=t - 1)  # [N,9,3]
    g = cell_keys[slots]
    wanted = kc[..., None] + dx3  # [N,9,3]
    xs = x[:, None] + dx3[None, :]
    x_ok = (xs >= 0) & (xs < spatial)  # [N,3]
    ok = row_ok[..., None] & x_ok[:, None, :]
    eq = g[:, :, None, :] == wanted[..., None]  # [N,9,3 wanted,3 slots]
    found = ok & eq.any(dim=-1)
    slot_of = torch.gather(slots, 2, eq.to(torch.uint8).argmax(dim=-1))  # first match
    cwin = torch.where(found & (slot_of < n_cells), slot_of.clamp(max=cc - 1), cc)
    return cwin.reshape(query_cells.shape[0], 27)


def window_lookup_dense(table_coords, table_mask, n_cells, cc, query_cells, query_valid,
                        grid_cap=256):
    """3^3 cell-window lookup through a dense [grid_cap^3] grid of cell slots
    (the shipped lookup). Exact while every occupied cell coord is <
    grid_cap; farther cells are counted in n_oob. Valid table coords must be
    unique (voxelize output is).

    Returns ([N,27] cell slots in _WINDOW order, pad = cc; n_oob)."""
    t = table_coords.shape[0]
    dev = table_coords.device
    g3 = grid_cap ** 3
    slots = torch.arange(t, device=dev)
    live = table_mask & (slots < n_cells)
    ok_w = live & ((table_coords >= 0) & (table_coords < grid_cap)).all(-1)
    n_oob = (live & ~ok_w).sum()
    wflat = (table_coords[:, 2] * grid_cap + table_coords[:, 1]) * grid_cap + table_coords[:, 0]
    wflat = torch.where(ok_w, wflat, g3)  # pad/oob cells write the scratch slot
    dense = torch.full((g3 + 1,), cc, dtype=torch.int32, device=dev)
    dense[wflat] = torch.where(ok_w, slots, cc).to(torch.int32)
    offs = torch.tensor([(dx, dy, dz) for (dz, dy, dx) in _WINDOW], device=dev)  # (x,y,z)
    nc = query_cells[:, None, :] + offs[None]  # [N,27,3]
    inr = ((nc >= 0) & (nc < grid_cap)).all(-1) & query_valid[:, None]
    nflat = (nc[..., 2] * grid_cap + nc[..., 1]) * grid_cap + nc[..., 0]
    got = dense[torch.where(inr, nflat, g3)].long()
    return torch.where(inr, got, cc), n_oob


def _radius_knn_scene(points, mask, radius, k, cell_cap, spatial=1024, cell_div=1,
                      dense_grid=256):
    p = points.shape[0]
    dev = points.device
    cc = max(p // max(cell_div, 1), 1)
    grid, origin, cell_pts, cell_xyz, n_dropped = build_cell_table(
        points, mask, radius, cc, cell_cap, spatial)
    p2c = grid.p2v[0]
    n_cells = grid.n_voxels[0]
    ccoords = grid.voxel_coords[0]
    cmask = grid.voxel_mask[0]

    # 27-window per CELL through the dense grid; cells at coords >=
    # dense_grid lose their window edges and their points are counted
    cwin, _ = window_lookup_dense(ccoords, cmask, n_cells, cc, ccoords, cmask,
                                  grid_cap=dense_grid)
    oob_cell = cmask & (ccoords >= dense_grid).any(-1)
    cell_n = (cell_pts < p).sum(1)
    n_dropped = n_dropped + torch.where(oob_cell, cell_n, 0).sum()

    # full-width candidates: every point picks its cell's window, then the
    # members (ids and flat-packed xyz) of the 27 window cells
    live = (p2c < cc) & mask
    cidx = pad_row(cwin, cc)[p2c.clamp(max=cc)]  # [P,27]
    cidx = torch.where(live[:, None], cidx, cc)
    width = 27 * cell_cap
    cand = pad_row(cell_pts, p)[cidx].reshape(p, width)
    cpos = pad_row(cell_xyz)[cidx].reshape(p, width * 3)

    # d2 summed x + y + z per lane, in the JAX order, so the table is
    # bit-equal to the reference's
    diff2 = (cpos - points.repeat(1, width)) ** 2
    d2 = diff2[:, 0::3] + diff2[:, 1::3] + diff2[:, 2::3]
    bad = ((cand >= p) | (cand == torch.arange(p, device=dev)[:, None])
           | (d2 > radius * radius) | ~mask[:, None])
    d2 = torch.where(bad, _BIG, d2)
    if width < k:  # tiny cell_cap: pad the window so k picks exist
        d2 = torch.nn.functional.pad(d2, (0, k - width), value=_BIG)
        cand = torch.nn.functional.pad(cand, (0, k - width), value=p)

    d2k, idx = select_min_k_cand(d2, cand.to(torch.int32), k)
    valid = d2k < _BIG
    idx = torch.where(valid, idx.long(), p)
    return torch.where(valid, d2k, _BIG), idx, n_dropped


def radius_knn(points, mask, radius, k, cell_cap: int = 8, cell_div: int = 1,
               window: int = 0, cellwin: bool = False, dense_grid: int = 256,
               select: str = "pallas"):
    """points [B,P,3], mask [B,P] -> (sq-dists [B,P,k] ascending (1e30 pad),
    idx [B,P,k] int64 (P = pad), n_dropped [B], n_window_pts [B]): the k
    nearest neighbors within ``radius`` of every point (self excluded),
    exact up to ``cell_cap`` points per cell and P // cell_div occupied
    cells; drops are counted in n_dropped."""
    if window or cellwin or not dense_grid or select != "pallas":
        raise NotImplementedError(
            "radius_knn: only the shipped branch (window=0, cellwin=False, "
            "dense_grid>0, select='pallas') is ported")
    outs = [_radius_knn_scene(pt, m, radius, k, cell_cap, cell_div=cell_div,
                              dense_grid=dense_grid)
            for pt, m in zip(points, mask)]
    d2 = torch.stack([o[0] for o in outs])
    idx = torch.stack([o[1] for o in outs])
    n_dropped = torch.stack([o[2] for o in outs])
    return d2, idx, n_dropped, torch.zeros_like(n_dropped)
