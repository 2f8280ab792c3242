"""Radius-bounded kNN via a voxel hash, the geodesic graph builder (port of
geoformer_tpu/ops/radius_graph.py).

Points are bucketed into ``radius``-sized cells; every point's candidates
are the members of its 3^3 cell window. The window is found through a dense
scatter grid (``dense_grid`` > 0, the shipped lookup) or through the sorted
cell keys (``dense_grid`` = 0, ``window_lookup``). The candidates are the
whole window (27 * cell_cap lanes), picked up per point or, with
``cellwin``, per cell, or the window compacted per cell to ``window`` lanes
(``_compact_cell_candidates``). The k nearest candidates within the radius
are picked by the CUDA kernel K1 (``select="pallas"``, kernels/knn_select.py),
by k argmin passes (``"passes"``), or by K1's plain version, a stable sort
(``"topk"``, and ``"approx"``, which is what ``lax.approx_max_k`` computes
off the TPU); with ``sort=False`` the first k in-radius candidates in
candidate order are kept instead. Candidate ids stay integer tensors
throughout (the JAX module packs them as exact f32 values for a TPU gather;
that trick is not needed here).
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand, select_min_k_cand_plain
from geoformer_tpu_torch.ops import pad_row
from geoformer_tpu_torch.ops.voxelize import pack_key, voxelize

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


def ranked_lookup(table, queries, seg: int = 128):
    """searchsorted(table, queries, side='left') for a SORTED 1-D table by a
    two-level compare-count (the JAX module's form): the segments entirely
    below q, then the count inside the one boundary segment."""
    t = table.shape[0]
    ns = (t + seg - 1) // seg
    # padded with the dtype's maximum (F.pad's float value would not hold it)
    fill = table.new_full((ns * seg - t,), torch.iinfo(table.dtype).max)
    rows = torch.cat([table, fill]).reshape(ns, seg)
    seg_max = rows[:, -1]
    q = queries.reshape(-1)
    nfull = (seg_max[None, :] < q[:, None]).sum(dim=1)  # [N] in [0, ns]
    bseg = nfull.clamp(max=ns - 1)
    inseg = (rows[bseg] < q[:, None]).sum(dim=1)
    rank = torch.where(nfull >= ns, t, bseg * seg + inseg)
    return rank.reshape(queries.shape)


def _window_lookup_per_slot(cell_keys, n_cells, cc, query_cells, query_valid, spatial=1024):
    """3^3 cell-window lookup, one ranked_lookup per window slot: [N,3]
    (x,y,z) -> [N,27] cell slots (cc = pad). The exactness oracle of
    ``window_lookup``."""
    offs = torch.tensor([(dx, dy, dz) for (dz, dy, dx) in _WINDOW], device=query_cells.device)
    nc = query_cells[:, None, :] + offs[None]  # [N,27,3]
    in_range = ((nc >= 0) & (nc < spatial)).all(-1) & query_valid[:, None]
    nkey = pack_key(nc.clamp(0, spatial - 1), spatial)
    cwin = ranked_lookup(cell_keys, nkey).clamp(max=cc - 1)
    found = in_range & (cell_keys[cwin] == nkey) & (cwin < n_cells)
    return torch.where(found, cwin, cc)


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


def select_min_k(d2, k):
    """Exact k smallest of each row of d2 [N, W] -> (vals [N, k] ascending,
    pos [N, k] lane ids) by k argmin passes, each masking its pick with
    _BIG. ``torch.argmin`` takes the first minimum, lax's tie order. As in
    the JAX function, on a row with fewer than k finite lanes the exhausted
    passes pick the same _BIG lane again (masking a _BIG lane with _BIG
    changes nothing); the caller's ``d2k < _BIG`` gate drops them."""
    n = d2.shape[0]
    rows = torch.arange(n, device=d2.device)
    cur = d2.clone()
    vals = d2.new_empty(n, k)
    pos = torch.empty(n, k, dtype=torch.long, device=d2.device)
    for i in range(k):
        j = cur.argmin(dim=1)
        vals[:, i] = cur[rows, j]
        pos[:, i] = j
        cur[rows, j] = _BIG
    return vals, pos


# 27 window slots ordered center-first (by squared cell-offset norm, Python's
# stable sort): an overflowing compacted window drops the farthest cells'
# members first
_WINDOW_ORDER = sorted(range(27), key=lambda i: sum(c * c for c in _WINDOW[i]))


def _first_k_ranks(rank, k):
    """Batched searchsorted(side='left') of 1..k in each row of a running
    count rank [N, W] -> [N, k] lanes of the first k counted entries."""
    targets = torch.arange(1, k + 1, device=rank.device)
    return torch.searchsorted(rank, targets.expand(rank.shape[0], k).contiguous(), side="left")


def _compact_cell_candidates(cell_pts, cell_xyz, cwin, cmask, p, window):
    """Per-cell candidate compaction: each cell's 27-window member lists
    (center cell first, _WINDOW_ORDER) compacted to ``window`` dense lanes
    once per cell. Exact while a window holds <= ``window`` members; beyond
    that members are kept round-robin across the 27 cells (member 0 of
    every cell, then member 1, ...). n_window_pts counts the points of the
    cells whose window overflowed."""
    cc, cap = cell_pts.shape
    cwin = cwin[:, _WINDOW_ORDER]
    # [CC, 27, cap] -> member-major [CC, cap, 27]: flat lane = r * 27 + j
    ncand = pad_row(cell_pts, p)[cwin].transpose(1, 2).reshape(cc, 27 * cap)
    nxyz = (pad_row(cell_xyz)[cwin].reshape(cc, 27, cap, 3).transpose(1, 2)
            .reshape(cc, 27 * cap * 3))
    rank = torch.cumsum((ncand < p).long(), dim=1)
    total = rank[:, -1]
    pos = _first_k_ranks(rank, window)
    inb = torch.arange(1, window + 1, device=rank.device)[None, :] <= total[:, None]
    pos = pos.clamp(max=27 * cap - 1)
    ccand = torch.where(inb, torch.gather(ncand, 1, pos), p)
    pos3 = (pos[:, :, None] * 3 + torch.arange(3, device=pos.device)).reshape(cc, window * 3)
    cxyz = torch.gather(nxyz, 1, pos3)
    cell_n = (cell_pts < p).sum(dim=1)
    n_window_pts = torch.where((total > window) & cmask, cell_n, 0).sum()
    return ccand, cxyz, n_window_pts


def _radius_knn_scene(points, mask, radius, k, cell_cap, spatial=1024, sort=True, cell_div=1,
                      window=0, cellwin=False, dense_grid=256, select="pallas"):
    p = points.shape[0]
    dev = points.device
    cc = max(p // max(cell_div, 1), 1)
    grid, origin, cell_pts, cell_xyz, n_dropped = build_cell_table(
        points, mask, radius, cc, cell_cap, spatial)
    p2c = grid.p2v[0]
    n_cells = grid.n_voxels[0]
    ccoords = grid.voxel_coords[0]
    cmask = grid.voxel_mask[0]

    # 27-window per CELL: through the dense grid (cells at coords >=
    # dense_grid lose their window edges and their points are counted) or
    # through the sorted cell keys
    if dense_grid:
        cwin, _ = window_lookup_dense(ccoords, cmask, n_cells, cc, ccoords, cmask,
                                      grid_cap=dense_grid)
        oob_cell = cmask & (ccoords >= dense_grid).any(-1)
        cell_n = (cell_pts < p).sum(1)
        n_dropped = n_dropped + torch.where(oob_cell, cell_n, 0).sum()
    else:
        cwin = window_lookup(grid.voxel_keys[0], n_cells, cc, ccoords, cmask, spatial)

    n_window_pts = torch.zeros_like(n_dropped)
    live = (p2c < cc) & mask
    pc = p2c.clamp(max=cc)
    compact = bool(window) and window < 27 * cell_cap
    if cellwin and not compact:
        # each cell's whole window once per cell, then one wide row a point:
        # the candidate set and lane order of the full-width path
        width = 27 * cell_cap
        win_cand = pad_row(cell_pts, p)[cwin].reshape(cc, width)
        win_xyz = pad_row(cell_xyz)[cwin].reshape(cc, width * 3)
        cand = torch.where(live[:, None], pad_row(win_cand, p)[pc], p)
        cpos = pad_row(win_xyz)[pc]
    elif compact:
        width = max(window, k)
        ccand, cxyz, n_window_pts = _compact_cell_candidates(
            cell_pts, cell_xyz, cwin, cmask, p, width)
        cand = torch.where(live[:, None], pad_row(ccand, p)[pc], p)
        cpos = pad_row(cxyz)[pc]
    else:
        # full width: every point picks its cell's window, then the members
        # (ids and flat-packed xyz) of the 27 window cells
        cidx = torch.where(live[:, None], pad_row(cwin, cc)[pc], cc)  # [P,27]
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

    if not sort:
        # the first k in-radius candidates in candidate order (an arbitrary
        # k of them when more are in radius; the same set when <= k)
        rank = torch.cumsum((d2 < _BIG).long(), dim=1)
        count = rank[:, -1]
        pos = _first_k_ranks(rank, k).clamp(max=d2.shape[1] - 1)
        valid = torch.arange(1, k + 1, device=dev)[None, :] <= count.clamp(max=k)[:, None]
        idx = torch.where(valid, torch.gather(cand, 1, pos), p)
        return (torch.where(valid, torch.gather(d2, 1, pos), _BIG), idx, n_dropped,
                n_window_pts)
    if select == "pallas":
        d2k, idx = select_min_k_cand(d2, cand.to(torch.int32), k)
        idx = idx.long()
    elif select in ("topk", "approx"):
        # K1's plain version: a stable sort cut to k, lax.top_k(-d2)'s order
        # (torch.topk leaves the order of ties unspecified). approx: what
        # lax.approx_max_k computes off the TPU, XLA's exact sort fallback
        d2k, idx = select_min_k_cand_plain(d2, cand, k)
        idx = idx.long()
    elif select == "passes":
        d2k, pos = select_min_k(d2, k)
        idx = torch.gather(cand, 1, pos)
    else:
        raise ValueError(f"radius_knn: unknown select {select!r}")
    valid = d2k < _BIG
    return torch.where(valid, d2k, _BIG), torch.where(valid, idx, p), n_dropped, n_window_pts


def radius_knn(points, mask, radius, k, cell_cap: int = 8, sort: bool = True,
               cell_div: int = 1, window: int = 0, cellwin: bool = False,
               dense_grid: int = 256, select: str = "pallas"):
    """points [B,P,3], mask [B,P] -> (sq-dists [B,P,k] (1e30 pad), idx
    [B,P,k] int64 (P = pad), n_dropped [B], n_window_pts [B]): k neighbours
    within ``radius`` of every point (self excluded), exact up to
    ``cell_cap`` points per cell and P // cell_div occupied cells.

    sort=True returns the k nearest ascending, picked by ``select``
    ("pallas": kernel K1, "passes", "topk", "approx"; all exact and
    equal); sort=False the first k in-radius candidates in candidate order
    (the same edge set wherever the in-radius count <= k). window > 0
    compacts each cell's window to max(window, k) lanes (exact while a
    window holds no more; n_window_pts counts the points of overflowing
    windows); cellwin materialises each cell's whole window once (exact).
    dense_grid > 0 finds the windows through a dense grid (exact while the
    occupied cell coords are < dense_grid; farther cells' points are
    counted in n_dropped), 0 through the sorted cell keys."""
    outs = [_radius_knn_scene(pt, m, radius, k, cell_cap, sort=sort, cell_div=cell_div,
                              window=window, cellwin=cellwin, dense_grid=dense_grid,
                              select=select)
            for pt, m in zip(points, mask)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))
