"""Fixed-radius ball query + grouping (port of
geoformer_tpu/ops/ball_query.py: _ball_query_scene, _ball_query_hash_scene,
ball_query, query_and_group).

Semantics of the CUDA reference kernel: for each center, the FIRST
``nsample`` points in index order within ``radius``; unfilled slots repeat
the first hit. The voxel-hash path (``cell_cap`` > 0) takes as candidates
the members of the center's 3^3 cell window (exact up to ``cell_cap``
points per cell) and the first hits with a stable sort of the keys, which
orders ties like ``lax.top_k`` (lowest lane first). The brute-force path
(``cell_cap`` = 0) computes every center's distance to every point, 512
centers at a time.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.ops import gather_rows, pad_row
from geoformer_tpu_torch.ops.radius_graph import build_cell_table, cell_coords, window_lookup


def _ball_query_scene(centers, points, point_mask, radius, nsample, center_chunk=512):
    """Brute force: keys iota for the points inside the radius, iota + P
    for the others; the nsample smallest keys in index order are the first
    hits (keys are unique, so no tie order is involved). Unfilled slots
    repeat the row's first slot."""
    k_pts = points.shape[0]
    iota = torch.arange(k_pts, device=points.device)
    idxs, hits = [], []
    for c in torch.split(centers, center_chunk):
        diff = c[:, None, :] - points[None, :, :]
        # summed x + y + z, the JAX reduction's order: a point on the radius
        # falls on the same side
        d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
        inside = (d2 <= radius * radius) & point_mask[None, :]
        key = torch.where(inside, iota, iota + k_pts)
        idx = torch.sort(torch.topk(key, nsample, dim=1, largest=False)[1], dim=1)[0]
        hit = torch.gather(inside, 1, idx)
        idxs.append(torch.where(hit, idx, idx[:, :1]))
        hits.append(hit)
    return torch.cat(idxs), torch.cat(hits)


def _ball_query_hash_scene(centers, points, point_mask, radius, nsample, cell_cap,
                           spatial=1024):
    p = points.shape[0]
    q = centers.shape[0]
    cc = p  # exact: occupied cells <= points
    grid, origin, cell_pts, cell_xyz, _ = build_cell_table(
        points, point_mask, radius, cc, cell_cap, spatial)
    cell_keys = grid.voxel_keys[0]
    n_cells = grid.n_voxels[0]

    ccell = cell_coords(centers, origin, radius, spatial - 1)
    cwin = window_lookup(cell_keys, n_cells, cc, ccell,
                         torch.ones(q, dtype=torch.bool, device=centers.device), spatial)
    width = 27 * cell_cap
    cand = pad_row(cell_pts, p)[cwin].reshape(q, width)
    cpos = pad_row(cell_xyz)[cwin].reshape(q, width * 3)
    diff2 = (cpos - centers.repeat(1, width)) ** 2
    d2 = diff2[:, 0::3] + diff2[:, 1::3] + diff2[:, 2::3]
    inside = (d2 <= radius * radius) & (cand < p)

    # first nsample in index order = the nsample smallest in-radius ids
    key = torch.where(inside, cand, 2 * p)
    pos = torch.sort(key, dim=1, stable=True)[1][:, :nsample]
    idx = torch.gather(cand, 1, pos)
    hit = torch.gather(inside, 1, pos)
    first = torch.where(hit[:, :1], idx[:, :1], 0)
    return torch.where(hit, idx, first), hit


def ball_query(centers, points, point_mask, radius, nsample, cell_cap=0):
    """centers [B,K,3], points [B,P,3], point_mask [B,P] -> (idx
    [B,K,nsample] int64, hit [B,K,nsample] bool). cell_cap > 0: the
    voxel-hash path; 0: brute force."""
    if cell_cap:
        outs = [_ball_query_hash_scene(c, p, m, radius, nsample, cell_cap)
                for c, p, m in zip(centers, points, point_mask)]
    else:
        outs = [_ball_query_scene(c, p, m, radius, nsample)
                for c, p, m in zip(centers, points, point_mask)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def query_and_group(centers, points, feats, point_mask, radius, nsample,
                    normalize_xyz=True, cell_cap=0):
    """Grouped [B,K,nsample,3] relative xyz (optionally / radius) and
    [B,K,nsample,C] features, plus (idx, hit)."""
    idx, hit = ball_query(centers, points, point_mask, radius, nsample, cell_cap)
    gx = gather_rows(points, idx) - centers[:, :, None, :]
    gf = gather_rows(feats, idx)
    if normalize_xyz:
        gx = gx / radius
    return gx, gf, idx, hit
