"""Geodesic distance field (port of geoformer_tpu/ops/geodesic.py): the
exact solver (``symmetrize_graph``, ``_geodesic_scene``,
``geodesic_distance``, float32 or int16 fixed point) and the two-level one
(``_prep_edges`` .. ``geodesic_distance_hier``).

Multi-source shortest paths on the radius-kNN graph, laid out [P, Q]. The
exact solver relaxes the whole point graph, in a spatial sweep order, until
a forward + backward pass pair changes nothing or a cap of sweeps is
reached. The two-level solver solves a coarse cell graph to a fixpoint by
fast sweeping over 4 orderings, prolongs it to the points, then smooths it
by a fixed number of fine sweeps. The sweep schedule is the JAX one,
because the values depend on it: 512-row blocks, Jacobi inside a block
(every slab of a block reads the distances as they were before the block),
blocks in order, forward then backward, edge slots in slabs of 8. The JAX
``while_loop`` exits become Python loops that read one flag from the
device per pass. Unreached points keep -1. Dead edges point at an explicit
INF sink row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geoformer_tpu_torch.ops.radius_graph import cell_coords
from geoformer_tpu_torch.ops.voxelize import _voxelize_scene

INF = 3e38
# the exact solver's int16 fixed point: RS units a metre (a power of two,
# ~1 mm), INF_I the unreached sentinel (32 m of range)
RS = 1024.0
INF_I = 32767


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed x + y + z."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _prep_edges(nbr_idx, nbr_dist, point_mask, radius):
    """Gate the kNN table to live radius edges: idx sink -> P, weight -> INF."""
    p = nbr_idx.shape[0]
    live = (nbr_dist <= radius) & (nbr_idx >= 0) & (nbr_idx < p) & point_mask[:, None]
    w = torch.where(live, nbr_dist, INF)
    nb = torch.where(w < INF, nbr_idx.clamp(0, p - 1), p)
    return nb, w


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _spatial_order(positions, point_mask, radius):
    """Permutation sorting points along the packed (z,y,x) cell key at
    ``radius`` resolution: the sweep order of the fine solve."""
    origin = torch.where(point_mask[:, None], positions, 1e9).amin(dim=0)
    cells = cell_coords(positions, origin, radius, 1023)
    key = (cells[:, 2] * 1024 + cells[:, 1]) * 1024 + cells[:, 0]
    key = torch.where(point_mask, key, 2 ** 30)
    return torch.sort(key, stable=True)[1]


def _live_slabs(w2: torch.Tensor, slab: int = 8) -> int:
    """Slabs up to the last edge slot that holds any live edge."""
    slot_live = (w2 < INF).any(dim=0)
    live = torch.nonzero(slot_live)
    last_live = int(live[-1]) if live.numel() else -1
    return min((last_live + slab) // slab, w2.shape[1] // slab)


def _block_sweeps(nb2, w2, dist, n_steps, block_size, n_live=None, int16=False):
    """Alternating forward/backward block sweeps over a padded sorted edge
    table. nb2/w2 [PP, K2] (sink row = PP, K2 a multiple of 8), dist
    [PP+1, Q]. Runs until a pass pair changes nothing or n_steps sweeps
    (a pass pair counts 2). Returns (dist, sweeps run). ``dist`` is updated
    in place. n_live bounds the sweeps to the first n_live rows (valid
    nodes are packed first wherever it is passed).

    With ``int16`` dist is the exact solver's fixed-point table (RS units a
    metre, INF_I unreached) and w2 stays the float weights, rounded here to
    the nearest unit (half to even, as ``jnp.round``): each relaxation
    widens to int32 for the add and clamps back at INF_I."""
    pp = nb2.shape[0]
    n_blocks = pp // block_size
    if n_live is not None:
        n_blocks = min((n_live + block_size - 1) // block_size, n_blocks)
    slab = 8
    n_slabs = _live_slabs(w2, slab)
    if int16:
        w2 = torch.where(w2 < INF, torch.round(w2 * RS), float(INF_I)).to(torch.int32)

    def block_relax(b):
        base = b * block_size
        rows = slice(base, base + block_size)
        nb_b, w_b = nb2[rows], w2[rows]
        dacc = dist[rows].clone()
        for si in range(n_slabs):
            cols = slice(si * slab, (si + 1) * slab)
            if int16:
                cand = (dist[nb_b[:, cols]].int() + w_b[:, cols, None]).amin(dim=1)
                cand = cand.clamp(max=INF_I).to(torch.int16)
            else:
                cand = (dist[nb_b[:, cols]] + w_b[:, cols, None]).amin(dim=1)
            dacc = torch.minimum(dacc, cand)
        dist[rows] = dacc

    it, changed = 0, True
    while changed and it < n_steps:
        prev = dist.clone() if it + 2 < n_steps else None
        for b in range(n_blocks):
            block_relax(b)
        for b in reversed(range(n_blocks)):
            block_relax(b)
        it += 2
        if prev is not None:
            changed = bool((dist < prev).any())
    return dist, it


def _pad_edges(nb, w, p, block_size, slab=8):
    """Pad [P,K] edge tables to block/slab multiples; sink row P -> PP."""
    pad_p = (-p) % block_size
    pp = p + pad_p
    nb = F.pad(nb, (0, 0, 0, pad_p), value=pp)
    w = F.pad(w, (0, 0, 0, pad_p), value=INF)
    nb = torch.where(nb >= p, pp, nb)
    pad_slots = (-nb.shape[1]) % slab
    nb = F.pad(nb, (0, pad_slots), value=pp)
    w = F.pad(w, (0, pad_slots), value=INF)
    return nb, w, pp


def _coarse_contract(positions, point_mask, nb, w, cell, c_cap, kc, k_sub):
    """Contract the fine radius graph onto ``cell``-sized voxel cells.

    Coarse nodes are occupied cells, represented by their first member
    point; a coarse edge exists only where a fine edge crosses two cells, so
    walls stay walls. Edge weight = euclidean rep-to-rep distance.

    Returns (p2c [P] (c_cap = pad), rep [C], rep_pos [C,3], to_rep [P],
    cnb [C,kc], cw [C,kc], cmask [C], ccoords [C,3])."""
    p = positions.shape[0]
    dev = positions.device
    origin = torch.where(point_mask[:, None], positions, 1e9).amin(dim=0)
    cells = cell_coords(positions, origin, cell, 1023)
    g = _voxelize_scene(cells, point_mask, c_cap, 1024)
    p2c, ccoords, cmask, order, starts = g.p2v, g.voxel_coords, g.voxel_mask, g.order, g.starts

    rep = order[starts[:c_cap].clamp(max=p - 1)]
    rep = torch.where(cmask, rep, p)
    pos_pad = F.pad(positions, (0, 0, 0, 1))
    rep_pos = pos_pad[rep]
    p2c_pad = F.pad(p2c, (0, 1), value=c_cap)
    rep_of_point = torch.where(p2c < c_cap, rep[p2c.clamp(max=c_cap - 1)], p)
    to_rep = _norm3(positions - pos_pad[rep_of_point])
    to_rep = torch.where(point_mask & (rep_of_point < p), to_rep, 0.0)

    # fine edges (first k_sub slots: nearest first) -> deduped cell pairs,
    # sorted by the packed pair key; at most kc per source cell
    nbs, ws = nb[:, :k_sub], w[:, :k_sub]
    ci = p2c[:, None].expand_as(nbs)
    cj = p2c_pad[nbs]
    live = (ws < INF) & (ci != cj) & (ci < c_cap) & (cj < c_cap)
    sent = (c_cap + 1) * c_cap + c_cap
    skey_s = torch.sort(torch.where(live, ci * (c_cap + 1) + cj, sent).reshape(-1))[0]

    n_e = skey_s.shape[0]
    prev = F.pad(skey_s[:-1], (1, 0), value=-1)
    head = ((skey_s != prev) & (skey_s < sent)).long()
    hexc = torch.cumsum(head, 0) - head  # exclusive
    ci_starts = torch.searchsorted(
        skey_s, torch.arange(c_cap, device=dev) * (c_cap + 1))
    hexc_pad = F.pad(hexc, (0, 1))
    ci_s = (skey_s // (c_cap + 1)).clamp(max=c_cap - 1)
    cj_s = skey_s - ci_s * (c_cap + 1)  # exact where skey_s < sent
    rank = hexc + head - 1 - hexc_pad[ci_starts[ci_s].clamp(max=n_e)]
    ok = (head > 0) & (rank < kc)
    slot = torch.where(ok, ci_s * kc + rank, c_cap * kc)
    cnb = torch.full((c_cap * kc + 1,), c_cap, dtype=torch.long, device=dev)
    cnb[slot] = torch.where(ok, cj_s, c_cap)  # the sink slot is dropped below
    cnb = cnb[: c_cap * kc].reshape(c_cap, kc)
    rep_pos_pad = F.pad(rep_pos, (0, 0, 0, 1))
    cw = _norm3(rep_pos[:, None, :] - rep_pos_pad[cnb.clamp(max=c_cap)])
    cw = torch.where(cnb < c_cap, cw, INF)
    return p2c, rep, rep_pos, to_rep, cnb, cw, cmask, ccoords


def _fast_sweep_orders(ccoords, cmask, cnb, cw, c_cap, cblock, dist, n_steps, n_live,
                       eps=0.0):
    """Coarse fixpoint by fast sweeping over 4 alternating lexicographic
    orderings, each a forward+backward pass pair. dist [CPP+1, Q] is seeded
    in slot space (ordering 0, zyx-ascending). n_steps caps the TOTAL sweeps
    (a cycle is 8). Returns (dist, sweeps run)."""
    S = 1024
    dev = cnb.device
    x, y, z = ccoords[:, 0], ccoords[:, 1], ccoords[:, 2]
    ar = torch.arange(c_cap, device=dev)
    perms, invs = [ar], [ar]
    for fz, fy in ((1, 0), (0, 1), (1, 1)):
        zz = (S - 1 - z) if fz else z
        yy = (S - 1 - y) if fy else y
        key = torch.where(cmask, (zz * S + yy) * S + x, S * S * S)
        perm = torch.sort(key, stable=True)[1]
        perms.append(perm)
        invs.append(_invert_perm(perm))
    nb2_0, cw2_0, cpp = _pad_edges(cnb, cw, c_cap, cblock)
    tables = [(nb2_0, cw2_0)]
    for o in range(1, 4):
        inv_pad = F.pad(invs[o], (0, 1), value=c_cap)
        nb_o = inv_pad[cnb.clamp(max=c_cap)[perms[o]]]
        nb_o = torch.where(cnb[perms[o]] >= c_cap, c_cap, nb_o)
        tables.append(_pad_edges(nb_o, cw[perms[o]], c_cap, cblock)[:2])
    cross = []  # cross[o]: rows of ordering o+1 in ordering o; pads -> sink
    for o in range(4):
        cm = invs[o][perms[(o + 1) % 4]]
        cross.append(F.pad(cm, (0, cpp + 1 - c_cap), value=cpp))

    it, changed = 0, True
    while changed and it < n_steps:
        prev = dist.clone()
        for o in range(4):
            nb2, w2 = tables[o]
            dist, _ = _block_sweeps(nb2, w2, dist, 2, cblock, n_live=n_live)
            dist = dist[cross[o]]
        changed = bool((prev - dist > eps).any())
        it += 8
    return dist, it


def _scene_edges(nbr_idx, nbr_dist, point_mask, radius, positions, cell_factor,
                 block_size, fine_k=None):
    """A scene's edge tables for the two-level solve: the kNN table gated to
    live radius edges (``_prep_edges``: nb, w [P, K]) and the coarse cell
    size; and the fine sweep's table: those edges cut to the nearest fine_k
    slots, the points sorted along the spatial key at 2x the cell, the edges
    remapped into that order and padded (``_pad_edges``) -> (nb, w, cell,
    perm, inv, nb2 [PP, K2], w2 [PP, K2], PP)."""
    p = nbr_idx.shape[0]
    nb, w = _prep_edges(nbr_idx, nbr_dist, point_mask, radius)
    cell = max(radius, 1e-4) * cell_factor
    fnb, fw = (nb[:, :fine_k], w[:, :fine_k]) if fine_k is not None and fine_k < nb.shape[1] \
        else (nb, w)
    perm = _spatial_order(positions, point_mask, cell * 2)
    inv = _invert_perm(perm)
    nb_s = F.pad(inv, (0, 1), value=p)[fnb[perm]]
    nb2, w2, pp = _pad_edges(nb_s, fw[perm], p, block_size)
    return nb, w, cell, perm, inv, nb2, w2, pp


def _hier_scene(nbr_idx, nbr_dist, seeds, seed_mask, point_mask, radius, positions,
                n_steps, fine_sweeps=6, cell_factor=2.0, c_cap=None, kc=32, k_sub=16,
                block_size=512, fine_k=None, coarse_eps=0.0):
    """Two-level geodesic solve of one scene -> (dist [P,Q] (-1 unreached),
    coarse sweeps run, fine sweeps run)."""
    p, k = nbr_idx.shape
    q = seeds.shape[0]
    dev = positions.device
    if c_cap is None:
        c_cap = max(512, p // 8)
    nb, w, cell, perm, inv, nb2, w2, pp = _scene_edges(
        nbr_idx=nbr_idx, nbr_dist=nbr_dist, point_mask=point_mask, radius=radius,
        positions=positions, cell_factor=cell_factor, block_size=block_size, fine_k=fine_k)
    p2c, rep, rep_pos, to_rep, cnb, cw, cmask, ccoords = _coarse_contract(
        positions, point_mask, nb, w, cell, c_cap, kc, min(k_sub, k))

    # coarse solve over the occupied slot prefix
    cblock = min(block_size, max(c_cap // 8, 8))
    cpp = c_cap + ((-c_cap) % cblock)
    cdist = torch.full((cpp + 1, q), INF, dtype=to_rep.dtype, device=dev)
    seed_cols = torch.arange(q, device=dev)
    safe = seeds.clamp(0, p - 1)
    seed_cell = torch.where(seed_mask, p2c[safe], cpp)
    seed_cell = torch.where(seed_cell >= c_cap, cpp, seed_cell)
    seed_val = torch.where(seed_mask, to_rep[safe], INF)
    cdist[seed_cell, seed_cols] = torch.minimum(cdist[seed_cell, seed_cols], seed_val)
    cdist, coarse_iters = _fast_sweep_orders(
        ccoords, cmask, cnb, cw, c_cap, cblock, cdist, max(n_steps, 256),
        n_live=int(cmask.sum()), eps=coarse_eps)

    # prolong + fixed fine smoothing sweeps over the nearest fine_k slots
    cdist_pad = F.pad(cdist[:c_cap], (0, 0, 0, 1), value=INF)
    p2c_sorted = p2c[perm].clamp(max=c_cap)
    d0 = cdist_pad[p2c_sorted] + to_rep[perm][:, None]
    d0 = torch.where(d0 < INF * 0.5, d0, INF)
    d0 = F.pad(d0, (0, 0, 0, pp - p + 1), value=INF)
    safe_seeds = torch.where(seed_mask, inv[safe], pp)
    d0[safe_seeds, seed_cols] = torch.minimum(d0[safe_seeds, seed_cols],
                                              d0.new_zeros(()))
    dist, fine_iters = _block_sweeps(nb2, w2, d0, fine_sweeps, block_size)

    dist = dist[inv]
    reached = (dist < INF * 0.5) & point_mask[:, None]
    return torch.where(reached, dist, -1.0), coarse_iters, fine_iters


def geodesic_distance_hier(nbr_idx, nbr_dist, seeds, seed_mask, point_mask, radius,
                           n_steps, positions, fine_sweeps=6, cell_factor=2.0, kc=32,
                           k_sub=16, fine_k=None, coarse_eps=0.0):
    """Batched two-level approximate geodesics: [B,P,K] kNN table, [B,Q]
    seeds -> (geo [B,P,Q] (-1 unreached), passes) where passes is a list of
    (coarse sweeps, fine sweeps) per scene."""
    dists, passes = [], []
    for b in range(nbr_idx.shape[0]):
        d, ci, fi = _hier_scene(
            nbr_idx[b], nbr_dist[b], seeds[b], seed_mask[b], point_mask[b], radius,
            positions[b], n_steps, fine_sweeps=fine_sweeps, cell_factor=cell_factor,
            kc=kc, k_sub=k_sub, fine_k=fine_k, coarse_eps=coarse_eps)
        dists.append(d)
        passes.append((ci, fi))
    return torch.stack(dists), passes


def symmetrize_graph(nbr_idx, w, rev_slots=None):
    """Append reverse edges to a forward kNN table.

    nbr_idx [P,K] (dead edges -> P), w [P,K] (dead -> INF) -> (nbr2
    [P,K+R], w2 [P,K+R]). Reverse edges are grouped by destination by one
    stable sort (the rank within a destination depends on it); a
    destination with more than R = rev_slots (default K) in-edges drops the
    overflow, as the JAX function does: those edges still exist forward."""
    p, k = nbr_idx.shape
    r = rev_slots or k
    dev = nbr_idx.device
    wf = w.reshape(-1)
    dst = torch.where(wf < INF, nbr_idx.reshape(-1), p)
    src = torch.arange(p, device=dev).repeat_interleave(k)
    sdst, order = torch.sort(dst, stable=True)
    ssrc, sw = src[order], wf[order]
    # within-destination rank: position - start of the destination's run
    starts = torch.searchsorted(sdst, torch.arange(p + 1, device=dev), side="left")
    rank = torch.arange(p * k, device=dev) - starts[sdst]
    ok = (sdst < p) & (rank < r)
    slot = torch.where(ok, sdst * r + rank, p * r)  # unique where ok
    rev_i = torch.full((p * r + 1,), p, dtype=nbr_idx.dtype, device=dev)
    rev_i[slot] = torch.where(ok, ssrc, p).to(nbr_idx.dtype)  # the sink slot is dropped below
    rev_w = torch.full((p * r + 1,), INF, dtype=w.dtype, device=dev)
    rev_w[slot] = torch.where(ok, sw, INF)
    return (torch.cat([nbr_idx, rev_i[: p * r].reshape(p, r)], dim=1),
            torch.cat([w, rev_w[: p * r].reshape(p, r)], dim=1))


def _geodesic_scene(nbr_idx, nbr_dist, seeds, seed_mask, point_mask, radius, n_steps,
                    rev_slots=None, symmetrize=True, positions=None, block_size=512,
                    int16=False):
    """Exact solve of one scene -> (dist [P,Q] (-1 unreached), sweeps run).

    The gated edges (optionally with their reverse edges) are remapped into
    the sweep order, the points sorted along a spatial key at 4x the radius
    (identity without positions), and relaxed by ``_block_sweeps`` in float
    or in int16 fixed point. Every step is one add and a min, so the table
    is bit-equal to the JAX one's."""
    p = nbr_idx.shape[0]
    q = seeds.shape[0]
    dev = nbr_idx.device
    nb, w = _prep_edges(nbr_idx, nbr_dist, point_mask, radius)
    if symmetrize:
        nb, w = symmetrize_graph(nb, w, rev_slots)
    if positions is not None:
        perm = _spatial_order(positions, point_mask, max(radius, 1e-4) * 4)
    else:
        perm = torch.arange(p, device=dev)
    inv = _invert_perm(perm)
    nb_s = F.pad(inv, (0, 1), value=p)[nb[perm]]  # edges into sorted space
    nb2, w2, pp = _pad_edges(nb_s, w[perm], p, block_size)

    if int16:
        dist = torch.full((pp + 1, q), INF_I, dtype=torch.int16, device=dev)
    else:
        dist = torch.full((pp + 1, q), INF, dtype=w.dtype, device=dev)
    # one entry a column; a masked seed writes the sink row, as in JAX
    safe_seeds = torch.where(seed_mask, inv[seeds.clamp(0, p - 1)], pp)
    dist[safe_seeds, torch.arange(q, device=dev)] = 0
    dist, sweeps = _block_sweeps(nb2, w2, dist, n_steps, block_size, int16=int16)

    dist = dist[inv]  # back to the original point order
    if int16:
        reached = (dist < INF_I) & point_mask[:, None]
        return torch.where(reached, dist.to(w.dtype) / RS, -1.0), sweeps
    reached = (dist < INF * 0.5) & point_mask[:, None]
    return torch.where(reached, dist, -1.0), sweeps


def geodesic_distance(nbr_idx, nbr_dist, seeds, seed_mask, point_mask, radius, n_steps,
                      rev_slots=None, symmetrize=True, positions=None, int16=False):
    """Batched exact multi-source geodesics over a kNN graph.

    nbr_idx [B,P,K] neighbour ids (self excluded), nbr_dist [B,P,K]
    euclidean (not squared) edge lengths, seeds [B,Q] point ids, seed_mask
    [B,Q], point_mask [B,P], positions [B,P,3] or None (identity sweep
    order) -> (geo [B,P,Q], -1 where unreached; sweeps run per scene).

    rev_slots caps the reverse-edge bucket of a node (default K) when
    ``symmetrize``. ``int16`` relaxes in fixed point (the JAX
    ``relax_dtype=jnp.int16``): 1/1024 m units, 32 m of range. Seed
    columns are independent: a column at its fixpoint no longer changes,
    so any split of the columns gives the columns of the whole."""
    dists, sweeps = [], []
    for b in range(nbr_idx.shape[0]):
        d, s = _geodesic_scene(
            nbr_idx[b], nbr_dist[b], seeds[b], seed_mask[b], point_mask[b], radius, n_steps,
            rev_slots, symmetrize, None if positions is None else positions[b], int16=int16)
        dists.append(d)
        sweeps.append(s)
    return torch.stack(dists), sweeps
