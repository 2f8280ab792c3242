"""Brute-force exact kNN with the matmul distance trick (port of
geoformer_tpu/ops/knn.py: _knn_scene, knn).

|x-y|^2 = |x|^2 + |y|^2 - 2<x,y>, the cross term one product a tile.
Queries go in chunks of ``query_chunk`` rows; keys stream in tiles of
``key_tile`` with a running top-k merge, so nothing larger than
[query_chunk, key_tile] is materialized. The order of work is JAX's: a
top-k of each tile, a top-k of the running best followed by the tile's
picks, the picks' exact distances recomputed, then a stable sort.

Tie order is ``lax.top_k``'s: among equal values the lowest position wins.
Each top-k here runs on unique int64 keys (the value's float32 bits mapped
to a signed order in the high word, the position in the low word), so the
result does not depend on ``torch.topk``'s unspecified tie order. A row with
fewer than k valid keys keeps the initial (index 0, BIG) in its dead slots,
as the running best comes first in every merge.
"""

from __future__ import annotations

import torch

BIG = 1e30


def _round_up(x, m):
    return -(-x // m) * m


def _ordered_keys(vals: torch.Tensor) -> torch.Tensor:
    """float32 [..., W] -> int64 keys [..., W] that sort as (value in IEEE
    total order, position): unique, so any top-k of them is exact."""
    bits = vals.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(vals.shape[-1], device=vals.device, dtype=torch.int64)
    return (key << 32) | pos


def _min_k(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest of each row, ascending, ties to the lowest
    position (``lax.top_k(-vals, k)``'s positions)."""
    keys = torch.topk(_ordered_keys(vals), k, dim=-1, largest=False, sorted=True)[0]
    return keys & 0xFFFFFFFF


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis of 3, summed x + y + z (the JAX reduction's
    order)."""
    x2 = x * x
    return x2[..., 0] + x2[..., 1] + x2[..., 2]


def _knn_scene(queries, points, mask, k, query_chunk=1024, key_tile=16384):
    p = points.shape[0]
    nq = queries.shape[0]
    key_tile = min(key_tile, _round_up(p, 128))
    query_chunk = min(query_chunk, _round_up(nq, 128))
    pad_keys = (-p) % key_tile
    pts = torch.cat([points, points.new_zeros(pad_keys, 3)])
    msk = torch.cat([mask, mask.new_zeros(pad_keys)])
    n_tiles = pts.shape[0] // key_tile
    pts_sq = _sq_norm(pts)
    dev = points.device

    ds, ids = [], []
    for qc in torch.split(queries, query_chunk):
        q_sq = _sq_norm(qc)
        best_d = torch.full((qc.shape[0], k), BIG, dtype=torch.float32, device=dev)
        best_i = torch.zeros((qc.shape[0], k), dtype=torch.int64, device=dev)
        for t in range(n_tiles):
            lo = t * key_tile
            tp = pts[lo:lo + key_tile]
            d2 = q_sq[:, None] + pts_sq[None, lo:lo + key_tile] - 2.0 * (qc @ tp.T)
            d2 = torch.where(msk[None, lo:lo + key_tile], d2, BIG)
            t_pos = _min_k(d2, k)
            cat_d = torch.cat([best_d, torch.gather(d2, 1, t_pos)], dim=1)
            cat_i = torch.cat([best_i, lo + t_pos], dim=1)
            top = _min_k(cat_d, k)
            best_d = torch.gather(cat_d, 1, top)
            best_i = torch.gather(cat_i, 1, top)
        # the matmul trick loses ~1e-3 to float32 cancellation: recompute the
        # picks' distances exactly
        exact = _sq_norm(qc[:, None, :] - pts[best_i])
        best_d = torch.where(best_d >= BIG, best_d, exact)
        best_d, order = torch.sort(best_d, dim=-1, stable=True)
        ds.append(best_d)
        ids.append(torch.gather(best_i, 1, order))
    return torch.cat(ds).clamp(min=0.0), torch.cat(ids)


def knn(queries, points, mask, k, query_chunk=1024, key_tile=16384):
    """queries [B,Q,3], points [B,P,3], mask [B,P] -> (squared distances
    [B,Q,k] ascending, indices [B,Q,k] int64). FAISS L2 semantics (squared
    distances; callers take the root)."""
    outs = [_knn_scene(q, p, m, k, query_chunk, key_tile)
            for q, p, m in zip(queries, points, mask)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
