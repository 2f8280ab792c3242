"""Connected-component clustering over a radius graph, PointGroup's
proposal clustering (port of geoformer_tpu/ops/cluster.py).

- ballquery_dense: every point's fixed-radius neighbours among all points,
  a padded neighbour table plus per-point counts (the brute-force
  ``ball_query``);
- connected_components: min-label propagation with pointer jumping;
- bfs_cluster: components of the ball graph restricted to equal semantic
  labels, clusters below a size threshold dropped.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.ops.ball_query import ball_query


def ballquery_dense(points, mask, radius: float, nsample: int):
    """points [P,3], mask [P] -> (idx [P,nsample] int64, count [P] int32,
    valid [P,nsample] bool); padded slots repeat the first hit."""
    idx, valid = ball_query(points[None], points[None], mask[None], radius, nsample)
    idx, valid = idx[0], valid[0]
    return idx, valid.sum(dim=-1, dtype=torch.int32), valid


def _round(labels, nbr_idx, nbr_valid, point_valid, labels0):
    """One round: the min over a point's neighbours' labels, then pointer
    jumping (label <- label[label])."""
    p = labels.shape[0]
    nbr_labels = torch.where(nbr_valid, labels[nbr_idx], p)
    new = torch.minimum(labels, nbr_labels.amin(dim=-1))
    new = torch.where(point_valid, new, labels0)
    return new[new]


def connected_components(nbr_idx, nbr_valid, point_valid, max_rounds: int | None = None):
    """nbr_idx [P,K], nbr_valid [P,K], point_valid [P] -> component root per
    point [P] int64 (its own index for an invalid point).

    Exactly ``max_rounds`` rounds, ``max(2 * P.bit_length(), 8)`` when not
    given, as JAX's scan runs them: not until convergence, which on a graph
    of long diameter gives other labels. JAX skips the rounds after one that
    changed nothing; such a round leaves a fixed point of the next, so
    running them gives the same labels. The loop reads nothing on the host:
    on a 131,072-point scene at PointGroup's settings every one of the 36
    rounds changed labels, and a per-round check only added its syncs
    (PERF.md)."""
    p = nbr_idx.shape[0]
    if max_rounds is None:
        max_rounds = max(2 * int(p).bit_length(), 8)
    labels = labels0 = torch.arange(p, device=nbr_idx.device)
    for _ in range(max_rounds):
        labels = _round(labels, nbr_idx, nbr_valid, point_valid, labels0)
    return labels


def bfs_cluster(semantic_preds, points, point_valid, radius: float, nsample: int,
                min_cluster: int):
    """Semantic-constrained connected components -> (cluster_root [P] int64,
    cluster_valid [P] bool): each point's component root, and whether it is
    in a kept cluster (same-label component of at least min_cluster points).
    Points with a negative semantic label are background and dropped."""
    idx, _, valid = ballquery_dense(points, point_valid, radius, nsample)
    same_label = semantic_preds[idx] == semantic_preds[:, None]
    fg = point_valid & (semantic_preds >= 0)
    edge_valid = valid & same_label & fg[:, None] & fg[idx]
    roots = connected_components(idx, edge_valid, fg)
    sizes = torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    sizes.index_add_(0, roots, fg.to(torch.int32))
    keep = fg & (sizes[roots] >= min_cluster)
    return roots, keep
