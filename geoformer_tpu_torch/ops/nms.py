"""Matrix NMS (port of geoformer_tpu/ops/nms.py:matrix_nms).

SOLO-style gaussian decay: the IoU matrix is one product of the proposal
masks and the decay is closed-form, O(Q^2) with no sequential loop. Greedy
NMS is left for a later slice.
"""

from __future__ import annotations

import torch


def matrix_nms(masks, scores, categories, valid, sigma=2.0, final_score_thresh=0.05):
    """masks [Q,P] bool/float, scores [Q], categories [Q], valid [Q] ->
    (keep [Q] bool, decayed scores [Q]), both in input order. Proposals sort
    by score descending (stable; invalid ones sink)."""
    q = scores.shape[0]
    scores = torch.where(valid, scores, -1.0)
    order = torch.argsort(-scores, stable=True)
    m = masks[order].to(torch.float32)
    s = scores[order]
    c = categories[order]
    v = valid[order]

    inter = m @ m.T
    areas = m.sum(dim=1)
    union = areas[:, None] + areas[None, :] - inter
    ious = inter / union.clamp(min=1e-6)

    same_label = (c[:, None] == c[None, :]) & v[:, None] & v[None, :]
    triu = torch.ones(q, q, dtype=torch.bool, device=masks.device).triu(diagonal=1)
    label_matrix = (same_label & triu).to(torch.float32)

    compensate = (ious * label_matrix).amax(dim=0)
    compensate = compensate[:, None].expand(q, q)
    decay_iou = ious * label_matrix

    decay_matrix = torch.exp(-sigma * decay_iou ** 2)
    compensate_matrix = torch.exp(-sigma * compensate ** 2)
    decay_coeff = (decay_matrix / compensate_matrix).amin(dim=0)

    new_scores = s * decay_coeff
    keep_sorted = (new_scores >= final_score_thresh) & v

    inv = torch.empty_like(order)
    inv[order] = torch.arange(q, device=order.device)
    return keep_sorted[inv], new_scores[inv]
