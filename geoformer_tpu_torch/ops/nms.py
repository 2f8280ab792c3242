"""Matrix NMS and greedy NMS (port of geoformer_tpu/ops/nms.py:
matrix_nms, greedy_nms).

Matrix NMS is SOLO-style gaussian decay: the IoU matrix is one product of
the proposal masks and the decay is closed-form, O(Q^2) with no sequential
loop. Greedy NMS walks the proposals by score, Q steps on the device.
"""

from __future__ import annotations

import torch


def _sorted_ious(masks, scores, valid):
    """Proposals by score descending (stable; invalid ones at -1 sink) ->
    (order, IoU matrix [Q,Q] in that order, valid in that order)."""
    scores = torch.where(valid, scores, -1.0)
    order = torch.argsort(-scores, stable=True)
    m = masks[order].to(torch.float32)
    inter = m @ m.T
    areas = m.sum(dim=1)
    union = areas[:, None] + areas[None, :] - inter
    return order, inter / union.clamp(min=1e-6), valid[order]


def _unsort(x, order):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return x[inv]


def matrix_nms(masks, scores, categories, valid, sigma=2.0, final_score_thresh=0.05):
    """masks [Q,P] bool/float, scores [Q], categories [Q], valid [Q] ->
    (keep [Q] bool, decayed scores [Q]), both in input order. Proposals sort
    by score descending (stable; invalid ones sink)."""
    q = scores.shape[0]
    order, ious, v = _sorted_ious(masks, scores, valid)
    s = torch.where(valid, scores, -1.0)[order]
    c = categories[order]

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

    return _unsort(keep_sorted, order), _unsort(new_scores, order)


def greedy_nms(masks, scores, valid, iou_thresh=0.3):
    """Classic greedy NMS: walk proposals by descending score, suppress any
    later proposal whose IoU with a kept one exceeds iou_thresh.
    masks [Q,P], scores [Q], valid [Q] -> keep [Q] bool (input order).

    JAX's fori_loop as Q steps of device work: no step reads a value on the
    host."""
    q = scores.shape[0]
    order, ious, v = _sorted_ious(masks, scores, valid)
    later = torch.ones(q, q, dtype=torch.bool, device=masks.device).triu(diagonal=1)
    over = (ious > iou_thresh) & later
    keep = v.clone()
    for i in range(q):
        keep &= ~(over[i] & keep[i] & v[i])
    return _unsort(keep, order)
