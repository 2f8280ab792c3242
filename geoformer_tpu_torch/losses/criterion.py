"""Supervised set criterion (port of geoformer_tpu/losses/criterion.py).

Prepare phase (epoch <= prepare_epochs): semantic CE only. Full phase: per
decoder layer, dice + sigmoid-focal on the Hungarian-matched masks and CE
over the query classes; the match is made once, on the detached last layer,
and reused for every layer. All losses are masked static-shape math.

Under a data mesh (parallel/mesh.py) each rank holds its rows of the global
batch, and every normaliser that spans scenes is the global one, summed
over the ranks with no gradient: the semantic CE's count of labelled
points and the batch size that the mask and class losses divide by. A
rank's loss is then its part of the global loss, and the sum of the ranks'
gradients is the global gradient. Per-scene normalisers (a scene's matched
instances, its valid points, its valid queries) stay local; so does the
matcher, which is per scene.

On a model axis (parallel/mesh.py) a rank holds the predictions of its own
queries. It computes their rows of the [B, Q, I] cost matrix, which is
gathered over the model group; every model rank runs the same assignment
on it and keeps the matches that fall in its rows. The mask and class
losses then sum over its queries (the class CE still divides by the
scene's valid queries, all Q of them), and a term that every rank of a
model group computes alike, the semantic CE and the matched-instance count,
counts on model index 0 only (``replica_weight``); so do the query terms
where M does not divide Q and every model rank runs all queries. The
ranks' losses then sum to the global loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geoformer_tpu_torch.losses.matcher import (
    auction_assign,
    build_gt_instances,
    dice_cost,
    hungarian_assign,
)
from geoformer_tpu_torch.parallel.mesh import (
    all_gather_queries,
    all_reduce_sum,
    data_rows,
    queries_sharded,
    query_slice,
    replica_weight,
)


def softmax_cross_entropy_ignore(logits, labels, ignore_label=-100, valid=None,
                                 global_count: bool = False, count=None):
    """Mean CE over the entries whose label != ignore (and valid); with
    ``global_count`` over the global batch's entries (the count summed over
    the ranks of the data mesh); ``count`` gives the divisor instead (the
    entries of which these are a model rank's share)."""
    mask = labels != ignore_label
    if valid is not None:
        mask = mask & valid
    safe = torch.where(mask, labels, 0).long()
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
    if count is None:
        count = mask.sum()
    if global_count:
        count = all_reduce_sum(count, site="semantic_count")
    return torch.where(mask, ce, 0.0).sum() / count.clamp(min=1)


def masked_dice_loss(pred_logits, targets, pair_valid, point_valid, num_gt):
    """pred_logits/targets [I,F], pair_valid [I], point_valid [F]."""
    probs = torch.sigmoid(pred_logits) * point_valid[None, :]
    t = targets * point_valid[None, :]
    num = 2.0 * (probs * t).sum(-1)
    den = probs.sum(-1) + t.sum(-1)
    loss = 1.0 - (num + 1.0) / (den + 1.0)
    return (loss * pair_valid).sum() / (num_gt + 1e-6)


def masked_focal_loss(pred_logits, targets, pair_valid, point_valid, num_gt,
                      alpha=0.25, gamma=2.0):
    """Mean over points, then sum over pairs / num_gt."""
    p = torch.sigmoid(pred_logits)
    ce = (pred_logits.clamp(min=0) - pred_logits * targets
          + torch.log1p(torch.exp(-pred_logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * loss * point_valid[None, :]
    per_pair = loss.sum(-1) / point_valid.sum().clamp(min=1)
    return (per_pair * pair_valid).sum() / (num_gt + 1e-6)


def matched_mask_losses(mask_logits, pred_inds, inst_masks, inst_valid, fg_valid,
                        first: int = 0):
    """One layer's dice and focal: mask_logits [B,Qr,F] (the queries first
    .. first + Qr) gathered at the matched queries pred_inds [B,I] that fall
    among them, per scene over its own instances, summed and divided by
    the global batch size (each pair divided by the scene's instances)."""
    qr = mask_logits.shape[1]
    mine = inst_valid & (pred_inds >= first) & (pred_inds < first + qr)
    local = (pred_inds - first).clamp(0, qr - 1)
    pm = torch.gather(mask_logits, 1, local[..., None].expand(-1, -1, mask_logits.shape[2]))
    pv = mine.float()
    n_inst = inst_valid.float().sum(dim=1)
    dice = focal = 0.0
    for b in range(mask_logits.shape[0]):
        ngt = n_inst[b]
        dice = dice + masked_dice_loss(pm[b], inst_masks[b], pv[b], fg_valid[b], ngt)
        focal = focal + masked_focal_loss(pm[b], inst_masks[b], pv[b], fg_valid[b], ngt)
    bsz = data_rows(mask_logits.shape[0])[0]
    return dice / bsz, focal / bsz


def matcher(cfg):
    """The assignment the config asks for: the device auction by default."""
    return auction_assign if getattr(cfg, "tpu_device_matcher", True) else hungarian_assign


class InstSetCriterion:
    def __init__(self, cfg):
        self.cfg = cfg
        self.max_inst = cfg.tpu_max_instances
        self.ignore = cfg.ignore_label
        self.sem_fixed = "semantic" in cfg.fix_module or "semantic_linear" in cfg.fix_module
        self._assign = matcher(cfg)
        self.w_dice = getattr(cfg, "loss_dice_weight", 1.0)
        self.w_focal = getattr(cfg, "loss_focal_weight", 1.0)
        self.w_cls = getattr(cfg, "loss_cls_weight", 1.0)

    def __call__(self, outputs, batch, epoch):
        """-> (loss, loss_dict of scalar tensors)."""
        semantic_scores = outputs["semantic_scores"]  # [B,P,C]
        if self.sem_fixed:
            sem_loss = semantic_scores.new_zeros(())
        else:
            sem_loss = softmax_cross_entropy_ignore(
                semantic_scores, batch["labels"], self.ignore, batch["point_mask"],
                global_count=True) * replica_weight()
        loss = sem_loss
        loss_dict = {"sem_loss": sem_loss}
        if epoch <= self.cfg.prepare_epochs or "mask_logits" not in outputs:
            loss_dict["loss"] = loss
            return loss, loss_dict

        fg_idx, fg_valid = outputs["fg_idx"], outputs["fg_valid"]
        inst_fg = torch.gather(batch["instance_labels"], 1, fg_idx)
        sem_fg = torch.gather(batch["labels"], 1, fg_idx)
        inst_masks, inst_valid, inst_sem = build_gt_instances(
            inst_fg, sem_fg, fg_valid, self.max_inst)

        mask_logits = outputs["mask_logits"]  # [L,B,Qr,F]
        cls_logits = outputs["cls_logits"]  # [L,B,Qr,C]
        query_valid = outputs["query_valid"]  # [B,Q]
        q = query_valid.shape[1]
        rows = query_slice(q)
        valid = query_valid[:, rows]
        # the query terms' weight: this rank's share, or all Q on each model rank
        w_query = 1.0 if queries_sharded(q) else replica_weight()

        # match on the last layer (detached), reuse for the other layers
        with torch.no_grad():
            cost_d = dice_cost(mask_logits[-1], inst_masks, fg_valid)
            cls_prob = torch.softmax(cls_logits[-1], dim=-1)  # [B,Qr,C]
            cost_c = -torch.gather(cls_prob, 2, inst_sem[:, None, :].expand_as(cost_d))
            cost = torch.where(valid[:, :, None], cost_d + cost_c, 1e6)
            cost = all_gather_queries(cost, q, site="match_cost")  # [B,Q,I]
            pred_inds = self._assign(cost, inst_valid)  # [B,I]

        bsz = mask_logits.shape[1]
        global_bsz = data_rows(bsz)[0]
        # class targets: 0 everywhere but at the matched queries
        cls_label = torch.zeros(query_valid.shape, dtype=torch.long, device=cls_logits.device)
        cls_label = cls_label.scatter_reduce(1, pred_inds, torch.where(inst_valid, inst_sem, 0),
                                             reduce="amax")[:, rows]
        n_valid = query_valid.sum(dim=1)
        n_layers = mask_logits.shape[0]
        for layer in range(n_layers):
            d, f = matched_mask_losses(mask_logits[layer], pred_inds, inst_masks, inst_valid,
                                       fg_valid, first=rows.start)
            c = sum(softmax_cross_entropy_ignore(cls_logits[layer, b], cls_label[b], -100,
                                                 valid[b], count=n_valid[b])
                    for b in range(bsz)) / global_bsz
            d, f, c = d * w_query, f * w_query, c * w_query
            loss = loss + self.w_dice * d + self.w_focal * f + self.w_cls * c
            if layer == n_layers - 1:
                loss_dict.update({"dice_loss": d, "focal_loss": f, "cls_loss": c})
        loss_dict["num_gt"] = inst_valid.float().sum() * replica_weight()
        loss_dict["loss"] = loss
        return loss, loss_dict


def focal_loss_v1(logits, labels, alpha=0.25, gamma=2.0, valid=None):
    """Standalone multi-label focal loss (reference criterion.py:87-113
    FocalLossV1, unused by the training loop): mean over the valid entries."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * labels + (1 - p) * (1 - labels)
    alpha_t = alpha * labels + (1 - alpha) * (1 - labels)
    loss = alpha_t * ce * (1 - p_t) ** gamma
    if valid is None:
        return loss.mean()
    v = valid.to(loss.dtype)
    return (loss * v).sum() / v.sum().clamp(min=1.0)


def compute_score_loss(scores, ious, valid, thresh_pos=0.5, thresh_neg=0.25):
    """Proposal-score regression loss (reference criterion.py:65-84,
    unused): BCE against soft labels from the IoU, 1 above thresh_pos, 0
    below thresh_neg, linear in between."""
    soft = ((ious - thresh_neg) / (thresh_pos - thresh_neg)).clamp(0.0, 1.0)
    ce = scores.clamp(min=0) - scores * soft + torch.log1p(torch.exp(-scores.abs()))
    v = valid.to(ce.dtype)
    return (ce * v).sum() / v.sum().clamp(min=1.0)
