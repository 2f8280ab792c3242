"""Few-shot criterion (port of geoformer_tpu/losses/criterion_fs.py).

dice + focal on the Hungarian-matched masks (dice-only cost) plus the
similarity loss: per-query labels from the IoU of the predicted mask with
its mode instance (positive >= 0.5, negative <= 0.3), BCE with hard-negative
mining at negative_ratio x positives. Positives are excluded from the
negative pool, the intended semantics of the reference (see the JAX
module's note).

Under a data mesh (parallel/mesh.py) the similarity loss divides by the
global batch's positives (summed over the ranks with no gradient) and the
mask losses by the global batch size (losses/criterion.py).

On a model axis the mask losses and the match follow losses/criterion.py.
The similarity logits [B,Q] are every query's on every model rank (the
similarity net scores the first Q contexts, which each rank holds); only
the per-query labels come from a rank's own mask logits, and are gathered
over the model group. Hard-negative mining ranks all Q queries of a scene,
so the similarity loss is computed whole on each model rank and counts on
model index 0 (``replica_weight``).
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.losses.criterion import matched_mask_losses, matcher
from geoformer_tpu_torch.losses.matcher import build_gt_instances, dice_cost
from geoformer_tpu_torch.parallel.mesh import (
    all_gather_queries,
    all_reduce_sum,
    queries_sharded,
    query_slice,
    replica_weight,
)


def bce_with_logits(logits, targets):
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


@torch.no_grad()
def similarity_labels(mask_logits, inst_fg, fg_valid, query_valid, max_inst: int = 64):
    """Each query's similarity label from its predicted mask: mask_logits
    [B,Qr,F] (the last layer), query_valid [B,Qr] of the same queries,
    inst_fg [B,F] instance labels -> (is_pos, is_neg) [B,Qr]. ``max_inst``
    is the mode search's capacity, at least the config's
    ``tpu_max_instances``."""
    pred = (torch.sigmoid(mask_logits) > 0.5) & fg_valid[:, None, :]  # [B,Qr,F]
    ids = torch.arange(max_inst, device=inst_fg.device)
    pos, neg = [], []
    for b in range(mask_logits.shape[0]):
        pred_b, inst_b, fval_b, qval_b = pred[b], inst_fg[b], fg_valid[b], query_valid[b]
        inst_onehot = (inst_b[None, :] == ids[:, None]) & fval_b[None, :]  # [I,F]
        counts = pred_b.float() @ inst_onehot.float().T  # [Q,I]
        cnt_unlab = (pred_b & (inst_b[None, :] == -100)).sum(-1)  # [Q]
        best_cnt, best_i = counts.amax(-1), counts.argmax(-1)
        npred = pred_b.sum(-1)
        # torch.mode picks the smallest value on ties; -100 < any id
        mode_is_unlab = cnt_unlab >= best_cnt
        empty = npred == 0
        gt = inst_onehot[best_i]  # [Q,F]
        inter = (pred_b & gt).sum(-1)
        union = (pred_b | gt).sum(-1)
        iou = inter / union.clamp(min=1)
        labelled = ~empty & ~mode_is_unlab & qval_b
        pos.append(labelled & (iou >= 0.5))
        neg.append(((empty | mode_is_unlab) & qval_b) | (labelled & (iou <= 0.3)))
    return torch.stack(pos), torch.stack(neg)


def similarity_loss(similarity, mask_logits, inst_fg, fg_valid, query_valid, negative_ratio,
                    max_inst: int = 64):
    """similarity [B,Q] logits, mask_logits [B,Q,F] (the last layer; no
    gradient flows into it), inst_fg [B,F] instance labels."""
    is_pos, is_neg = similarity_labels(mask_logits, inst_fg, fg_valid, query_valid, max_inst)
    return labelled_similarity_loss(similarity, is_pos, is_neg, negative_ratio)


def labelled_similarity_loss(similarity, is_pos, is_neg, negative_ratio):
    """similarity [B,Q] logits, is_pos / is_neg [B,Q] (``similarity_labels``):
    BCE of the positives and of the hardest negatives, ``negative_ratio``
    of them a positive, over the global batch's positives."""
    losses, n_pos = [], []
    for b in range(similarity.shape[0]):
        is_pos_b, is_neg_b = is_pos[b], is_neg[b]
        num_pos = is_pos_b.sum()
        n_hard = torch.minimum(is_neg_b.sum(), negative_ratio * num_pos)
        bce = bce_with_logits(similarity[b], is_pos_b.float())
        loss_pos = (bce * is_pos_b).sum()
        neg_sorted = torch.sort(torch.where(is_neg_b, bce, -1.0), descending=True,
                                stable=True)[0]
        ranks = torch.arange(neg_sorted.shape[0], device=neg_sorted.device)
        loss_hard = torch.where(ranks < n_hard, neg_sorted.clamp(min=0.0), 0.0).sum()
        losses.append(loss_pos + loss_hard)
        n_pos.append(num_pos)
    total_pos = all_reduce_sum(torch.stack(n_pos).sum(), site="similarity_count")
    loss = torch.stack(losses).sum() / total_pos.clamp(min=1)
    return torch.where(total_pos > 0, loss, 0.0)


class FSInstSetCriterion:
    def __init__(self, cfg):
        self.cfg = cfg
        self.max_inst = cfg.tpu_max_instances
        self.negative_ratio = cfg.negative_ratio
        self.cal_simloss = "similarity_net" not in cfg.fix_module
        self._assign = matcher(cfg)
        self.w_dice = getattr(cfg, "loss_dice_weight", 1.0)
        self.w_focal = getattr(cfg, "loss_focal_weight", 1.0)

    def __call__(self, outputs, batch, epoch):
        """-> (loss, loss_dict of scalar tensors)."""
        fg_idx, fg_valid = outputs["fg_idx"], outputs["fg_valid"]
        inst_fg = torch.gather(batch["instance_labels"], 1, fg_idx)
        sem_fg = torch.gather(batch["labels"], 1, fg_idx)
        query_valid = outputs["query_valid"]  # [B,Q]
        mask_logits = outputs["mask_logits"]  # [L,B,Qr,F]
        q = query_valid.shape[1]
        rows = query_slice(q)
        valid = query_valid[:, rows]
        w_query = 1.0 if queries_sharded(q) else replica_weight()

        loss = mask_logits.new_zeros(())
        loss_dict = {}
        if epoch > self.cfg.prepare_epochs and self.cal_simloss:
            labels = torch.stack(similarity_labels(mask_logits[-1], inst_fg, fg_valid, valid,
                                                   max_inst=self.max_inst)).to(torch.uint8)
            is_pos, is_neg = all_gather_queries(labels, q, dim=2, site="similarity_labels").bool()
            sim_l = labelled_similarity_loss(outputs["similarity"], is_pos, is_neg,
                                             self.negative_ratio) * replica_weight()
            loss = loss + sim_l
            loss_dict["sim_loss"] = sim_l

        inst_masks, inst_valid, _ = build_gt_instances(inst_fg, sem_fg, fg_valid, self.max_inst)
        with torch.no_grad():
            cost = dice_cost(mask_logits[-1], inst_masks, fg_valid)
            cost = torch.where(valid[:, :, None], cost, 1e6)
            cost = all_gather_queries(cost, q, site="match_cost")
            pred_inds = self._assign(cost, inst_valid)

        n_layers = mask_logits.shape[0]
        for layer in range(n_layers):
            d, f = matched_mask_losses(mask_logits[layer], pred_inds, inst_masks, inst_valid,
                                       fg_valid, first=rows.start)
            d, f = d * w_query, f * w_query
            loss = loss + self.w_dice * d + self.w_focal * f
            if layer == n_layers - 1:
                loss_dict.update({"dice_loss": d, "focal_loss": f})
        loss_dict["num_gt"] = inst_valid.float().sum() * replica_weight()
        loss_dict["loss"] = loss
        return loss, loss_dict
