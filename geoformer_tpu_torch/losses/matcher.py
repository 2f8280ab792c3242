"""Hungarian matching of queries to ground-truth instances (port of
geoformer_tpu/losses/matcher.py).

The cost matrix is a static [B, Q, MAX_INST] tensor with an instance-validity
mask. Two assignments: ``auction_assign`` (the default,
``tpu_device_matcher``), a forward auction on the device, and
``hungarian_assign``, scipy's ``linear_sum_assignment`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

AUCTION_ROUNDS = 2000  # the JAX auction's round cap
AUCTION_CHECK_EVERY = 25  # rounds between two host reads of the exit test; divides the cap


def build_gt_instances(inst_labels_fg, sem_labels_fg, fg_valid, max_inst: int):
    """One-hot GT instance masks at fg resolution: inst_labels_fg [B,F]
    (per-scene contiguous ids or -100), sem_labels_fg [B,F], fg_valid [B,F]
    -> (inst_masks [B,I,F] f32, inst_valid [B,I], inst_sem [B,I] int64)."""
    ids = torch.arange(max_inst, device=inst_labels_fg.device)
    lab = inst_labels_fg[:, None, :]
    inst_masks = (lab == ids[None, :, None]) & fg_valid[:, None, :] & (lab >= 0)
    inst_valid = inst_masks.any(dim=-1)
    # semantic class of each instance (labels are uniform within an instance)
    sem = torch.where(inst_masks, sem_labels_fg[:, None, :], -1).amax(dim=-1)
    inst_sem = torch.where(inst_valid, sem, 0).long()
    return inst_masks.float(), inst_valid, inst_sem


def dice_cost(mask_logits, inst_masks, fg_valid):
    """[B,Q,F] x [B,I,F] -> [B,Q,I] dice cost."""
    probs = torch.sigmoid(mask_logits) * fg_valid[:, None, :]
    inst_masks = inst_masks.to(probs.dtype)
    num = 2.0 * torch.einsum("bqf,bif->bqi", probs, inst_masks)
    den = probs.sum(-1)[:, :, None] + inst_masks.sum(-1)[:, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def _host_lsa(cost: np.ndarray, inst_valid: np.ndarray) -> np.ndarray:
    import scipy.optimize

    out = np.zeros(inst_valid.shape[0], np.int64)
    cols = np.nonzero(inst_valid)[0]
    if len(cols) > 0:
        rows, picked = scipy.optimize.linear_sum_assignment(
            np.asarray(cost, np.float64)[:, cols])
        out[cols[picked]] = rows
    return out


def hungarian_assign(cost, inst_valid):
    """cost [B,Q,I], inst_valid [B,I] -> pred_inds [B,I] int64 (the query
    matched to each valid instance; 0 for an invalid one), scene by scene
    with scipy on the host."""
    c, v = cost.detach().cpu().numpy(), inst_valid.cpu().numpy()
    out = np.stack([_host_lsa(c[b], v[b]) for b in range(c.shape[0])])
    return torch.from_numpy(out).to(cost.device)


def _auction_round(value, price, assigned, owner, valid, eps):
    """One Jacobi round of the forward auction over every scene: each
    unassigned valid agent (instance) bids best-minus-second-best + eps on
    its best query; each query goes to its highest bidder at the raised
    price, and the owners it displaces become unassigned. value [B,I,Q],
    price [B,Q], assigned [B,I], owner [B,Q]. A scene with no bidder is
    left exactly as it was."""
    b, i, q = value.shape
    neg = -1e9
    bidding = (assigned < 0) & valid
    net = value - price[:, None, :]
    v1, best_q = net.amax(dim=2), net.argmax(dim=2)  # argmax: the first maximum
    v2 = net.scatter(2, best_q[..., None], neg).amax(dim=2)
    incr = torch.where(bidding, v1 - v2 + eps, neg)
    qs = torch.arange(q, device=value.device)
    board = torch.where(bidding[..., None] & (qs == best_q[..., None]), incr[..., None], neg)
    win_bid, win_agent = board.amax(dim=1), board.argmax(dim=1)  # [B,Q]
    won = win_bid > neg / 2
    price = torch.where(won, price + win_bid, price)
    agents = torch.arange(i, device=value.device)
    displaced = torch.where(won, owner, -1)
    was_displaced = (agents[None, :, None] == displaced[:, None, :]).any(dim=2)
    assigned = torch.where(was_displaced, -1, assigned)
    owner = torch.where(won, win_agent, owner)
    hit = agents[None, :, None] == torch.where(won, win_agent, -1)[:, None, :]  # [B,I,Q]
    assigned = torch.where(hit.any(dim=2), hit.long().argmax(dim=2), assigned)
    return price, assigned, owner


@torch.no_grad()
def auction_assign(cost, inst_valid, eps: float = 0.005):
    """Forward auction on the cost's device: [B,Q,I] -> [B,I] int64, the
    same assignment as the JAX auction_assign (one epsilon phase, at most
    AUCTION_ROUNDS Jacobi rounds, then a greedy pass for any agent still
    unassigned). Every scene runs until none of its valid agents bids or
    the cap is reached; a round without bidders changes nothing, so the
    exit test is read on the host every AUCTION_CHECK_EVERY rounds only."""
    b, q, i = cost.shape
    value = -cost.transpose(1, 2).float()  # [B,I,Q]
    price = torch.zeros(b, q, dtype=torch.float32, device=cost.device)
    assigned = torch.full((b, i), -1, dtype=torch.long, device=cost.device)
    owner = torch.full((b, q), -1, dtype=torch.long, device=cost.device)
    rounds = 0
    while rounds < AUCTION_ROUNDS and bool(((assigned < 0) & inst_valid).any()):
        for _ in range(AUCTION_CHECK_EVERY):
            price, assigned, owner = _auction_round(value, price, assigned, owner,
                                                    inst_valid, eps)
        rounds += AUCTION_CHECK_EVERY
    auction_assign.rounds = rounds
    if bool(((assigned < 0) & inst_valid).any()):
        assigned = _greedy_fallback(cost.float(), inst_valid, assigned)
    return torch.where(inst_valid, assigned, 0)


auction_assign.rounds = 0  # rounds run by the last call (a multiple of the check period)


def _greedy_fallback(cost, inst_valid, assigned):
    """Agents still unassigned at the round cap take, in agent order, their
    cheapest query that no valid agent holds."""
    b, q, i = cost.shape
    qs = torch.arange(q, device=cost.device)
    rows = torch.arange(b, device=cost.device)
    for k in range(i):
        held = torch.where(inst_valid, assigned, -1)
        taken = (qs[None, :, None] == held[:, None, :]).any(dim=2)  # [B,Q]
        need = (assigned[:, k] < 0) & inst_valid[:, k]
        pick = torch.where(taken, 1e9, cost[:, :, k]).argmin(dim=1)
        assigned = assigned.clone()
        assigned[rows, k] = torch.where(need, pick, assigned[:, k])
    return assigned
