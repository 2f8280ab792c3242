"""Segment reductions and proposal utilities of PointGroup (port of
geoformer_tpu/ops/segment_ops.py).

- sec_mean / sec_min / sec_max: segment mean / min / max over
  offset-delimited rows of a flat feature matrix;
- roipool: per-proposal max-pool of point features;
- get_iou: IoU matrix of proposals x gt instances from dense masks, the
  intersection one product.

Segments are an offsets vector [M+1] over a flat array; rows at or beyond
``offsets[-1]`` fall into an overflow bucket M that is dropped, and an empty
segment gives 0.
"""

from __future__ import annotations

import torch


def _segment_ids(offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """offsets [M+1] nondecreasing -> per-row segment id [N] (M for rows at or
    beyond offsets[-1])."""
    iota = torch.arange(n_rows, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets[1:].contiguous(), iota, right=True)


def _reduce(feats, offsets, reduce: str):
    """Per-segment reduction [M, C] by ``scatter_reduce`` into M + 1 rows
    (the overflow bucket dropped); empty segments keep their 0."""
    m = offsets.shape[0] - 1
    seg = _segment_ids(offsets, feats.shape[0])
    out = feats.new_zeros((m + 1,) + tuple(feats.shape[1:]))
    seg = seg.view((-1,) + (1,) * (feats.ndim - 1)).expand_as(feats)
    return out.scatter_reduce(0, seg, feats, reduce, include_self=False)[:m]


def sec_mean(feats, offsets):
    """feats [N, C], offsets [M+1] -> per-segment mean [M, C] (0 if empty;
    the divisor is the offsets' count, at least 1)."""
    m = offsets.shape[0] - 1
    seg = _segment_ids(offsets, feats.shape[0])
    sums = feats.new_zeros((m + 1,) + tuple(feats.shape[1:])).index_add(0, seg, feats)[:m]
    counts = (offsets[1:] - offsets[:-1]).to(feats.dtype)
    return sums / counts.clamp(min=1.0)[:, None]


def sec_min(feats, offsets):
    """feats [N, C], offsets [M+1] -> per-segment min [M, C] (0 if empty)."""
    return _reduce(feats, offsets, "amin")


def sec_max(feats, offsets):
    """feats [N, C], offsets [M+1] -> per-segment max [M, C] (0 if empty)."""
    return _reduce(feats, offsets, "amax")


def roipool(feats, proposals_offset):
    """Segment max-pool of point features per proposal: feats [sumNPoint, C]
    (rows ordered by proposal), proposals_offset [nProposal+1] -> [nProposal,
    C]. Its gradient is ``jax.grad``'s through ``segment_max``: a segment's
    gradient is split evenly over the rows that reach its maximum."""
    return sec_max(feats, proposals_offset)


def get_iou(proposal_masks, instance_masks, instance_sizes=None):
    """proposal_masks [nProp, N] bool, instance_masks [nInst, N] bool ->
    IoU [nProp, nInst] float32; ``instance_sizes`` overrides |gt|."""
    p = proposal_masks.to(torch.float32)
    g = instance_masks.to(torch.float32)
    inter = p @ g.T
    p_sz = p.sum(dim=1, keepdim=True)
    g_sz = (instance_sizes.to(torch.float32)[None, :] if instance_sizes is not None
            else g.sum(dim=1)[None, :])
    union = p_sz + g_sz - inter
    return inter / union.clamp(min=1.0)
