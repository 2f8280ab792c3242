"""3-NN inverse-distance interpolation and the gather/group wrappers of
pointnet2 (port of geoformer_tpu/ops/interpolate.py).

The reference's channel-first layout is kept: features are [B, C, N].
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.ops.knn import knn


def three_nn(unknown, known, known_mask):
    """unknown [B,N,3], known [B,M,3], known_mask [B,M] -> (dists [B,N,3]
    L2 ascending, idx [B,N,3] int64)."""
    d2, idx = knn(unknown, known, known_mask, 3)
    return torch.sqrt(d2.clamp(min=0.0)), idx


def three_interpolate_weights(dists, eps: float = 1e-8):
    """Inverse-distance weights (1/d) / sum(1/d)."""
    recip = 1.0 / (dists + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def _take(feats, idx):
    """feats [B,C,N], idx [B,*S] -> [B,C,*S]."""
    b, c, _ = feats.shape
    flat = idx.reshape(b, 1, -1).expand(b, c, -1)
    return torch.gather(feats, 2, flat).reshape((b, c) + tuple(idx.shape[1:]))


def three_interpolate(feats, idx, weight):
    """feats [B,C,M], idx [B,N,3], weight [B,N,3] -> [B,C,N]."""
    g = _take(feats, idx) * weight[:, None, :, :]
    return g[..., 0] + g[..., 1] + g[..., 2]


def gather_points(feats, idx):
    """gather_operation: feats [B,C,N], idx [B,m] -> [B,C,m]."""
    return _take(feats, idx)


def group_points(feats, idx):
    """grouping_operation: feats [B,C,N], idx [B,npoint,nsample] ->
    [B,C,npoint,nsample]."""
    return _take(feats, idx)
