"""Set aggregator: FPS -> ball group -> SharedMLP -> max or avg pool (port of
geoformer_tpu/models/aggregator.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geoformer_tpu_torch.models.blocks import MaskedBatchNorm
from geoformer_tpu_torch.ops import gather_rows
from geoformer_tpu_torch.ops.ball_query import query_and_group
from geoformer_tpu_torch.ops.fps import furthest_point_sample


class SharedMLP(nn.Module):
    """Per-point Dense(no bias)+BN+ReLU stack over grouped features."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        d = in_dim
        for i, h in enumerate(dims):
            self.add_module(f"layer{i}", nn.Linear(d, h, bias=False))
            self.add_module(f"bn{i}", MaskedBatchNorm(h))
            d = h

    def forward(self, x, mask):
        for i in range(self.n):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"layer{i}")(x), mask))
        return x


class SetAggregator(nn.Module):
    """group_points + mlp + pool; FPS indices come from ``group`` so the
    caller reuses them (query selection and geodesic seeds)."""

    def __init__(self, in_dim: int, mlp_dims: Sequence[int], radius: float = 0.2,
                 nsample: int = 64, ball_cell_cap: int = 32):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.ball_cell_cap = ball_cell_cap
        self.mlp = SharedMLP(in_dim + 3, mlp_dims)

    def group(self, points, feats, mask, npoint):
        """FPS + ball grouping (no params). points [B,P,3], feats [B,P,C] ->
        (new_xyz [B,K,3], grouped [B,K,ns,3+C], gx, inds, inds_valid, hit)."""
        inds, inds_valid = furthest_point_sample(points, mask, npoint)
        new_xyz = gather_rows(points, inds)
        gx, gf, _, hit = query_and_group(new_xyz, points, feats, mask, self.radius,
                                         self.nsample, normalize_xyz=True,
                                         cell_cap=self.ball_cell_cap)
        return new_xyz, torch.cat([gx, gf], dim=-1), gx, inds, inds_valid, hit

    def forward(self, grouped, group_mask, pooling: str = "max"):
        """grouped [B,K,ns,3+C] -> [B,K,mlp[-1]], pooled over valid slots: the
        max (0 for an empty group) or the mean (divisor at least 1)."""
        h = self.mlp(grouped, group_mask)
        if pooling == "max":
            neg = torch.finfo(h.dtype).min
            h = torch.where(group_mask[..., None], h, neg).amax(dim=2)
            return torch.where(group_mask.any(dim=2)[..., None], h, 0.0)
        if pooling == "avg":
            m = group_mask.to(h.dtype)[..., None]
            return (h * m).sum(dim=2) / m.sum(dim=2).clamp(min=1.0)
        raise ValueError(pooling)
