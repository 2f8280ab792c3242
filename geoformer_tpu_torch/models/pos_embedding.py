"""Fourier positional embedding (port of
geoformer_tpu/models/pos_embedding.py: shift_scale_points,
PositionEmbeddingCoordsFourier).

The gaussian matrix ``gauss_B`` is a fixed buffer: it comes from the
checkpoint's ``constants`` (weights.from_jax_variables) and is never
re-drawn.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def shift_scale_points(xyz, src_a, src_b):
    """(xyz - src_a) / (src_b - src_a) for [B,N,3] points and [B,3] ranges;
    src_b < src_a is legal and flips the normalization (the supervised
    model's pc_dims quirk, models/geoformer.py:_pos_range)."""
    diff = (src_b - src_a)[:, None, :]
    diff = torch.where(diff.abs() < 1e-12, 1e-12, diff)
    return (xyz - src_a[:, None, :]) / diff


class PositionEmbeddingCoordsFourier(nn.Module):
    def __init__(self, d_pos: int, d_in: int = 3, gauss_scale: float = 1.0,
                 normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.register_buffer("gauss_B", torch.randn(d_in, d_pos // 2) * gauss_scale)

    def forward(self, xyz, pc_mins, pc_maxs):
        """xyz [B,N,3] -> [B,N,d_pos] (channel-last)."""
        x = shift_scale_points(xyz, pc_mins, pc_maxs) if self.normalize else xyz
        proj = torch.einsum("bnd,dk->bnk", x * (2.0 * math.pi), self.gauss_B)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
