"""Positional embeddings (port of geoformer_tpu/models/pos_embedding.py:
shift_scale_points, PositionEmbeddingCoordsFourier,
PositionEmbeddingCoordsSine).

The gaussian matrix ``gauss_B`` is a fixed buffer: it comes from the
checkpoint's ``constants`` (weights.from_jax_variables) and is never
re-drawn.
"""

from __future__ import annotations

import math

import numpy as np
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


class PositionEmbeddingCoordsSine(nn.Module):
    """Sine/cosine positional embedding (reference pos_embedding.py
    get_sine_embeddings, :44-86; unused by the shipped configs, which select
    the Fourier type). Per coordinate d: ndim = d_pos // 3 rounded down to
    even, the remainder channels given to the leading coordinates two at a
    time, frequencies temperature**(2*(i//2)/cdim), sin on even and cos on
    odd channels, interleaved. No parameters."""

    def __init__(self, d_pos: int, d_in: int = 3, temperature: float = 10000.0,
                 scale: float = 2.0 * math.pi, normalize: bool = True):
        super().__init__()
        self.d_pos, self.d_in = d_pos, d_in
        self.temperature, self.scale, self.normalize = temperature, scale, normalize

    def forward(self, xyz, pc_mins, pc_maxs):
        """xyz [B,N,3] -> [B,N,d_pos] (channel-last)."""
        x = shift_scale_points(xyz, pc_mins, pc_maxs) if self.normalize else xyz
        ndim = self.d_pos // self.d_in
        if ndim % 2 != 0:
            ndim -= 1
        rems = self.d_pos - ndim * self.d_in
        embeds = []
        for d in range(self.d_in):
            cdim = ndim
            if rems > 0:
                cdim += 2
                rems -= 2
            i = np.arange(cdim, dtype=np.float32)
            dim_t = torch.from_numpy(
                (self.temperature ** (2.0 * (i // 2) / cdim)).astype(np.float32)).to(x.device)
            pos = (x[:, :, d] * self.scale)[:, :, None] / dim_t
            pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
            embeds.append(pos.reshape(pos.shape[0], pos.shape[1], -1))
        return torch.cat(embeds, dim=-1)
