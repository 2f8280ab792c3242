"""Sparse 3D U-Net backbone and semantic head (port of
geoformer_tpu/models/unet.py, rulebook form).

Recursive UBlock over nPlanes = [m .. depth*m]: 2 ResidualBlocks per level,
k2s2 down / inverse-k2 up over the GridPlan rulebooks, skip concat + 2 tail
blocks; the two deepest levels run a small dense transformer encoder over
their voxels. The JAX module also carries dense-brick / x-folded layouts for
the TPU; they are layout-only (same parameters) and not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geoformer_tpu_torch.models.blocks import MaskedBatchNorm, MultiHeadSelfAttention, SimpleNorm
from geoformer_tpu_torch.ops.sparse_conv import GridPlan, dense_1x1, down_conv, subm_conv, up_conv


def _conv_param(*shape) -> nn.Parameter:
    # fan-in normal over all but the output axis (the JAX variance_scaling init)
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    return nn.Parameter(torch.randn(*shape) / fan_in ** 0.5)


class ResidualBlock(nn.Module):
    """(BN-ReLU-SubM3-BN-ReLU-SubM3) + identity (1x1 if channels change)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        if in_channels != out_channels:
            self.i_branch = _conv_param(in_channels, out_channels)
        else:
            self.i_branch = None
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels)
        self.conv1 = _conv_param(27, in_channels, out_channels)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels)
        self.conv2 = _conv_param(27, out_channels, out_channels)

    def forward(self, feats, nbr, vmask):
        identity = feats if self.i_branch is None else dense_1x1(feats, self.i_branch)
        x = F.relu(self.MaskedBatchNorm_0(feats, vmask))
        x = subm_conv(x, nbr, self.conv1)
        x = F.relu(self.MaskedBatchNorm_1(x, vmask))
        x = subm_conv(x, nbr, self.conv2)
        return torch.where(vmask[..., None], x + identity, 0.0)


class BottleneckTransformer(nn.Module):
    """Dense encoder over bottleneck voxels: linear position term of the
    masked-centered voxel coords, then pre-norm attention + feed-forward."""

    def __init__(self, d_model: int = 128, n_layers: int = 2, heads: int = 4,
                 d_ff: int = 64, dropout: float = 0.1):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        self.position_linear = nn.Linear(3, d_model)
        for i in range(n_layers):
            self.add_module(f"norm1_{i}", SimpleNorm(d_model))
            self.add_module(f"attn_{i}", MultiHeadSelfAttention(d_model, heads))
            self.add_module(f"norm2_{i}", SimpleNorm(d_model))
            self.add_module(f"ff1_{i}", nn.Linear(d_model, d_ff))
            self.add_module(f"ff2_{i}", nn.Linear(d_ff, d_model))
        self.norm_out = SimpleNorm(d_model)

    def forward(self, feats, xyz, vmask):
        m = vmask.to(feats.dtype)[..., None]
        n = m.sum(dim=1, keepdim=True).clamp(min=1.0)
        centered = (xyz - (xyz * m).sum(dim=1, keepdim=True) / n) * m
        x = feats + self.position_linear(centered)
        drop = lambda t: F.dropout(t, self.dropout, self.training)
        for i in range(self.n_layers):
            x2 = getattr(self, f"norm1_{i}")(x)
            x = x + drop(getattr(self, f"attn_{i}")(x2, x2, x2, vmask))
            x2 = getattr(self, f"norm2_{i}")(x)
            h = drop(F.relu(getattr(self, f"ff1_{i}")(x2)))
            x = x + drop(getattr(self, f"ff2_{i}")(h))
        x = self.norm_out(x)
        return torch.where(vmask[..., None], x, 0.0)


class UBlock(nn.Module):
    """Recursive U-Net block over nPlanes at level ``level``; sparse
    [B, V_level, C] in and out."""

    def __init__(self, n_planes: Sequence[int], block_reps: int = 2, level: int = 0):
        super().__init__()
        self.level = level
        self.block_reps = block_reps
        self.n_planes = tuple(n_planes)
        c0 = n_planes[0]
        for i in range(block_reps):
            self.add_module(f"block{i}", ResidualBlock(c0, c0))
        if len(n_planes) > 1:
            c1 = n_planes[1]
            self.conv_bn = MaskedBatchNorm(c0)
            self.conv_w = _conv_param(8, c0, c1)
            self.u = UBlock(n_planes[1:], block_reps, level + 1)
            self.deconv_bn = MaskedBatchNorm(c1)
            self.deconv_w = _conv_param(8, c1, c0)
            for i in range(block_reps):
                self.add_module(f"block_tail{i}", ResidualBlock(c0 * (2 - i), c0))
        self.has_transformer = len(n_planes) <= 2
        if self.has_transformer:
            d_model = 128
            self.before_transformer_linear = nn.Linear(c0, d_model)
            self.transformer = BottleneckTransformer(d_model)
            self.after_transformer_linear = nn.Linear(d_model, c0)

    def forward(self, x, plan: GridPlan):
        lvl = self.level
        nbr = plan.subm[lvl]
        vmask = plan.grids[lvl].voxel_mask
        for i in range(self.block_reps):
            x = getattr(self, f"block{i}")(x, nbr, vmask)
        if len(self.n_planes) > 1:
            identity = x
            d = F.relu(self.conv_bn(x, vmask))
            d = down_conv(d, plan.links[lvl], self.conv_w)
            d = self.u(d, plan)
            u = F.relu(self.deconv_bn(d, plan.grids[lvl + 1].voxel_mask))
            u = up_conv(u, plan.links[lvl], self.deconv_w)
            u = torch.where(vmask[..., None], u, 0.0)
            x = torch.cat([identity, u], dim=-1)
            for i in range(self.block_reps):
                x = getattr(self, f"block_tail{i}")(x, nbr, vmask)
        if self.has_transformer:
            xyz = plan.grids[lvl].voxel_coords.to(x.dtype)
            h = self.before_transformer_linear(x)
            h = self.transformer(h, xyz, vmask)
            x = self.after_transformer_linear(h)
            x = torch.where(vmask[..., None], x, 0.0)
        return x


class SparseUNetBackbone(nn.Module):
    """input_conv + UBlock + output BN/ReLU: voxel feats [B,V0,Cin] ->
    [B,V0,m]."""

    def __init__(self, in_channels: int, m: int, depth: int = 7, block_reps: int = 2):
        super().__init__()
        self.input_conv = _conv_param(27, in_channels, m)
        self.unet = UBlock([m * (i + 1) for i in range(depth)], block_reps, level=0)
        self.output_bn = MaskedBatchNorm(m)

    def forward(self, voxel_feats, plan: GridPlan):
        vmask0 = plan.grids[0].voxel_mask
        x = subm_conv(voxel_feats, plan.subm[0], self.input_conv)
        x = torch.where(vmask0[..., None], x, 0.0)
        x = self.unet(x, plan)
        return F.relu(self.output_bn(x, vmask0))


class SemanticHead(nn.Module):
    """2x (Dense+BN+ReLU) + Dense->classes."""

    def __init__(self, m: int, classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(m, m)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(m)
        self.Dense_1 = nn.Linear(m, m)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(m)
        self.Dense_2 = nn.Linear(m, classes)

    def forward(self, point_feats, pmask):
        x = F.relu(self.MaskedBatchNorm_0(self.Dense_0(point_feats), pmask))
        x = F.relu(self.MaskedBatchNorm_1(self.Dense_1(x), pmask))
        return self.Dense_2(x)
