"""DETR-style decoder with geodesic-guided relative vector attention (port of
geoformer_tpu/models/decoder.py).

Pre-norm layers, batch-first [B, N, d]. Cross-attention is a vector
attention: similarity = MLP(query - context + rel_pos), values =
v_mlp(context + rel_pos), softmax over contexts. The reference's residual
quirk is kept: after the cross-attention the residual adds
dropout(norm2(pre-attention tgt)), not the pre-attention stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from geoformer_tpu_torch.models.blocks import LayerNorm, MultiHeadSelfAttention, masked_softmax


class RelDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadSelfAttention(d_model, nhead, dropout)
        self.norm2 = LayerNorm(d_model)
        self.attn_mlp0 = nn.Linear(d_model, d_model)
        self.attn_mlp1 = nn.Linear(d_model, d_model)
        self.v_mlp = nn.Linear(d_model, d_model)
        self.out_mlp = nn.Linear(d_model, d_model)
        self.norm3 = LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, memory, query_pos, rel_pos, query_mask, memory_mask):
        """tgt [B,Q,d], memory [B,K,d], query_pos [B,Q,d], rel_pos
        [B,Q,K,d], query_mask [B,Q], memory_mask [B,K]."""
        drop = lambda t: F.dropout(t, self.dropout, self.training)
        tgt2 = self.norm1(tgt)
        qk = tgt2 + query_pos
        tgt = tgt + drop(self.self_attn(qk, qk, tgt2, query_mask))
        tgt2 = self.norm2(tgt)

        diff = tgt2[:, :, None, :] - memory[:, None, :, :] + rel_pos  # [B,Q,K,d]
        sim = self.attn_mlp1(F.relu(self.attn_mlp0(diff)))
        attn = masked_softmax(sim / math.sqrt(self.d_model), memory_mask[:, None, :, None], dim=2)
        v2 = self.v_mlp(memory[:, None, :, :] + rel_pos)
        out = F.relu(self.out_mlp((attn * v2).sum(dim=2)))

        tgt = out + drop(tgt2)  # reference residual quirk
        tgt2 = self.norm3(tgt)
        h = drop(F.relu(self.linear1(tgt2)))
        return tgt + drop(self.linear2(h))


class TransformerDecoder(nn.Module):
    """Stack of RelDecoderLayers returning every layer's output through the
    shared final LayerNorm: [L, B, Q, d]."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.norm = LayerNorm(d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", RelDecoderLayer(d_model, nhead, dim_feedforward, dropout))

    def forward(self, tgt, memory, query_pos, rel_pos, query_mask, memory_mask):
        outputs = []
        x = tgt
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, memory, query_pos, rel_pos, query_mask, memory_mask)
            outputs.append(self.norm(x))
        return torch.stack(outputs)
