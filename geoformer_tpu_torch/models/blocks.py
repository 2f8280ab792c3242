"""Shared building blocks (port of geoformer_tpu/models/blocks.py).

Module and parameter names follow the JAX variable tree (``Dense_0``,
``MaskedBatchNorm_0``, ``scale``/``bias``, ``mean``/``var``), so that
``weights.from_jax_variables`` is a rename of leaves plus transposes. A flax
``Dense`` is an ``nn.Linear`` here (kernel [in,out] -> weight [out,in]);
a flax ``DenseGeneral`` head projection is an ``nn.Linear`` whose output is
reshaped to ``[..., heads, d_head]``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading axes with statistics over valid rows only
    (torch BatchNorm1d semantics: eps 1e-4, momentum 0.1). x [..., C],
    mask [...]. In eval mode the running statistics are used."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[..., None]
            lead = tuple(range(x.ndim - 1))
            n = m.sum().clamp(min=1.0)
            mean = (x * m).sum(dim=lead) / n
            var = (m * (x - mean) ** 2).sum(dim=lead) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, params ``scale``/``bias``)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class MLPConvBlock(nn.Module):
    """Dense (no bias) + masked BN + ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, x, mask):
        return F.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask))


class GenericMLP(nn.Module):
    """Dense stacks with optional masked BN / ReLU (JAX GenericMLP).
    Layers are named ``Dense_i`` and ``MaskedBatchNorm_j`` in creation order,
    as flax names them."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], output_dim: int,
                 norm: str | None = None, hidden_use_bias: bool = False,
                 output_use_bias: bool = True, output_use_activation: bool = False,
                 output_use_norm: bool = False):
        super().__init__()
        self.norm = norm
        self.output_use_activation = output_use_activation
        self.output_use_norm = output_use_norm and norm == "bn"
        self.n_hidden = len(hidden_dims)
        d, nd, nb = input_dim, 0, 0
        for h in hidden_dims:
            self.add_module(f"Dense_{nd}", nn.Linear(d, h, bias=hidden_use_bias))
            nd += 1
            if norm == "bn":
                self.add_module(f"MaskedBatchNorm_{nb}", MaskedBatchNorm(h))
                nb += 1
            d = h
        self.add_module(f"Dense_{nd}", nn.Linear(d, output_dim, bias=output_use_bias))
        if self.output_use_norm:
            self.add_module(f"MaskedBatchNorm_{nb}", MaskedBatchNorm(output_dim))

    def forward(self, x, mask):
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm == "bn":
                x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask)
            x = F.relu(x)
        x = getattr(self, f"Dense_{self.n_hidden}")(x)
        if self.output_use_norm:
            x = getattr(self, f"MaskedBatchNorm_{self.n_hidden}")(x, mask)
        if self.output_use_activation:
            x = F.relu(x)
        return x


def masked_softmax(logits, mask, dim):
    neg = torch.finfo(logits.dtype).min
    out = torch.softmax(torch.where(mask, logits, neg), dim=dim)
    return torch.where(mask, out, 0.0)


def _chunked_attention(q, k, v, mask, chunk=512):
    """Exact masked softmax attention with an online softmax over key chunks
    (no [B,H,N,N] score tensor). q,k,v [B,N,H,D], mask [B,N] (key
    validity) -> [B,N,H,D]."""
    b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    neg = torch.finfo(q.dtype).min
    m_run = q.new_full((b, n, h), neg)
    s_run = q.new_zeros((b, n, h))
    acc = q.new_zeros((b, n, h, d))
    for s in range(0, n, chunk):
        kb, vb, mb = k[:, s:s + chunk], v[:, s:s + chunk], mask[:, s:s + chunk]
        if kb.shape[1] < chunk:  # zero-padded tail chunk, as in the JAX scan
            pad = chunk - kb.shape[1]
            kb = F.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = F.pad(vb, (0, 0, 0, 0, 0, pad))
            mb = F.pad(mb, (0, pad))
        logits = torch.einsum("bqhd,bkhd->bqhk", q, kb) * scale
        km = mb[:, None, None, :]
        logits = torch.where(km, logits, neg)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        p = torch.where(km, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m_run - m_new)
        s_run = s_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vb)
        m_run = m_new
    return acc / s_run.clamp(min=1e-30)[..., None]


class MultiHeadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention semantics over [B, N, d] (JAX module of the
    same name). Keys of N >= chunk_threshold take the chunked online-softmax
    path when no attention dropout applies."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 chunk_threshold: int = 1024):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.dropout = dropout
        self.chunk_threshold = chunk_threshold
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, mask):
        d_head = self.d_model // self.nhead
        heads = lambda t: t.reshape(t.shape[:-1] + (self.nhead, d_head))
        q, k, v = heads(self.q(q_in)), heads(self.k(k_in)), heads(self.v(v_in))
        use_chunked = k.shape[1] >= self.chunk_threshold and (
            self.dropout == 0.0 or not self.training)
        if use_chunked:
            out = _chunked_attention(q, k, v, mask)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d_head)
            attn = masked_softmax(logits, mask[:, None, None, :], dim=-1)
            attn = F.dropout(attn, self.dropout, self.training)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(out.reshape(out.shape[:-2] + (self.d_model,)))


class SimpleNorm(nn.Module):
    """(x - mean) / (std + eps) with the unbiased std, learnable alpha/bias
    (the backbone bottleneck's hand-rolled Norm)."""

    def __init__(self, d_model: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
        std = torch.where(var > 0, torch.sqrt(torch.where(var > 0, var, 1.0)), 0.0)
        return self.alpha * (x - mean) / (std + self.eps) + self.bias
