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

from geoformer_tpu_torch.parallel.mesh import all_reduce_sum, stats_axis


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading axes with statistics over valid rows only
    (torch BatchNorm1d semantics: eps 1e-4, momentum 0.1). x [..., C],
    mask [...]. In eval mode the running statistics are used; in training
    the batch's, and the running statistics take one update a forward
    unless ``update_stats`` is off (the recompute of a rematerialized
    block, models/unet.py).

    Under a data mesh of N ranks (parallel/mesh.py) the training
    statistics are those of the global batch, as the JAX module computes
    them over the whole sharded batch: ``sum m*x`` and ``sum m`` are summed
    over the ranks, then ``sum m*(x - mean)^2`` (the two-pass form, not
    E[x^2] - E[x]^2, whose rounding differs); ``all_reduce_sum`` carries
    the gradient across the ranks, and the running statistics take the
    global count, so they stay equal on every rank. A rematerialized block
    runs its forward again in the backward and issues the same two
    collectives again: every rank recomputes the same blocks in the same
    order, so the ranks' collectives still pair up.

    On a ("data", "model") mesh the statistics sum over the data axis: the
    ranks of a model group hold the same rows, and each contributes the
    cotangent of its own part of the loss. On query rows that the model axis
    splits (``mesh.on_query_rows``: the query projection, the class and
    controller heads) they sum over every rank."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.update_stats = True

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[..., None]
            lead = tuple(range(x.ndim - 1))
            axis = stats_axis()
            total = all_reduce_sum(torch.cat([(x * m).sum(dim=lead), m.sum()[None]]),
                                   axis=axis, site="batch_norm")
            n = total[-1].clamp(min=1.0)
            mean = total[:-1] / n
            var = all_reduce_sum((m * (x - mean) ** 2).sum(dim=lead), axis=axis,
                                 site="batch_norm") / n
            if self.update_stats:
                self._update_running(mean, var, n)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias

    @torch.no_grad()
    def _update_running(self, mean, var, n) -> None:
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)


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


def dropout_rows(x, p: float, training: bool, dim: int, rows: slice | None, n: int):
    """``F.dropout`` of ``x``, whose axis ``dim`` holds the rows ``rows`` of
    ``n`` (all of them when ``rows`` is None): the mask is drawn for all n
    rows and sliced, so a model rank draws what one process draws for its
    rows, from the same generator state."""
    if rows is None or not training or p == 0.0 or x.shape[dim] == n:
        return F.dropout(x, p, training)
    shape = list(x.shape)
    shape[dim] = n
    keep = F.dropout(x.new_ones(shape), p, True).narrow(dim, rows.start, rows.stop - rows.start)
    return x * keep


def masked_softmax(logits, mask, dim):
    neg = torch.finfo(logits.dtype).min
    out = torch.softmax(torch.where(mask, logits, neg), dim=dim)
    return torch.where(mask, out, 0.0)


def _sdpa_attention(q, k, v, mask):
    """Exact masked softmax attention without an [N, N] score tensor, in the
    forward or the backward: the JAX module's chunked online softmax, here
    F.scaled_dot_product_attention (autograd through a chunk loop would keep
    every chunk's scores, tens of GB at the U-Net bottleneck's 8,192 voxel
    slots). q,k,v [B,N,H,D], mask [B,N] (key validity) -> [B,N,H,D]. Masked
    keys take a bias of the dtype's minimum, so a row with no valid key
    stays finite."""
    bias = q.new_zeros(mask.shape).masked_fill(~mask, torch.finfo(q.dtype).min)
    bias = bias[:, None, None, :].expand(-1, q.shape[2], q.shape[1], -1)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=bias)
    return out.transpose(1, 2)


class MultiHeadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention semantics over [B, N, d] (JAX module of the
    same name). Keys of N >= chunk_threshold take ``_sdpa_attention`` when no
    attention dropout applies (the JAX module's chunked path)."""

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

    def forward(self, q_in, k_in, v_in, mask, rows: slice | None = None):
        """``rows``: the rows of k_in that q_in holds, when q_in holds a
        model rank's queries of them (its attention dropout mask is then
        drawn for every query and sliced)."""
        d_head = self.d_model // self.nhead
        heads = lambda t: t.reshape(t.shape[:-1] + (self.nhead, d_head))
        q, k, v = heads(self.q(q_in)), heads(self.k(k_in)), heads(self.v(v_in))
        use_chunked = k.shape[1] >= self.chunk_threshold and (
            self.dropout == 0.0 or not self.training)
        if use_chunked:
            out = _sdpa_attention(q, k, v, mask)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d_head)
            attn = masked_softmax(logits, mask[:, None, None, :], dim=-1)
            attn = dropout_rows(attn, self.dropout, self.training, 2, rows, k.shape[1])
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(out.reshape(out.shape[:-2] + (self.d_model,)))


class MultiHeadAttention(nn.Module):
    """Cross-attention with decoupled key/value widths (the JAX module of the
    same name; the reference's model/attention.py, a torch-MHA fork with
    kdim/vdim and an optional no-in-projection mode, unused by the shipped
    model). q [B,Nq,dq], k [B,Nk,kdim], v [B,Nk,vdim], mask [B,Nk] -> [B,Nq,
    d_model]. Its q/k/v are the JAX tree's DenseGeneral kernels [in, h, dh]
    flattened to Linear weights [h*dh, in] (weights.from_jax_variables)."""

    def __init__(self, d_model: int, nhead: int, kdim: int | None = None,
                 vdim: int | None = None, dropout: float = 0.0, use_in_proj: bool = True,
                 qdim: int | None = None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.dropout = dropout
        self.use_in_proj = use_in_proj
        if use_in_proj:
            self.q = nn.Linear(qdim or d_model, d_model)
            self.k = nn.Linear(kdim or d_model, d_model)
            self.v = nn.Linear(vdim or d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, mask):
        d_head = self.d_model // self.nhead
        if self.use_in_proj:
            q_in, k_in, v_in = self.q(q_in), self.k(k_in), self.v(v_in)
        heads = lambda t: t.reshape(t.shape[:-1] + (self.nhead, d_head))
        q, k, v = heads(q_in), heads(k_in), heads(v_in)
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
