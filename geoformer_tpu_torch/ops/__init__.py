"""Point-cloud ops of the port (counterpart of geoformer_tpu/ops/__init__.py).

The JAX ops run per scene under ``vmap``; here the batch dimension is
written out, so most ops take ``[B, N, ...]`` tensors. ``gather_rows`` is the
batched row gather that ``vmap(lambda a, i: a[i])`` was.
"""

from __future__ import annotations

import torch


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, *S] (int, every entry in [0, N)) -> [B, *S, ...]."""
    b = x.shape[0]
    bidx = torch.arange(b, device=x.device).view((b,) + (1,) * (idx.ndim - 1))
    return x[bidx, idx]


def pad_row(x: torch.Tensor, value=0) -> torch.Tensor:
    """Append one constant row along dim -2 of [..., N, C]: the explicit
    sink row that a JAX gather reached through a pad slot or out-of-bounds
    clamping."""
    shape = list(x.shape)
    shape[-2] = 1
    return torch.cat([x, x.new_full(shape, value)], dim=-2)
