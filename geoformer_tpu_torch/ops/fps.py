"""Furthest point sampling (port of geoformer_tpu/ops/fps.py).

A faithful sequential FPS seeded at index 0: the decoder's queries are the
first n_query_points picks, so order matters. On the card the picks come
from the CUDA kernel K2 (kernels/fps.py); on the CPU from its plain version.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.kernels.fps import fps


def furthest_point_sample(points: torch.Tensor, mask: torch.Tensor, n_samples: int):
    """points [B,P,3], mask [B,P] -> (idx [B,n_samples] int64, valid
    [B,n_samples]). A scene with fewer than n_samples valid points repeats
    picks in its tail; ``valid`` marks the genuine prefix."""
    idx = fps(points, mask, n_samples).long()
    n_valid = mask.sum(dim=-1)
    ar = torch.arange(n_samples, device=points.device)
    return idx, ar[None, :] < n_valid.clamp(max=n_samples)[:, None]
