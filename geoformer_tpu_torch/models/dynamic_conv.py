"""CondInst-style dynamic convolution mask head (port of
geoformer_tpu/models/dynamic_conv.py).

Per query, a controller emits the weights of a 2-layer point MLP over
[geodesic-corrected relative coords | mask features]; the grouped conv1d
of the reference is a batched product over queries, in chunks of 64 queries
so the [Qc, m, P] hidden stays bounded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geoformer_tpu_torch.models.blocks import MLPConvBlock


def dynamic_param_sizes(m: int, use_coords: bool = True):
    """Split sizes of the 2-layer dynamic conv: [(m+3)*m, m] weights, [m, 1]
    biases."""
    c_in = m + 3 if use_coords else m
    weight_nums = [c_in * m, m]
    bias_nums = [m, 1]
    return weight_nums, bias_nums, sum(weight_nums) + sum(bias_nums)


class Controller(nn.Module):
    """before_embedding tower (Dense+BN+ReLU dec_dim->m) + controller Dense."""

    def __init__(self, in_dim: int, m: int, num_gen_params: int):
        super().__init__()
        self.before_embedding = MLPConvBlock(in_dim, m)
        self.controller = nn.Linear(m, num_gen_params)

    def forward(self, x, mask):
        return self.controller(self.before_embedding(x, mask))


def parse_dynamic_params(params, m: int, use_coords: bool = True):
    """params [..., Q, num_gen] -> (w1 [...,Q,m,c_in], b1 [...,Q,m], w2
    [...,Q,m], b2 [...,Q])."""
    weight_nums, bias_nums, total = dynamic_param_sizes(m, use_coords)
    assert params.shape[-1] == total
    c_in = m + 3 if use_coords else m
    w1, w2, b1, b2 = torch.split(params, [weight_nums[0], weight_nums[1], bias_nums[0],
                                          bias_nums[1]], dim=-1)
    lead = params.shape[:-1]
    return w1.reshape(lead + (m, c_in)), b1, w2.reshape(lead + (m,)), b2.reshape(lead)


def geodesic_corrected_coords(rel_coords, geo_qp, max_geo):
    """Push unreached points away: rel_coords [Q,P,3], geo_qp [Q,P] (-1
    unreached), max_geo [Q] per-query maxima over ALL queries (global
    fallback applied, so query chunks see the same fallback) -> unreached
    points' rel shifted by sqrt(max_geo) * sign(rel)."""
    max_geo = torch.sqrt(max_geo.clamp(min=0.0))
    unreached = (geo_qp < 0)[..., None]
    shift = max_geo[:, None, None] * torch.sign(rel_coords)
    return torch.where(unreached, rel_coords + shift, rel_coords)


def mask_heads_forward(geo_dist, mask_features, w1, b1, w2, b2, coords, query_locs,
                       q_chunk: int = 64):
    """Per-scene dynamic conv. geo_dist [P,Q], mask_features [P,m], w1
    [Q,m,c_in], b1 [Q,m], w2 [Q,m], b2 [Q], coords [P,3], query_locs [Q,3]
    -> mask logits [Q,P]."""
    q = w1.shape[0]
    geo_qp = geo_dist.T  # [Q,P]
    # per-query max with the global fallback, over ALL queries
    max_geo = geo_qp.amax(dim=1)
    max_geo = torch.where(max_geo < 0, max_geo.amax(), max_geo)
    parts = []
    for s in range(0, q, q_chunk):
        sl = slice(s, s + q_chunk)
        rel = query_locs[sl, None, :] - coords[None, :, :]  # [Qc,P,3]
        rel = geodesic_corrected_coords(rel, geo_qp[sl], max_geo[sl])
        # first layer split over [rel | mask features]; hidden [Qc,m,P]
        h = (torch.einsum("qpc,qmc->qmp", rel, w1[sl, :, :3])
             + torch.einsum("pf,qmf->qmp", mask_features, w1[sl, :, 3:])
             + b1[sl, :, None])
        h = F.relu(h)
        parts.append(torch.einsum("qmp,qm->qp", h, w2[sl]) + b2[sl, None])
    return torch.cat(parts, dim=0)
