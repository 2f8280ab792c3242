"""Point-cloud ops of the port (counterpart of geoformer_tpu/ops/__init__.py).

The JAX ops run per scene under ``vmap``; here the batch dimension is
written out, so most ops take ``[B, N, ...]`` tensors. ``gather_rows`` is the
batched row gather that ``vmap(lambda a, i: a[i])`` was. The package exports
the JAX package's op names (see the end of this file).
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


def padded_table(x: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] -> the rows of every scene and one zero row after them,
    [B * N + 1, C]: the table that ``take_rows`` reads."""
    return torch.cat([x.reshape(-1, x.shape[-1]), x.new_zeros(1, x.shape[-1])])


class _TakeRows(torch.autograd.Function):
    """Row gather whose backward is an index_add_ (atomic adds on the card)
    into the table's gradient, with every read of the zero row sent to one of
    SINKS scratch rows instead, then dropped."""

    SINKS = 1024

    @staticmethod
    def forward(ctx, table, flat):
        ctx.save_for_backward(flat)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table.index_select(0, flat.reshape(-1)).reshape(flat.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        flat, = ctx.saved_tensors
        rows, c = ctx.table_shape
        flat = flat.reshape(-1)
        pad = rows - 1
        sink = rows + torch.arange(flat.numel(), device=flat.device) % _TakeRows.SINKS
        acc = torch.zeros(rows + _TakeRows.SINKS, c, device=grad.device,
                          dtype=torch.promote_types(grad.dtype, torch.float32))
        acc.index_add_(0, torch.where(flat == pad, sink, flat), grad.reshape(-1, c).to(acc.dtype))
        acc[pad] = 0.0
        return acc[:rows].to(ctx.table_dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of a ``padded_table`` of N = ``n`` rows a scene: idx [B, *S] in
    [0, n], where n is the zero row (a pad slot) -> [B, *S, C].

    The port's one gather through pad slots: the sparse convs' rulebooks
    (on the card the submanifold conv's kernels read its map themselves) and
    ``devoxelize`` read through it. Its backward adds each read's
    gradient into its row (in float32, or float64 for a float64 table) and
    none into the zero row: the pad slot is read by most of a sparse conv's
    27 offsets and by every invalid point of a scene smaller than the
    capacity, and both advanced indexing's and F.embedding's backward sum
    such a heavily repeated row a segment at a time on one thread."""
    b = idx.shape[0]
    offsets = (torch.arange(b, device=idx.device) * n).view((b,) + (1,) * (idx.ndim - 1))
    pad = table.shape[0] - 1
    return _TakeRows.apply(table, torch.where(idx >= n, pad, idx + offsets))


# the names geoformer_tpu/ops/__init__.py exports, after the helpers above,
# which these modules import. Three of them are also this package's module
# names (voxelize, ball_query, knn): there the package attribute stays the
# module, which the port's code and tests import through it, and the function
# is ops.voxelize.voxelize, ops.ball_query.ball_query and ops.knn.knn.
from geoformer_tpu_torch.ops.voxelize import voxel_mean_pool, devoxelize  # noqa: E402
from geoformer_tpu_torch.ops.fps import furthest_point_sample  # noqa: E402
from geoformer_tpu_torch.ops.ball_query import query_and_group  # noqa: E402
from geoformer_tpu_torch.ops.geodesic import geodesic_distance  # noqa: E402
from geoformer_tpu_torch.ops.segment_ops import (  # noqa: E402
    get_iou, roipool, sec_max, sec_mean, sec_min)
from geoformer_tpu_torch.ops.cluster import (  # noqa: E402
    ballquery_dense, bfs_cluster, connected_components)
from geoformer_tpu_torch.ops.interpolate import (  # noqa: E402
    gather_points, group_points, three_interpolate, three_interpolate_weights, three_nn)

__all__ = [
    "gather_rows", "pad_row", "padded_table", "take_rows",
    "voxel_mean_pool", "devoxelize", "furthest_point_sample", "query_and_group",
    "geodesic_distance", "sec_mean", "sec_min", "sec_max", "roipool", "get_iou",
    "ballquery_dense", "bfs_cluster", "connected_components", "three_nn",
    "three_interpolate", "three_interpolate_weights", "gather_points", "group_points",
]
