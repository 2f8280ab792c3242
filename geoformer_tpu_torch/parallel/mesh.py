"""The data mesh axis as process-per-GPU ``torch.distributed`` (counterpart
of geoformer_tpu/parallel/mesh.py).

The JAX package shards the batch over a ``data`` mesh axis and lets XLA
insert every collective: under SPMD each batch norm's statistics, each loss
normaliser that spans scenes and the parameter gradient are reductions over
the GLOBAL batch. Here each rank holds its own rows of that batch, and the
same reductions are written out by hand:

* ``shard_batch`` keeps this rank's rows [B/N, ...] of a global [B, ...]
  batch (N must divide B, as ``shard_batch`` there needs);
* ``all_reduce_sum`` is a sum over the ranks whose backward sums the
  cotangent over the ranks (a batch norm's statistics, models/blocks.py);
* the criterion's scene-spanning normalisers are summed with no gradient
  (losses/), the trainable gradients once a step (parallel/train_state.py);
* ``gather_objects`` brings host-side eval results to rank 0.

The mesh is ambient while a training step runs (``set_mesh``, as
``jax.sharding.set_mesh`` makes it there): the modules read ``current_mesh``
and issue collectives whenever it has a process group, a world of 1 under
torchrun included (there they return their input's values). A process with
no group issues none and runs as it always did. Every rank issues the same
collectives in the same order whatever its data: a rank whose scenes have
no instance or no foreground still joins each of them.

Query-axis model parallelism (``make_mesh(model_parallel>1)``,
``maybe_shard``, the ``model`` axis of the geodesic solve) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from geoformer_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis: its rank of ``world``, its
    device and the process group (None without one)."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The ("data",) mesh of the initialised process group, one device a
    rank (a world of 1 without a group)."""
    if model_parallel > 1:
        raise NotImplementedError("query-axis model parallelism (the JAX package's 'model' "
                                  "mesh axis) is not ported; only the data axis is")
    from geoformer_tpu_torch import default_device

    group = None
    if dist.is_initialized():
        import torch.distributed as tdist

        group = tdist.group.WORLD
    return Mesh(dist.get_rank(), dist.get_world_size(), default_device(device), group)


_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None):
    """Make ``mesh`` the ambient one (for its collectives) inside the block.
    Not thread-local: autograd's device threads run a rematerialized block's
    forward again in the backward, and must see it too."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current_mesh() -> Mesh | None:
    """The ambient mesh (None outside ``set_mesh``)."""
    return _ACTIVE


def data_rows(b_local: int):
    """-> (global batch, this rank's first row) for ``b_local`` rows a rank
    of the ambient mesh."""
    mesh = current_mesh()
    if mesh is None:
        return b_local, 0
    return b_local * mesh.world, b_local * mesh.rank


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's rows [B/N, ...] of a global [B, ...] batch (numpy arrays
    or tensors); raises when N does not divide B."""
    if mesh is None or mesh.world == 1:
        return batch
    b = len(next(iter(batch.values())))
    if b % mesh.world:
        raise ValueError(f"a batch of {b} cannot be split over {mesh.world} ranks")
    per = b // mesh.world
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return {k: v[rows] for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the cotangent over the ranks
    (each rank's cotangent is the gradient of its own part of the global
    loss, so the sum is the gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as tdist

        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as tdist

        grad = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``mesh`` (the ambient one by default),
    differentiable; ``x`` itself without a process group."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def gather_objects(obj, mesh: Mesh | None = None, dst: int = 0):
    """Every rank's ``obj`` (picklable host data) -> the list by rank on
    rank ``dst``, None on the others; [obj] without a process group."""
    if mesh is None or mesh.group is None:
        return [obj]
    import torch.distributed as tdist

    out = [None] * mesh.world if mesh.rank == dst else None
    tdist.gather_object(obj, out, dst=dst, group=mesh.group)
    return out
