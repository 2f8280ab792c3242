"""The ``data`` and ``model`` mesh axes as process-per-GPU
``torch.distributed`` (counterpart of geoformer_tpu/parallel/mesh.py).

The JAX package shards the batch over a ``data`` mesh axis and, with
``make_mesh(model_parallel=M)``, the decoder queries over a second
``model`` axis, and lets XLA insert every collective. Here each rank holds
its own rows of the batch and, on the model axis, its own queries, and the
same reductions are written out by hand.

The layout is JAX's ``np.asarray(devs).reshape(-1, M)``: rank r is data
index ``r // M`` and model index ``r % M``, and the M ranks of one model
group hold the same scenes. Every rank creates one process group per axis
(``dist.axis_groups``).

Data axis (scenes):

* ``shard_batch`` keeps this data index's rows [B/N, ...] of a global
  [B, ...] batch (N must divide B, as ``shard_batch`` there needs);
* ``all_reduce_sum`` is a sum over an axis whose backward sums the
  cotangent over it (a batch norm's statistics, models/blocks.py);
* the criterion's scene-spanning normalisers are summed with no gradient
  (losses/), the trainable gradients once a step over every rank
  (parallel/train_state.py);
* ``gather_objects`` brings host-side eval results to rank 0, one a data
  index.

Model axis (queries), the counterpart of ``maybe_shard`` and of
``_shard_solve`` at geoformer_tpu/models/geoformer.py:209: a model rank
solves the geodesic table's columns of its own queries ``query_slice``,
and runs the rel-pos embedding, the decoder's cross-attention and FFN and
the mask head on them. Only small tensors cross the model group:
``all_gather_queries`` (the decoder's [B, Q, d] self-attention inputs, the
[B, Q, I] cost matrix; differentiable, its backward a reduce-scatter) and
``all_reduce_max`` (the fallback maxima; no gradient). When M does not
divide Q every model rank runs all queries (as ``_shard_solve`` falls back
to the replicated solve), and the criterion counts them on model index 0.
``replica_weight`` is 1 on model index 0 and 0 on the others: a term that
every model rank computes alike (the semantic CE) counts once.

The mesh is ambient while a step runs (``set_mesh``, as
``jax.sharding.set_mesh`` makes it there): the modules read ``current_mesh``
and issue collectives whenever it has a process group, a world of 1 under
torchrun included (there they return their input's values). A process with
no group issues none and runs as it always did. Every rank issues the same
collectives in the same order whatever its data: a rank whose scenes have
no instance or no foreground still joins each of them.

``TRAFFIC`` counts the bytes of every collective by call site, as the
kernels count their launches: the tests and chip_smoke.py hold the largest
activation a model-parallel step moves below one scene's [F, Q] table.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from geoformer_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh: its rank of ``world``, its device,
    the process group of every rank (None without one) and, with
    ``model_parallel`` M > 1, the groups of its data and model axes."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def data_world(self) -> int:
        return self.world // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    @property
    def model_world(self) -> int:
        return self.model_parallel

    def axis_group(self, axis: str):
        """The process group of ``axis`` ("data", "model" or "all"); None
        where the axis needs no collective."""
        if self.group is None:
            return None
        if axis == "all":
            return self.group
        if self.model_parallel == 1:
            return self.group if axis == "data" else None
        return self.data_group if axis == "data" else self.model_group

    def model_view(self) -> "Mesh":
        """This rank's model group alone, as a mesh with a data axis of 1:
        the few-shot decode of one rank's own scene (the JAX driver decodes
        it outside any data mesh)."""
        return Mesh(self.model_rank, self.model_parallel, self.device, self.model_group,
                    self.model_parallel, None, self.model_group)


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The ("data",) mesh of the initialised process group, one device a
    rank (a world of 1 without a group), or with ``model_parallel`` M > 1
    the ("data", "model") mesh: raises ValueError when M does not divide
    the world (the JAX assert at geoformer_tpu/parallel/mesh.py:29)."""
    from geoformer_tpu_torch import default_device

    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"a world of {world} cannot be split into model groups of "
                         f"{model_parallel}")
    group = data_group = model_group = None
    if dist.is_initialized():
        import torch.distributed as tdist

        group = tdist.group.WORLD
        if model_parallel > 1:
            data_group, model_group = dist.axis_groups(model_parallel)
    return Mesh(dist.get_rank(), world, default_device(device), group, model_parallel,
                data_group, model_group)


_ACTIVE: Mesh | None = None
_QUERY_ROWS = False  # inside ``on_query_rows``


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
    """-> (global batch, this rank's first row) for ``b_local`` rows a data
    index of the ambient mesh."""
    mesh = current_mesh()
    if mesh is None:
        return b_local, 0
    return b_local * mesh.data_world, b_local * mesh.data_rank


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This data index's rows [B/N, ...] of a global [B, ...] batch (numpy
    arrays or tensors); raises when N does not divide B."""
    if mesh is None or mesh.data_world == 1:
        return batch
    b = len(next(iter(batch.values())))
    n = mesh.data_world
    if b % n:
        raise ValueError(f"a batch of {b} cannot be split over {n} ranks")
    per = b // n
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    return {k: v[rows] for k, v in batch.items()}


# ---------------- the model axis ----------------


def queries_sharded(q: int, mesh: Mesh | None = None) -> bool:
    """Whether the ambient mesh splits ``q`` queries over its model axis (M
    > 1 dividing q); else every model rank runs all of them."""
    mesh = mesh or current_mesh()
    return mesh is not None and mesh.model_parallel > 1 and q % mesh.model_parallel == 0


def query_slice(q: int, mesh: Mesh | None = None) -> slice:
    """This rank's queries of ``q``: its 1/M of them on a model axis that
    divides q, all of them otherwise."""
    mesh = mesh or current_mesh()
    if not queries_sharded(q, mesh):
        return slice(0, q)
    per = q // mesh.model_parallel
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def replica_weight(mesh: Mesh | None = None) -> float:
    """1 on model index 0 (and without a model axis), 0 on the other model
    ranks: the weight of a loss term that every rank of a model group
    computes alike, so that the ranks' sum counts it once."""
    mesh = mesh or current_mesh()
    return 1.0 if mesh is None or mesh.model_rank == 0 else 0.0


@contextlib.contextmanager
def on_query_rows(q: int):
    """Inside the block the modules run on this rank's rows of ``q``
    queries: where the model axis splits them, a batch norm's statistics
    span the model axis as well (``stats_axis``)."""
    global _QUERY_ROWS
    prev, _QUERY_ROWS = _QUERY_ROWS, queries_sharded(q)
    try:
        yield
    finally:
        _QUERY_ROWS = prev


def stats_axis() -> str:
    """The axis a batch norm's statistics reduce over: "all" on query rows
    split over the model axis, else "data" (the rows of a model group are
    the same on each of its ranks)."""
    return "all" if _QUERY_ROWS else "data"


# ---------------- collectives ----------------


class Traffic:
    """Bytes moved by the collectives, by call site: ``bytes`` (the sum)
    and ``largest`` (the largest single tensor)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes, self.largest = {}, {}

    def add(self, site: str, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.bytes[site] = self.bytes.get(site, 0) + n
        self.largest[site] = max(self.largest.get(site, 0), n)


TRAFFIC = Traffic()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its backward sums the cotangent over the group
    (each rank's cotangent is the gradient of its own part of the global
    loss, so the sum is the gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, group, site):
        import torch.distributed as tdist

        ctx.group, ctx.site = group, site
        out = x.detach().clone(memory_format=torch.contiguous_format)
        TRAFFIC.add(site, out)
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as tdist

        grad = grad.clone(memory_format=torch.contiguous_format)
        TRAFFIC.add(ctx.site + ".backward", grad)
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None = None, axis: str = "data",
                   site: str = "sum") -> torch.Tensor:
    """Sum of ``x`` over ``axis`` of ``mesh`` (the ambient one by default),
    differentiable; ``x`` itself where the axis has no group."""
    mesh = mesh or current_mesh()
    group = None if mesh is None else mesh.axis_group(axis)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, site)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, axis: str, site: str = "max") -> torch.Tensor:
    """Elementwise max of ``x`` over ``axis`` of the ambient mesh, with no
    gradient; ``x`` itself where the axis has no group."""
    mesh = current_mesh()
    group = None if mesh is None else mesh.axis_group(axis)
    if group is None:
        return x
    import torch.distributed as tdist

    out = x.detach().clone(memory_format=torch.contiguous_format)
    TRAFFIC.add(site, out)
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=group)
    return out


class _AllGatherQueries(torch.autograd.Function):
    """The model group's query rows concatenated along ``dim``, in model
    index order; the backward is a reduce-scatter: the cotangent summed
    over the group, this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, mesh, site):
        import torch.distributed as tdist

        ctx.dim, ctx.mesh, ctx.site, ctx.n = dim, mesh, site, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.model_parallel)]
        tdist.all_gather(parts, x, group=mesh.model_group)
        out = torch.cat(parts, dim=dim)
        TRAFFIC.add(site, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as tdist

        grad = grad.clone(memory_format=torch.contiguous_format)
        TRAFFIC.add(ctx.site + ".backward", grad)
        tdist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad.narrow(ctx.dim, ctx.mesh.model_rank * ctx.n, ctx.n), None, None, None


def all_gather_queries(x: torch.Tensor, q: int, dim: int = 1, site: str = "gather") -> torch.Tensor:
    """This rank's rows of ``q`` queries along ``dim`` -> all ``q`` of them
    (differentiable); ``x`` itself when the queries are not split."""
    mesh = current_mesh()
    if not queries_sharded(q, mesh):
        return x
    if mesh.model_group is None:
        raise ValueError("the queries are split over a model axis with no process group")
    return _AllGatherQueries.apply(x, dim, mesh, site)


def gather_objects(obj, mesh: Mesh | None = None, dst: int = 0):
    """Every data index's ``obj`` (picklable host data; every rank passes
    one, the model ranks of a group the same) -> the list by data index on
    rank ``dst``, None on the others; [obj] without a process group."""
    if mesh is None or mesh.group is None:
        return [obj]
    import torch.distributed as tdist

    out = [None] * mesh.world if mesh.rank == dst else None
    tdist.gather_object(obj, out, dst=dst, group=mesh.group)
    return None if out is None else out[::mesh.model_parallel]
