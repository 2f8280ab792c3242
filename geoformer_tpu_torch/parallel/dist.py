"""Process rank helpers (counterpart of geoformer_tpu/parallel/dist.py).

One process per GPU, launched by ``torchrun`` (or anything that sets the
same environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). ``init_distributed`` forms the process group from that
environment and does nothing without it: a single process is rank 0 of 1
and runs as it always did. The data pipeline's per-process seeds and index
shards follow the JAX module exactly.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a collective may wait for a peer before the group raises
_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: str | None = None, device=None) -> bool:
    """Form the process group that ``torchrun``'s environment describes
    -> True when this call formed it (its caller then ``destroy``s it); a
    no-op (False) when the environment names none or a group exists.

    ``backend``: ``nccl`` by default on the card, ``gloo`` when ``device``
    is the CPU or no card is present. ``gloo`` is allowed on the card too:
    NCCL refuses two ranks on one GPU, gloo does not (ranks beyond the
    number of cards then share them, see ``cuda_index``). A group that does
    not form raises; there is no quiet world of 1."""
    import torch
    import torch.distributed as dist

    if not all(k in os.environ for k in _ENV):
        missing = [k for k in _ENV if k not in os.environ]
        if len(missing) < len(_ENV):
            raise RuntimeError(f"partial torchrun environment: {missing} unset")
        return False
    if dist.is_initialized():
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu or not torch.cuda.is_available() else "nccl"
    if backend == "nccl":
        if on_cpu:
            raise ValueError("the nccl backend needs the card; use gloo on the CPU")
        torch.cuda.set_device(cuda_index(backend))
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=_TIMEOUT)
    return True


@contextlib.contextmanager
def process_group(backend: str | None = None, device=None):
    """``init_distributed`` for the block, and the group it formed
    destroyed after it."""
    formed = init_distributed(backend, device)
    try:
        yield
    finally:
        if formed:
            destroy()


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def backend() -> str | None:
    import torch.distributed as dist

    return dist.get_backend() if is_initialized() else None


def cuda_index(backend_name: str | None = None) -> int:
    """The card of this rank: ``LOCAL_RANK``. With more ranks on a host than
    cards, gloo ranks share the cards round-robin (two ranks on one card is
    how one card checks a world of 2); NCCL cannot, and raises."""
    import torch

    n = torch.cuda.device_count()
    lr = local_rank()
    if lr < n:
        return lr
    if (backend_name or backend()) == "gloo":
        return lr % n
    raise RuntimeError(f"LOCAL_RANK {lr} but only {n} CUDA devices; NCCL needs one card a rank "
                       "(--dist_backend gloo lets ranks share a card)")


def axis_groups(model_parallel: int):
    """-> (this rank's data group, its model group) of the ("data",
    "model") layout with model groups of ``model_parallel`` consecutive
    ranks (JAX's ``reshape(-1, model_parallel)``): the data group holds the
    ranks of this model index, the model group those of this data index.
    Every rank creates every group, in the same order."""
    import torch.distributed as dist

    world, rank = get_world_size(), get_rank()
    m = model_parallel
    data_group = model_group = None
    for j in range(m):
        g = dist.new_group(list(range(j, world, m)))
        if rank % m == j:
            data_group = g
    for i in range(world // m):
        g = dist.new_group(list(range(i * m, (i + 1) * m)))
        if rank // m == i:
            model_group = g
    return data_group, model_group


def barrier() -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.barrier()


def destroy() -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """rank-0 gate for logging and checkpoints."""
    return get_rank() == 0


def local_seed(base_seed: int) -> int:
    """Per-process seed offset (train.py:169-171 seeds rank-offset RNGs)."""
    return base_seed + get_rank()


def shard_indices(n_items: int, batch_size: int, seed: int):
    """Deterministic per-process index shard, DistributedSampler semantics:
    the same shuffled order everywhere, each process takes a strided slice
    padded to equal length."""
    g = np.random.default_rng(seed)
    order = g.permutation(n_items)
    world, rank = get_world_size(), get_rank()
    per = -(-n_items // world)
    padded = np.concatenate([order, order[: per * world - n_items]])
    return padded[rank::world]
