"""Process rank helpers (counterpart of geoformer_tpu/parallel/dist.py).

A single process is rank 0 of 1; with ``torch.distributed`` initialised the
rank and world size are its own. The data pipeline's per-process seeds and
index shards follow the JAX module exactly.
"""

from __future__ import annotations

import numpy as np


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
