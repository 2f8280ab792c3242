"""What the traffic kinds share: the program's engine on the benchmark's
weights, batches on the device, and the capacity counters a request is
judged by."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights

# the capacity counters whose reading above 0 fails a training step of the
# prepare phase: a point that lost its voxel, at any level
BACKBONE_COUNTERS = ("n_overflow_points", "n_oor_points", "n_dropped_voxels_deeper",
                     "n_brick_overflow")
_DTYPES = {"coords": torch.long, "point_mask": torch.bool}


def engine(run, section: str):
    """The program's Engine on the benchmark's seeded weights -> (engine,
    the weights)."""
    from geoformer_tpu_torch.config import load_config
    from geoformer_tpu_torch.engine import Engine

    cfg = load_config(None, **run.config[section])
    sd = weights.state_dict(run.namespace(section), run.seed, run.device,
                            bias=run.config.get("weights", {}).get("bias"))
    return Engine(cfg, device=run.device, state_dict=sd), sd


def rng(run, stream: int) -> np.random.Generator:
    """A numpy generator of the run's seed, one stream a purpose."""
    return np.random.default_rng([int(run.seed) & 0xFFFFFFFFFFFF, stream])


def to_device(batch: dict, device) -> dict:
    """A numpy [B, ...] batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, dtype=_DTYPES.get(k)) for k, v in batch.items()}


def hard_counts(voxel_stats: dict) -> torch.Tensor:
    """[len(BACKBONE_COUNTERS)] int64: each hard counter summed over the batch."""
    return torch.stack([voxel_stats[k].sum().long() for k in BACKBONE_COUNTERS])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
