"""Experiment tracking: scalar writer and device memory (the port's copy of
geoformer_tpu/utils/tracking.py's ScalarWriter, and device_memory_stats
reading torch.cuda's allocator).

The reference logs TB scalars per loss per epoch (train.py:28,87-91,144-145
via tensorboardX) and wall-clock meters. Scalars go to scalars.jsonl always
and to TensorBoard when tensorboardX is importable.
"""

from __future__ import annotations

import json
import os


class ScalarWriter:
    """Writes scalars to scalars.jsonl (always) and TensorBoard (if present)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def device_memory_stats(device=None) -> dict:
    """Live and peak memory of the CUDA device (torch.cuda's allocator
    counters); {} for the CPU."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device or 0).total_memory,
    }
