"""Experiment tracking (the port's copy of geoformer_tpu/utils/tracking.py):
scalar writer, profiler trace, per-phase wall clock and device memory.

The reference logs TB scalars per loss per epoch (train.py:28,87-91,144-145
via tensorboardX) and wall-clock meters. Scalars go to scalars.jsonl always
and to TensorBoard when tensorboardX is importable. ``profile_trace`` is a
torch.profiler capture (host and CUDA activities) written as a Chrome trace,
where the JAX package takes a jax.profiler trace; ``device_memory_stats``
reads torch.cuda's allocator.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


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


@contextlib.contextmanager
def profile_trace(log_dir: str | None, name: str = "trace"):
    """torch.profiler capture of the enclosed work, CPU and CUDA activities
    (CUDA where a card is present), written to ``log_dir/<name>.json`` as a
    Chrome trace (chrome://tracing, Perfetto) when the block ends; nothing
    when ``log_dir`` is None. Each process of a run gives its own ``name``
    (the rank's)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class StepTimer:
    """Per-phase wall-clock accumulator (AverageMeter heritage,
    train.py:33-34) usable as a context manager factory."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def averages(self) -> dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def summary(self) -> str:
        return " ".join(f"{k}={v:.3f}s" for k, v in sorted(self.averages().items()))


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
