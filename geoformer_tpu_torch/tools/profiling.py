"""Device timers for the port's kernels on the card, shared by
``chip_smoke.py`` and the per-kernel timing tools (``k1_sources``,
``k3_sources``).

``time_ms`` is the mean over a loop of calls between two CUDA events, for
work that keeps the device busy longer than the host takes to launch it;
``device_ms`` reads torch.profiler's device time of each launch, for
kernels of a few microseconds, optionally with the L2 flushed before every
call (``l2_flush``); ``compare`` times several functions in turns with it.
``card`` names the device a measurement ran on, with the card's power
limit, for the throughput tools' result lines.
"""

from __future__ import annotations

import subprocess

import torch


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events), after one
    call to warm up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int, flush=None, only=None, flush_by: str = "write") -> float:
    """Device time of one fn() from torch.profiler: for each CUDA kernel or
    copy that fn enqueues (or those whose name holds ``only``), the median
    of its launches' durations times its launches a call (its count over
    ``reps``, rounded), summed over the kernels. The median and the
    rounding, because a capture may record a launch with a wrong duration
    (means off by 2x) or miss some (K2's cluster launch: 9 of 10 in every
    capture; late in a long run, 46 of 50 of K3's and of the flush's). For
    kernels of a few microseconds, where a loop between two
    CUDA events runs at the host's launch pace and not at the device's.
    With ``flush`` (a buffer several times the L2's size) every call finds
    the L2 cold: the buffer is filled (``flush_by`` "write", which leaves
    the L2 full of dirty lines that fn's traffic then writes back) or
    summed ("read": clean lines) before it, and the flush kernels are left
    out."""
    from statistics import median

    from torch.profiler import ProfilerActivity, profile

    skip = None if flush is None else "FillFunctor" if flush_by == "write" else "reduce_kernel"
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.fill_(0.0) if flush_by == "write" else flush.sum()
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        durations, flushes = {}, 0
        for e in prof.events():
            if e.device_type != cuda:
                continue
            if skip is not None and skip in e.name:
                flushes += 1
            elif only is None or only in e.name:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if durations and (flush is None or flushes):
            return sum(median(d) * max(1, round(len(d) / reps))
                       for d in durations.values()) / 1e3
    raise RuntimeError(f"torch.profiler recorded no {only or 'device'} launch or no flush in "
                       f"five captures ({ {k: len(d) for k, d in durations.items()} }, "
                       f"{flushes} flushes)")


def l2_flush(device) -> torch.Tensor:
    """A 256 MB buffer: filling it before a call evicts the 50 MB L2."""
    return torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)


def compare(fns: dict, order: list, reps: int = 50) -> dict:
    """{label: {"ms": [...], "l2_clean": [...], "l2_warm": [...]}}: each
    fn's device time with the L2 flushed by a write and by a read (clean
    lines) and warm, one reading of each a turn, in ``order``."""
    flush = l2_flush("cuda")
    res = {label: {"ms": [], "l2_clean": [], "l2_warm": []} for label in fns}
    for label in order:
        res[label]["ms"].append(device_ms(fns[label], reps, flush=flush))
        res[label]["l2_clean"].append(device_ms(fns[label], reps, flush=flush, flush_by="read"))
        res[label]["l2_warm"].append(device_ms(fns[label], reps))
    return res


def card(device) -> dict:
    """{"device": the card's name, "power_limit_w": its power limit in W}:
    ``torch.cuda.get_device_name`` and the limit from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` (None where
    nvidia-smi cannot say); {"device": "cpu", "power_limit_w": None} for a
    CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device), "power_limit_w": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if out.returncode == 0:  # "NVIDIA H100 80GB HBM3, 700.00 W"
            limit = float(out.stdout.strip().rsplit(",", 1)[-1].split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": limit}
