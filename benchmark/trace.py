"""Short torch.profiler captures on the card, reduced to what the per-layer
metrics read: the union of device activity (``busy_s``) over the traced
window (``window_s``), kernel launches, and the ``breakdown``: the device operations that took most
time and the longest device-idle gaps, each named by the innermost host
operation running across its middle."""

from __future__ import annotations

import time

import torch

_NOT_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")


def _events(prof, on_cpu: bool):
    """-> (device [(start_ns, end_ns, name)], host [(start_ns, end_ns, name)]).
    ``on_cpu`` (the harness's CPU rehearsal only): aten operations stand in
    for the device's."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        on_device = e.device_type() == cuda or (on_cpu and e.name().startswith("aten::"))
        (device if on_device else host).append((start, start + dur, e.name()))
    return device, host


def _union(intervals):
    merged = []
    for s, e in sorted((s, e) for s, e, _ in intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(host, t):
    inner = None
    for s, e, name in host:
        if s <= t <= e and (inner is None or s >= inner[0]):
            inner = (s, e, name)
    return inner[2] if inner else "host idle"


def _profile(fn, device, with_host: bool):
    from torch.profiler import ProfilerActivity, profile

    on_cpu = device.type != "cuda"
    activities = ([ProfilerActivity.CPU] if with_host or on_cpu else []) + (
        [] if on_cpu else [ProfilerActivity.CUDA])
    if not on_cpu:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter_ns()
        fn()
        if not on_cpu:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
    device_ev, host = _events(prof, on_cpu)
    if not device_ev:
        raise RuntimeError("torch.profiler recorded no device operation")
    return device_ev, host, t1 - t0


def capture(fn, labelled, device, top: int = 10) -> dict:
    """``fn()`` under the profiler recording the device alone (the host's
    own recording would slow the host-paced program it measures), and
    ``labelled()`` (a shorter piece of the same work) recording the host
    too, whose longest device-idle gaps are named by what the host ran ->
    {"busy_s", "window_s", "launches", "breakdown"}."""
    dev, _, wall_ns = _profile(fn, device, with_host=False)
    first = min(s for s, _, _ in dev)
    window_ns = max(max(e for _, e, _ in dev) - first, wall_ns)
    merged = _union(dev)
    busy_ns = sum(e - s for s, e in merged)
    totals, launches = {}, 0
    for s, e, name in dev:
        totals[name] = totals.get(name, 0) + (e - s)
        launches += not name.startswith(_NOT_KERNEL)
    dev2, host, _ = _profile(labelled, device, with_host=True)
    merged2 = _union(dev2)
    gaps = sorted(((merged2[i + 1][0] - merged2[i][1], (merged2[i + 1][0] + merged2[i][1]) / 2)
                   for i in range(len(merged2) - 1)), reverse=True)[:top]
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_ns / 1e9,
        "launches": launches,
        "breakdown": {
            "device_ops": [[name, ns / 1e9] for name, ns in ops],
            "idle_gaps": [[_host_at(host, mid), ns / 1e9] for ns, mid in gaps],
        },
    }
