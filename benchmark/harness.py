"""One run of one cell: load the cell from ``BENCHMARK.json`` and the files
it names, set up, measure for ``--seconds``, close the window, judge what
the timed path produced against the plain reference, and print the result
line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the mix's parameters, its ``kind`` and the
limits of its comparisons), ``traffic/<kind>.py`` (the loop the window
drives and its check), ``metrics/<metric>.py`` (``read(run)``: the value,
or None where the run has nothing to read).

The program is the port, ``geoformer_tpu_torch``; nothing here or in
``reference/`` imports JAX or the JAX package, and a run that finds any of
them in ``sys.modules`` prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types

# top-level module names the run may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geoformer_tpu", "bench", "tools",
             "__graft_entry__")
HERE = os.path.dirname(os.path.abspath(__file__))


class Refused(Exception):
    """The run cannot produce a result (exit code 2)."""


class Run:
    """What one run sets up, measures and checks; the metrics' readers take
    their numbers from it."""

    def __init__(self, args, root: str, cell: dict, config: dict, mix: dict, device):
        self.args, self.root, self.cell, self.config, self.mix = args, root, cell, config, mix
        self.seed, self.trace, self.device = args.seed, bool(args.trace), device
        self.attempted = self.failed = 0
        self.failures = []           # (request, reason) of the first failed requests
        self.latencies_s = []        # per request or step, from its call to its host read
        self.scenes = 0              # scenes completed in the window
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.work = None             # {"f32": flops, "bf16": flops} of the window's work
        self.profile = None          # trace.capture's reduction (traced run)
        self.profile_scenes = 0      # scenes in the profiled sub-window
        self.compared = []           # (name, value, limit)
        self.notes = {}              # what a check found beyond its numbers

    def fail(self, request: int, reason: str) -> None:
        self.failed += 1
        if len(self.failures) < 5:
            self.failures.append((request, reason))

    def namespace(self, section: str) -> types.SimpleNamespace:
        """The configuration's section as a plain namespace (the reference's
        view of it)."""
        return types.SimpleNamespace(**self.config[section])


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module_at(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, or, without a list, every cell's
    (end-to-end) or every cell that reports the metric it moves
    (per-layer)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m):
        if "workloads" in m:
            return cell in m["workloads"]
        if kind == "per_layer":
            return reports(e2e[m["moves"]])
        return True

    return [m for m in bench[kind] if reports(m)]


def parse_args(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default=None,
                    help="cpu for the harness's own rehearsal tests; runs use the card")
    return ap.parse_args(argv)


def device_for(args, chips: int):
    import torch

    if args.device is not None:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def device_record(run: Run) -> dict:
    import torch

    if run.device.type != "cuda":
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
               "count": int(run.cell["chips"]), "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace and run.profile is not None:
        rec["busy_s"] = run.profile["busy_s"]
        rec["window_s"] = run.profile["window_s"]
    return rec


def execute(argv, t0: float, root: str):
    """A run of a cell -> (its result line, the Run). Raises Refused."""
    args = parse_args(argv)
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise Refused(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    here = os.path.join(root, "benchmark")
    config = _load_json(os.path.join(here, "configs", f"{cell['config']}.json"))
    mix = _load_json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    device = device_for(args, int(cell["chips"]))

    import torch

    torch.set_num_threads(1)  # the run's host work is one thread (run.py)
    run = Run(args, root, cell, config, mix, device)
    kind = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    kind.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0
    kind.window(run, args.seconds)
    if run.trace:
        kind.traced(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    kind.release(run)
    kind.check(run)

    metrics = {}
    for m in cell_metrics(bench, cell["name"], "per_layer" if run.trace else "end_to_end"):
        reader = _module_at(os.path.join(here, "metrics", f"{m['name']}.py"),
                            f"benchmark_metric_{m['name'].replace('.', '_').replace('-', '_')}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # a gap that is no number (fg packs that differ, NaN) reads as the
    # largest the line can carry, so that the line stays JSON
    run.compared = [(k, v if math.isfinite(v) else 1e300, lim) for k, v, lim in run.compared]
    if run.failures:
        run.compared.append(("failed_requests", float(run.failed), 0))
    correct = run.failed == 0 and all(v <= lim for _, v, lim in run.compared)
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_record(run)}
    if run.trace and run.profile is not None:
        line["breakdown"] = run.profile["breakdown"]
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in run.compared}
    return line, run


def main(argv=None, t0: float | None = None, root: str | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    root = root or os.path.dirname(HERE)
    try:
        line, run = execute(sys.argv[1:] if argv is None else argv, t0, root)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr, flush=True)
        return 3
    for request, reason in run.failures:
        print(f"failed request {request}: {reason}", file=sys.stderr)
    for name, v, lim in run.compared:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
