"""Readings that the limits of a cell's comparisons are set from: the gaps
of sound runs of the program, of the control (``control.py``) and of a
planted fault (``faults.py``) over many seeds, in one process, through the
harness's own set-up, window and check (limits are not applied here).

    python3 benchmark/calibrate.py --workload CELL --seconds S \\
        [--seeds 1,2,...] [--control-seeds 7,8,9] [--fault NAME --fault-seeds 4,5,6]

One JSON line a run on stdout: side, seed, attempted, failed, the gaps
compared and the run's end-to-end metrics."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from benchmark import control, faults, harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    plan = [("program", s, contextlib.nullcontext) for s in args.seeds]
    plan += [("control", s, control.in_place_of_program) for s in args.control_seeds]
    plan += [(args.fault, s, faults.FAULTS.get(args.fault)) for s in args.fault_seeds]
    for side, seed, ctx in plan:
        argv = ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)]
        if args.device:
            argv += ["--device", args.device]
        t0 = time.perf_counter()
        with ctx():
            line, run = harness.execute(argv, t0, ROOT)
        print(json.dumps({"side": side, "seed": seed, "attempted": line["attempted"],
                          "failed": line["failed"], "failures": run.failures,
                          "compared": {k: v["value"] for k, v in line["compared"].items()},
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "notes": run.notes,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run, line
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
