"""The harness rehearsed on the CPU at a tiny size: the training kind runs
a 1-second window through benchmark/harness.py (``--device cpu``, which
only these tests pass) and prints the contract's last line with every
metric BENCHMARK.json names for the cell; a cell added from files alone
runs; the control and planted faults come out not correct."""

import contextlib
import io
import json
import os

import pytest

from benchmark import control, faults, harness
from benchmark.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}
CELL = "gf-train-prepare"


def _run(root, cell, trace=0, seed=20240601):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                           "--trace", str(trace), "--device", "cpu"], root=root)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    tail = err.getvalue().strip().splitlines()
    assert tail[-1].startswith("compared "), tail[-3:]
    return line


def _expected(root, cell, trace):
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    return {m["name"]: m["unit"] for m in harness.cell_metrics(
        bench, cell, "per_layer" if trace else "end_to_end")}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_the_contract_line(tmp_path, trace):
    root = tiny.checkout(str(tmp_path), [CELL])
    line = _run(root, CELL, trace)
    assert set(line) - {"breakdown"} == KEYS and list(line)[-1] == "compared"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = _expected(root, CELL, trace)
    # no peak on the CPU: memory is read from the card's allocator
    assert {k: v for k, v in want.items() if k != "peak_mem_gib"} == \
        {k: v["unit"] for k, v in line["metrics"].items()}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0


def test_a_cell_from_files_alone(tmp_path):
    """A new cell: a mix file and an entry in BENCHMARK.json, no code."""
    root = tiny.checkout(str(tmp_path), [CELL])
    traffic = os.path.join(root, "benchmark", "traffic")
    mix = json.load(open(os.path.join(traffic, "train-prepare-b8.json")))
    mix["batches"] = 2
    with open(os.path.join(traffic, "train-prepare-two-batches.json"), "w") as f:
        json.dump(mix, f)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "gf-train-two-batches", "config": "geoformer-scannet",
                               "traffic": "train-prepare-two-batches", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m and CELL in m["workloads"]:
            m["workloads"].append("gf-train-two-batches")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = _run(root, "gf-train-two-batches")
    want = set(_expected(root, "gf-train-two-batches", 0)) - {"peak_mem_gib"}
    assert line["correct"] and set(line["metrics"]) == want


def test_the_control_is_not_correct(tmp_path):
    """float8 operands in place of the configuration's bf16 levels."""
    root = tiny.checkout(str(tmp_path), [CELL])
    with control.in_place_of_program():
        assert _run(root, CELL)["correct"] is False


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_is_not_correct(tmp_path, fault):
    root = tiny.checkout(str(tmp_path), [CELL])
    with faults.FAULTS[fault]():
        assert _run(root, CELL)["correct"] is False
