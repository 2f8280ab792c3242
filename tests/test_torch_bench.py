"""The port's throughput entry points on the CPU at tests/conftest.py:tiny_cfg:
cli.bench (bench.py's scene_inference line) and tools.train_bench
(tools/train_bench.py's step line). No JAX program runs here: bench.py's
SCALES are read from its source with ``ast``, so nothing of it executes.
Their reduction of a forward's outputs is held against bench.py's on JAX's
outputs in tests/test_torch_slice.py (``test_bench_reduction``), and
tests/test_torch_isolation.py imports both with no JAX.
"""

import ast
import json
import math
import os

import pytest
import torch

from geoformer_tpu_torch.cli import bench
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.tools import train_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--points", "512", "--voxels", "512", "--fg", "256", "--subsample", "128",
              "--depth", "3", "--contexts", "32", "--queries", "8", "--spatial", "64"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "vs_derived_bound",
              "p50_latency_s", "batch_size", "first_call_s", "kernel_build_s", "scale",
              "points", "dropped_points", "degradation_counters", "fg_points", "device",
              "power_limit_w"}


@pytest.fixture
def one_thread():
    """Torch on one thread for the tool runs: at tiny shapes a step is many
    small ops, and the default thread count only spins against the other
    test workers (a tiny step ran ~14x slower under the six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bench_py_constants() -> dict:
    """SCALES, REFERENCE_SCENES_PER_SEC and DERIVED_REFERENCE_RATE of
    bench.py, from its syntax tree (each scale a ``dict(...)`` of
    constants)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    got = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "SCALES":
                got[name] = {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                                   for kw in v.keywords}
                             for k, v in zip(node.value.keys, node.value.values)}
            elif name in ("REFERENCE_SCENES_PER_SEC", "DERIVED_REFERENCE_RATE"):
                got[name] = ast.literal_eval(node.value)
    return got


def test_scales_equal_bench_py():
    want = _bench_py_constants()
    assert bench.SCALES == want["SCALES"]
    assert bench.REFERENCE_SCENES_PER_SEC == want["REFERENCE_SCENES_PER_SEC"]
    assert bench.DERIVED_REFERENCE_RATE == want["DERIVED_REFERENCE_RATE"]
    # every scale key is a key of the port's config
    defaults = load_config().to_dict()
    assert all(k in defaults for scale in bench.SCALES.values() for k in scale)


def test_measure_prints_one_result_line(tiny_cfg, capsys, one_thread):
    """measure on the CPU prints exactly one stdout line, with bench.py's
    keys (compile_s and the cache count replaced by first_call_s and
    kernel_build_s) plus fg_points, device and power_limit_w; value is B /
    p50; dropped_points sums the four hard counters; the launch counts of
    the 9 forwards go to stderr."""
    cfg = load_config(None, **{k: v for k, v in tiny_cfg.to_dict().items() if k != "config"})
    got = bench.measure(cfg, cfg.batch_size, "cpu", scale="tiny")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == got and set(line) == BENCH_KEYS
    assert line["metric"] == "scene_inference" and line["device"] == "cpu"
    assert line["value"] == cfg.batch_size / line["p50_latency_s"] > 0
    counters = line["degradation_counters"]
    assert list(counters) == list(bench.COUNTERS)
    assert line["dropped_points"] == sum(v for k, v in counters.items()
                                         if k != "n_radius_window_overflow")
    assert line["fg_points"] > 0 and line["points"] == cfg.tpu_max_points
    assert line["kernel_build_s"] is None and line["power_limit_w"] is None
    launches = json.loads(err.strip().splitlines()[-1])
    assert launches["forwards"] == 9 and set(launches["launches"]) == {
        "knn_select", "fps", "row_gather"}


def test_train_bench_prints_a_finite_p50_step(capsys, one_thread):
    got = train_bench.main(["--device", "cpu", "--steps", "1", *TINY_FLAGS])
    out, _ = capsys.readouterr()
    lines = out.strip().splitlines()
    assert any(s.startswith("p50 step: ") for s in lines)
    line = json.loads(lines[-1])
    assert line == got and line["metric"] == "train_step" and line["phase"] == "full"
    assert math.isfinite(line["p50_step_s"]) and line["p50_step_s"] > 0
    assert math.isfinite(line["loss"])
    assert line["scenes_per_sec"] == 1 / line["p50_step_s"]


def test_train_bench_takes_no_brick_flags():
    """The port has no dense bricks: the JAX tool's brick flags are refused."""
    for flag in ("--brick_occupancy", "--brick_fold"):
        with pytest.raises(SystemExit):
            train_bench.parse_args([flag, "64"])


@pytest.mark.parametrize("argv", [["cli.bench", "--scale", "prod"],
                                  ["tools.train_bench", "--mesh", "2"]])
def test_entry_points_raise_without_a_card(argv):
    """No --device and no CUDA: the bench and train_bench (its --mesh
    launcher too) raise before any work or rank; no CPU fallback."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run on it")
    main = importlib.import_module(f"geoformer_tpu_torch.{argv[0]}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv[1:])
