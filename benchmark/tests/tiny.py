"""A throwaway checkout for the harness's CPU tests: BENCHMARK.json and the
files of a cell at a tiny size, made from files alone (the configurations
with their capacities cut and their levels in float32, where the program
and the reference agree to rounding, so that the control's float8 levels
and the planted faults stand out at this size too), beside the real metric
readers."""

from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY = dict(tpu_max_points=1536, tpu_max_voxels=2048, tpu_max_fg_points=768,
            n_downsampling=384, n_decode_point=48, n_query_points=12, tpu_spatial_shape=128,
            tpu_unet_depth=3, tpu_ball_nsample=8, tpu_knn_neighbors=16,
            tpu_train_subsample=256, batch_size=2, tpu_voxel_decay=1.0,
            tpu_compute_dtype="float32")


def _load(path):
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = _load(os.path.join(BENCH, "configs", f"{name}.json"))
    for section in ("eval", "train"):
        if section in cfg:
            cfg[section].update(TINY)
    return cfg


def checkout(tmp: str, cells: list, mix_changes: dict | None = None,
             extra_cells: tuple = ()) -> str:
    """A checkout at ``tmp`` whose BENCHMARK.json holds ``cells`` (of the real
    one, at the tiny size) and ``extra_cells`` (entries whose files the
    caller wrote or names here) -> its root."""
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    keep = [w for w in bench["workloads"] if w["name"] in cells] + list(extra_cells)
    os.makedirs(os.path.join(tmp, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "benchmark", "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(tmp, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    for w in keep:
        dst = os.path.join(tmp, "benchmark", "configs", f"{w['config']}.json")
        if not os.path.exists(dst):
            with open(dst, "w") as f:
                json.dump(tiny_config(w["config"]), f)
        dst = os.path.join(tmp, "benchmark", "traffic", f"{w['traffic']}.json")
        if not os.path.exists(dst):
            mix = _load(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
            mix = copy.deepcopy(mix)
            mix.update(mix_changes or {})
            with open(dst, "w") as f:
                json.dump(mix, f)
    bench["workloads"] = keep
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
