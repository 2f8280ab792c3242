"""benchmark/work.py against the bring-up table's bounds (PERF.md, the
kernels' table: bytes at 3.35 TB/s, operations at 67 TFLOP/s) and the
sparse-conv pair count against a brute-force count."""

import itertools

import numpy as np
import pytest
import torch

from benchmark import scenes, work

SCENE = {"tpu_max_points": 400, "scale": 50, "ignore_label": -100}


@pytest.mark.parametrize("b, bound_ms", [(1, 0.0137), (8, 0.1100)])
def test_fps_bound_matches_the_table(b, bound_ms):
    # [b, 50000] x 2,048 picks, every point valid: bound by operations
    ops = b * work.fps_ops(50000, 2048)
    got = work.bound_s(ops=ops, bytes_=work.fps_bytes(b, 50000, 2048)) * 1e3
    assert ops / work.PEAK_FLOPS["f32"] > work.fps_bytes(b, 50000, 2048) / work.HBM_BYTES_PER_S
    assert got == pytest.approx(bound_ms, rel=5e-3)


@pytest.mark.parametrize("n, k, bound_ms", [(131072, 16, 0.1089), (131072, 64, 0.1315),
                                            (32768, 16, 0.0272)])
def test_knn_select_bytes_match_the_table(n, k, bound_ms):
    got = work.bound_s(bytes_=work.knn_select_bytes(n, 648, k)) * 1e3
    assert got == pytest.approx(bound_ms, rel=5e-3)


def _brute_pairs(coords, depth):
    c = {tuple(x) for x in coords.tolist()}
    voxels, pairs = [], []
    for _ in range(depth):
        voxels.append(len(c))
        pairs.append(sum((x + dx, y + dy, z + dz) in c for (x, y, z) in c
                         for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3)))
        c = {(x // 2, y // 2, z // 2) for (x, y, z) in c}
    return voxels, pairs


def test_sparse_conv_pairs_match_a_brute_force_count():
    sc = scenes.scans(dict(SCENE, tpu_max_points=600), np.random.default_rng(3), 1)[0]
    coords = torch.as_tensor(sc["coords"])
    assert work.level_counts(coords, 4, 128) == _brute_pairs(sc["coords"], 4)


def test_flops_split_by_the_configuration_operand_type():
    cfg = {"m": 16, "classes": 13, "tpu_unet_depth": 3, "tpu_spatial_shape": 128,
           "input_channel": 3, "use_coords": True, "tpu_compute_dtype": "float32"}
    coords = torch.as_tensor(scenes.scans(SCENE, np.random.default_rng(0), 1)[0]["coords"])
    f32 = work.train_step_work(cfg, [coords])
    bf16 = work.train_step_work(dict(cfg, tpu_compute_dtype="bfloat16"), [coords])
    assert f32["bf16"] == 0 and f32["f32"] > 0
    assert bf16["bf16"] > 0 and bf16["bf16"] + bf16["f32"] == pytest.approx(f32["f32"])
    assert work.train_step_work(cfg, [coords, coords])["f32"] == pytest.approx(2 * f32["f32"])
