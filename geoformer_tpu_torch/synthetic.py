"""Synthetic ScanNet-like scenes (the port's copy of the room generator in
__graft_entry__.py: _room_points, _synthetic_batch).

Surface scans at ~2 cm spacing: floor, three walls and furniture boxes with
sensor noise, so the geodesic graph is dense and the voxels are
surface-occupied like a real scan. Arrays are numpy, made from a seed.
"""

from __future__ import annotations

import numpy as np


def room_points(rng: np.random.Generator, n_points: int) -> np.ndarray:
    area = n_points * 0.02 * 0.02
    side = max(np.sqrt(area / 4.0), 1.0)
    rects = [((0, 0, 0), (side, 0, 0), (0, side, 0))]
    h = side * 0.6
    rects += [
        ((0, 0, 0), (side, 0, 0), (0, 0, h)),
        ((0, 0, 0), (0, side, 0), (0, 0, h)),
        ((0, side, 0), (side, 0, 0), (0, 0, h)),
    ]
    for _ in range(8):  # furniture boxes: top + 2 faces each
        cx, cy = rng.uniform(0.15 * side, 0.75 * side, 2)
        w, d, bh = rng.uniform(0.05 * side, 0.25 * side, 3)
        rects.append(((cx, cy, bh), (w, 0, 0), (0, d, 0)))
        rects.append(((cx, cy, 0), (w, 0, 0), (0, 0, bh)))
        rects.append(((cx, cy, 0), (0, d, 0), (0, 0, bh)))
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects])
    counts = (areas / areas.sum() * n_points).astype(int)
    counts[0] += n_points - counts.sum()
    pts = []
    for (o, u, v), c in zip(rects, counts):
        a = rng.uniform(0, 1, (c, 1))
        b = rng.uniform(0, 1, (c, 1))
        p = np.asarray(o) + a * np.asarray(u) + b * np.asarray(v)
        p += rng.normal(0, 0.003, p.shape)  # sensor noise
        pts.append(p)
    out = np.concatenate(pts).astype(np.float32)
    return out - out.min(0) + 0.05


def synthetic_batch(cfg, batch_size: int, seed: int = 0) -> dict:
    """A [B, P] batch of room scans at the config's capacities (numpy)."""
    rng = np.random.default_rng(seed)
    p = cfg.tpu_max_points
    limit = (cfg.tpu_spatial_shape - 1) / cfg.scale - 0.05
    pts = np.stack([room_points(rng, p) for _ in range(batch_size)])
    pts = np.clip(pts, 0.05, limit).astype(np.float32)
    labels = rng.integers(0, cfg.classes, size=(batch_size, p)).astype(np.int32)
    inst = rng.integers(0, cfg.tpu_max_instances, size=(batch_size, p)).astype(np.int32)
    return {
        "points": pts,
        "feats": rng.normal(size=(batch_size, p, 3)).astype(np.float32),
        "coords": np.floor(pts * cfg.scale).astype(np.int32),
        "point_mask": np.ones((batch_size, p), bool),
        "labels": labels,
        "instance_labels": inst,
        "pc_mins": pts.min(1),
        "pc_maxs": pts.max(1),
    }
