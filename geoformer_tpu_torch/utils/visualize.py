"""Offline visualization: colored point clouds and instance boxes (the
port's copy of geoformer_tpu/utils/visualize.py, numpy only).

The reference's viz utilities (util/visualize.py mayavi scenes,
util/draw_utils.py box line sets, util/utils.py:123-129 write_obj) open a
window; here everything exports to PLY/OBJ for any external viewer. The
files are byte for byte those of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

# 40-entry deterministic palette (golden-ratio hue walk), uint8 RGB
def _palette(n=40, seed=0):
    rng = np.random.default_rng(seed)
    h = (np.arange(n) * 0.61803398875 + rng.random()) % 1.0
    s = 0.65 + 0.3 * ((np.arange(n) * 7) % 3) / 2.0
    v = 0.8 + 0.2 * ((np.arange(n) * 5) % 2)
    i = (h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = np.choose(
        i[:, None],
        [np.stack([v, t, p], 1), np.stack([q, v, p], 1), np.stack([p, v, t], 1),
         np.stack([p, q, v], 1), np.stack([t, p, v], 1), np.stack([v, p, q], 1)],
    )
    return (rgb * 255).astype(np.uint8)


PALETTE = _palette()


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """Binary-less ASCII PLY of a colored point cloud."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(xyz)
    if rgb is None:
        rgb = np.full((n, 3), 200, np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def write_obj(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """OBJ vertex cloud with per-vertex colors (util/utils.py:123-129)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 200, np.uint8)
    with open(path, "w") as f:
        for p, c in zip(xyz, rgb):
            f.write(
                f"v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                f"{c[0] / 255:.3f} {c[1] / 255:.3f} {c[2] / 255:.3f}\n"
            )


def color_semantic(labels: np.ndarray) -> np.ndarray:
    """Per-point colors from semantic labels (-100/negatives -> gray)."""
    out = np.full((len(labels), 3), 128, np.uint8)
    ok = labels >= 0
    out[ok] = PALETTE[labels[ok] % len(PALETTE)]
    return out


def color_instances(instance_ids: np.ndarray) -> np.ndarray:
    """Per-point colors from instance ids (-100/negatives -> gray)."""
    return color_semantic(instance_ids)


def visualize_pts_rgb(xyz: np.ndarray, rgb01: np.ndarray, path: str):
    """RGB in [-1,1] or [0,1] -> colored PLY (reference visualize.py entry)."""
    rgb = rgb01.astype(np.float32)
    if rgb.min() < 0:
        rgb = (rgb + 1) / 2
    write_ply(path, xyz, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def box_corners(center: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Axis-aligned box -> 8 corners [8,3]."""
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32
    )
    return center[None, :] + 0.5 * signs * size[None, :]


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_boxes_obj(path: str, boxes: list[tuple[np.ndarray, np.ndarray]]):
    """Line-set OBJ of axis-aligned (center, size) boxes
    (util/draw_utils.py box plotting equivalent)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for center, size in boxes:
            for p in box_corners(np.asarray(center), np.asarray(size)):
                f.write(f"v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for b in range(len(boxes)):
            base = b * 8 + 1
            for i, j in _BOX_EDGES:
                f.write(f"l {base + i} {base + j}\n")


def export_scene_predictions(out_dir: str, scene_name: str, xyz: np.ndarray,
                             semantic_preds: np.ndarray,
                             proposal_masks: np.ndarray | None = None):
    """One call per evaluated scene: semantic + instance PLYs (+boxes).

    proposal_masks [nProp, N] bool; instance color = proposal rank.
    """
    write_ply(
        os.path.join(out_dir, f"{scene_name}_sem.ply"), xyz, color_semantic(semantic_preds)
    )
    if proposal_masks is not None and len(proposal_masks):
        inst = np.full(len(xyz), -100, np.int64)
        boxes = []
        for r, m in enumerate(proposal_masks.astype(bool)):
            inst[m] = r
            if m.any():
                lo, hi = xyz[m].min(0), xyz[m].max(0)
                boxes.append(((lo + hi) / 2, hi - lo))
        write_ply(
            os.path.join(out_dir, f"{scene_name}_inst.ply"), xyz, color_instances(inst)
        )
        write_boxes_obj(os.path.join(out_dir, f"{scene_name}_boxes.obj"), boxes)
