"""The benchmark's scenes: synthetic ScanNet-like room scans (a frozen copy
of the port's ``synthetic.room_scan``: floor, three walls and 8 furniture
boxes with three scanned faces each, ~2 cm spacing, 3 mm sensor noise) of
a frozen set of room layouts, sampled from the run's seed (points, noise,
features, the order of the rooms), labelled from their surfaces (floor 0,
walls 1, box j: class 4 + j % 9 and instance j). Nothing here knows the
program's capacities: a scan is what the room gives.

The program receives only the arrays made here.
"""

from __future__ import annotations

import numpy as np

N_BOXES = 8
LAYOUT_SEED = 20241018


def layouts(n: int) -> list:
    """n frozen room layouts: each box's (cx, cy) and (w, d, h) as
    fractions of the room's side. The geodesic solve's sweeps follow a
    room's geometry, so every seed gets this same set of rooms, in its own
    order and with its own points, noise and features."""
    g = np.random.default_rng(LAYOUT_SEED)
    return [[(g.uniform(0.15, 0.75, 2), g.uniform(0.05, 0.25, 3)) for _ in range(N_BOXES)]
            for _ in range(n)]


def room_scan(rng: np.random.Generator, n_points: int, layout: list):
    """-> (points [n,3] f32, part [n] int): part 0 is the floor, 1-3 the
    walls, 4 + j furniture box j of ``layout``."""
    area = n_points * 0.02 * 0.02
    side = max(np.sqrt(area / 4.0), 1.0)
    rects = [((0, 0, 0), (side, 0, 0), (0, side, 0))]
    h = side * 0.6
    rects += [
        ((0, 0, 0), (side, 0, 0), (0, 0, h)),
        ((0, 0, 0), (0, side, 0), (0, 0, h)),
        ((0, side, 0), (side, 0, 0), (0, 0, h)),
    ]
    for (cx, cy), (w, d, bh) in ((c * side, s * side) for c, s in layout):
        # furniture boxes: top + 2 faces each
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
    rect_part = np.array([0, 1, 2, 3] + [4 + j for j in range(N_BOXES) for _ in range(3)])
    return out - out.min(0) + 0.05, np.repeat(rect_part, counts)


def scene(cfg: dict, rng: np.random.Generator, layout: list) -> dict:
    """One scan of ``layout`` with ``cfg["tpu_max_points"]`` points at the
    config's grid (numpy arrays without a batch axis). Its points come
    furniture first, then the walls and the floor: the order in which a
    segmentation that keeps furniture as foreground would pack them, each
    surface at the scan's own density."""
    p = cfg["tpu_max_points"]
    pts, part = room_scan(rng, p, layout)
    order = np.argsort(part < 4, kind="stable")
    pts, part = pts[order], part[order]
    box = part >= 4
    return {
        "points": pts,
        "feats": rng.normal(size=(p, 3)).astype(np.float32),
        "coords": np.floor(pts * cfg["scale"]).astype(np.int64),
        "point_mask": np.ones(p, bool),
        "labels": np.where(box, 4 + (part - 4) % 9, np.minimum(part, 1)).astype(np.int64),
        "instance_labels": np.where(box, part - 4, cfg["ignore_label"]).astype(np.int64),
        "pc_mins": pts.min(0),
        "pc_maxs": pts.max(0),
    }


def scans(cfg: dict, rng: np.random.Generator, n: int) -> list:
    """n scans, one of each of ``layouts(n)``, in an order drawn from rng."""
    rooms = layouts(n)
    return [scene(cfg, rng, rooms[i]) for i in rng.permutation(n)]


def stack(scenes: list) -> dict:
    """Scenes -> one [B, ...] batch."""
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
