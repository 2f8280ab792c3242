"""Synthetic ScanNet-like scenes (the port's copy of the room generator in
__graft_entry__.py: _room_points, _synthetic_batch) and a synthetic dataset
on disk in the layout of tools/make_synthetic_data.py.

Surface scans at ~2 cm spacing: floor, three walls and furniture boxes with
sensor noise, so the geodesic graph is dense and the voxels are
surface-occupied like a real scan. Arrays are numpy, made from a seed.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

N_BOXES = 8  # furniture boxes of a room, three scanned faces each


def room_points(rng: np.random.Generator, n_points: int) -> np.ndarray:
    return room_scan(rng, n_points)[0]


def room_scan(rng: np.random.Generator, n_points: int):
    """-> (points [n,3] f32, part [n] int): part 0 is the floor, 1-3 the
    walls, 4 + j furniture box j."""
    area = n_points * 0.02 * 0.02
    side = max(np.sqrt(area / 4.0), 1.0)
    rects = [((0, 0, 0), (side, 0, 0), (0, side, 0))]
    h = side * 0.6
    rects += [
        ((0, 0, 0), (side, 0, 0), (0, 0, h)),
        ((0, 0, 0), (0, side, 0), (0, 0, h)),
        ((0, side, 0), (side, 0, 0), (0, 0, h)),
    ]
    for _ in range(N_BOXES):  # furniture boxes: top + 2 faces each
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
    rect_part = np.array([0, 1, 2, 3] + [4 + j for j in range(N_BOXES) for _ in range(3)])
    return out - out.min(0) + 0.05, np.repeat(rect_part, counts)


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


def write_dataset(root: str, n_scenes: int, n_points: int, seed: int = 0) -> str:
    """Write a synthetic ScanNet-format dataset under ``root/scannetv2`` and
    return that directory: what tools/make_synthetic_data.py writes (scene
    ``.npy`` [N, 8] = xyz, rgb, label 0-19, instance id; split lists, the
    first half train and the rest val; class2scans.pkl, class2instances.pkl,
    test_combinations_fold{0,1}.pkl, support_sets/*_{1,5}shot_10sets.pkl),
    but from room scans of any size: floor (label 0), walls (label 1) and
    furniture boxes that each carry one fold class and one instance id."""
    from geoformer_tpu_torch.data.scannet import FOLD

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "scannetv2")
    os.makedirs(os.path.join(base, "scenes"), exist_ok=True)
    os.makedirs(os.path.join(base, "support_sets"), exist_ok=True)
    names = [f"scene{i:04d}_00" for i in range(n_scenes)]
    class2scans = {c: [] for c in FOLD[2]}
    class2instances = {c: [] for c in FOLD[2]}
    scene_classes = {}
    for name in names:
        xyz, part = room_scan(rng, n_points)
        box_class = rng.choice(FOLD[2], size=N_BOXES)
        label = np.where(part >= 4, box_class[np.maximum(part - 4, 0)], np.minimum(part, 1))
        inst = np.where(part >= 4, part - 4, -100)
        rgb = rng.uniform(-1, 1, size=(len(xyz), 3))
        np.save(os.path.join(base, "scenes", f"{name}.npy"),
                np.concatenate([xyz, rgb, label[:, None], inst[:, None]], axis=1))
        present = np.unique(part[part >= 4]) - 4  # a tiny box may get no point
        scene_classes[name] = sorted({int(box_class[j]) for j in present})
        for c in scene_classes[name]:
            class2scans[c].append(name)
        for j in present:
            class2instances[int(box_class[j])].append([name, int(j)])

    half = max(n_scenes // 2, 1)
    for split, part_names in (("train", names[:half]), ("val", names[half:])):
        with open(os.path.join(base, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(part_names))
    # every class needs at least one scene and instance for the episodic sampler
    for c in FOLD[2]:
        class2scans[c] = class2scans[c] or [names[0]]
        class2instances[c] = class2instances[c] or [[names[0], 0]]
    for fname, obj in (("class2scans.pkl", class2scans), ("class2instances.pkl", class2instances)):
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump(obj, f)

    for fold in (0, 1):
        combs = {}
        for name in names[half:]:
            active = [c for c in scene_classes[name] if c in FOLD[fold]]
            combs[name] = {"active_label": active, **{c: class2instances[c][0] for c in active}}
        with open(os.path.join(base, f"test_combinations_fold{fold}.pkl"), "wb") as f:
            pickle.dump(combs, f)
        # a class with fewer than k instances repeats them (the mean
        # embedding is still over k tuples)
        for k in (1, 5):
            sets = [{c: [tuple(class2instances[c][i % len(class2instances[c])])
                         for i in range(k)] for c in FOLD[fold]} for _ in range(10)]
            path = os.path.join(base, "support_sets", f"fullscene_fold{fold}_{k}shot_10sets.pkl")
            with open(path, "wb") as f:
                pickle.dump(sets, f)
    return base
