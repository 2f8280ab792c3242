"""ScanNetV2 dataset: scene loading, label remap, padded batches.

Reference: datasets/scannetv2.py (fold constants), datasets/scannetv2_inst.py
(InstDataset). Scene files are per-scene .npy arrays [N, 8]:
(x, y, z, r, g, b, semantic_label in nyu-remapped 0-19/-100, instance_id).

The port's copy of geoformer_tpu/data/scannet.py (host numpy code, kept
name for name).
"""

from __future__ import annotations

import os

import numpy as np

from geoformer_tpu_torch.data.augment import (
    augment_affine,
    compact_instance_labels,
    crop_to_budget,
    elastic,
)
from geoformer_tpu_torch.data.collate import pad_batch

FOLD0 = [2, 3, 4, 7, 9, 11, 12, 13, 18]
FOLD1 = [5, 6, 8, 10, 14, 15, 16, 17, 19]
FOLD2 = [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]
FOLD = {0: FOLD0, 1: FOLD1, 2: FOLD2}

FOLD0_NAME = ["cabinet", "bed", "chair", "door", "bookshelf", "counter", "desk", "curtain", "bathtub"]
FOLD1_NAME = [
    "otherfurniture", "picture", "refridgerator", "shower curtain", "sink",
    "sofa", "table", "toilet", "window",
]
FOLD_NAME = {0: FOLD0_NAME, 1: FOLD1_NAME}

BENCHMARK_SEMANTIC_LABELS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]


def remap_semantic_labels(label: np.ndarray, fold_classes: list[int]) -> np.ndarray:
    """4-way remap (scannetv2_inst.py:314-324): 0 floor, 1 wall, 2 unannotated,
    3 test-candidate (classes outside the fold), 4.. fold classes in order."""
    out = np.full_like(label, -1)
    out[label == 0] = 0
    out[label == 1] = 1
    for idx, cls in enumerate(fold_classes):
        out[label == cls] = idx + 4
    out[label == -100] = 2
    out[out == -1] = 3
    return out


def local_batch_size(batch_size: int, world: int) -> int:
    """A rank's share of the global batch; raises when the ranks cannot
    share it evenly."""
    if batch_size % world:
        raise ValueError(f"the batch of {batch_size} cannot be split over {world} ranks")
    return batch_size // world


class InstDataset:
    """Fully-supervised dataset (scannetv2_inst.py:24-455)."""

    def __init__(self, cfg, split_set="train"):
        self.cfg = cfg
        self.split_set = split_set
        self.scale = cfg.scale
        self.full_scale = cfg.full_scale
        self.max_npoint = cfg.max_npoint
        root = os.path.join(cfg.data_root, cfg.dataset)
        with open(os.path.join(root, f"scannetv2_{split_set}.txt")) as f:
            self.scan_names = f.read().splitlines()
        scenes_dir = os.path.join(root, "scenes")
        files = os.listdir(scenes_dir) if os.path.isdir(scenes_dir) else []
        self.file_names = sorted(
            os.path.join(scenes_dir, f)
            for f in files
            if f.split(".")[0][:12] in set(self.scan_names)
        )
        self.fold_classes = FOLD[cfg.cvfold]

    def __len__(self):
        return len(self.file_names)

    def load_raw(self, index):
        data = np.load(self.file_names[index])
        return data[:, :3], data[:, 3:6], data[:, 6].astype(np.int32), data[:, 7].astype(np.int32)

    def build_scene(self, index, rng, training: bool):
        xyz_origin, rgb, label, instance_label = self.load_raw(index)
        if training:
            xyz_middle = augment_affine(xyz_origin, rng, jitter=True, flip=True, rot=True)
            xyz = xyz_middle * self.scale
            xyz = elastic(xyz, 6 * self.scale // 50, 40 * self.scale / 50, rng)
            xyz = elastic(xyz, 20 * self.scale // 50, 160 * self.scale / 50, rng)
            xyz -= xyz.min(0)
            xyz, valid = crop_to_budget(xyz, self.max_npoint, self.full_scale[1], rng)
            xyz_middle, xyz = xyz_middle[valid], xyz[valid]
            rgb, label, instance_label = rgb[valid], label[valid], instance_label[valid]
            rgb = rgb + rng.standard_normal(3) * 0.1
        else:
            xyz_middle = xyz_origin
            xyz = xyz_middle * self.scale
            xyz -= xyz.min(0)

        label = remap_semantic_labels(label, self.fold_classes)
        instance_label = instance_label.copy()
        instance_label[label <= 3] = -100
        instance_label = compact_instance_labels(instance_label)

        return {
            "points": xyz_middle.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "coords": np.floor(xyz).astype(np.int32),
            "labels": label.astype(np.int32),
            "instance_labels": instance_label.astype(np.int32),
        }

    def train_batches(self, batch_size, seed=0, epochs=1):
        """Generator of padded training batches (shuffled, drop_last).

        ``batch_size`` is the global batch. Multi-process runs get a
        per-process strided shard of the same global shuffle
        (DistributedSampler semantics, every shard padded to one length),
        load batch_size / world scenes of it a step and augment with a
        rank-offset RNG: every rank yields the same number of batches, and
        a step's scenes over all ranks are the global shuffle's next
        batch_size."""
        from geoformer_tpu_torch.parallel.dist import get_world_size, local_seed, shard_indices

        per_rank = local_batch_size(batch_size, get_world_size())
        rng = np.random.default_rng(local_seed(seed))
        for e in range(epochs):
            order = shard_indices(len(self), batch_size, seed + e)
            for i in range(0, len(order) - per_rank + 1, per_rank):
                scenes = [self.build_scene(j, rng, True) for j in order[i : i + per_rank]]
                yield pad_batch(scenes, self.cfg.tpu_max_points, rng)

    def test_batches(self):
        """Generator of (scene_name, padded batch of 1) for eval."""
        rng = np.random.default_rng(self.cfg.test_seed)
        for i in range(len(self)):
            name = os.path.basename(self.file_names[i]).split(".")[0][:12]
            scene = self.build_scene(i, rng, False)
            yield name, pad_batch([scene], self.cfg.tpu_max_points, rng)
