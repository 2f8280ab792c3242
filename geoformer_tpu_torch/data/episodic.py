"""Episodic few-shot dataset (reference datasets/scannetv2_fs_inst.py).

Train episodes: sample a fold class -> a query scene containing it (binary
labels, instances of that class only) + a support scene with a masked
instance. Test: fixed `test_combinations_fold{k}.pkl` and the 10 pickled
support sets, for reproducible evaluation (scannetv2_fs_inst.py:98-182).

The port's copy of geoformer_tpu/data/episodic.py (host numpy code, kept
name for name). Training episodes draw classes and scenes from Python's
``random`` and augmentations from numpy, both seeded from the training
script's seed.
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

from geoformer_tpu_torch.data.augment import (
    augment_affine,
    compact_instance_labels,
    crop_to_budget,
    elastic,
)
from geoformer_tpu_torch.data.collate import pad_batch
from geoformer_tpu_torch.data.scannet import FOLD, local_batch_size


def region_crop_instance(xyz, instance_label, instance_id, scale_factor=2):
    """Indices of points inside the instance's padded bbox, scaled.

    Port of the reference support crop (scannetv2_fs_inst.py:293-328,
    get_region_inst): bbox of the instance +0.1 pad per axis, extents
    scaled by scale_factor (halved internally like the reference;
    scale_factor=-1 keeps everything)."""
    half = scale_factor / 2
    if half == -1:
        return np.arange(xyz.shape[0])
    inst = xyz[instance_label == instance_id]
    lo, hi = inst.min(0), inst.max(0)
    mid = (lo + hi) / 2
    size = hi - lo + 0.1
    keep = np.all(
        (xyz >= mid - size * half) & (xyz <= mid + size * half), axis=1
    )
    return np.nonzero(keep)[0]


def sphere_crop_instance(xyz, instance_label, instance_id, scale_factor=2):
    """Sphere variant (scannetv2_fs_inst.py:277-291, get_sphere_inst):
    ball around the instance centroid with radius = scaled max extent."""
    half = scale_factor / 2
    if half == -1:
        return np.arange(xyz.shape[0])
    inst = xyz[instance_label == instance_id]
    centroid = inst.mean(0)
    radius = half * np.linalg.norm(inst - centroid, axis=1).max()
    keep = np.linalg.norm(xyz - centroid, axis=1) <= radius
    return np.nonzero(keep)[0]


class FSInstDataset:
    def __init__(self, cfg, split_set="train"):
        self.cfg = cfg
        self.split_set = split_set
        self.scale = cfg.scale
        self.full_scale = cfg.full_scale
        self.max_npoint = cfg.max_npoint
        self.root = os.path.join(cfg.data_root, cfg.dataset)
        with open(os.path.join(self.root, f"scannetv2_{split_set}.txt")) as f:
            self.scan_names = f.read().splitlines()
        scenes_dir = os.path.join(self.root, "scenes")
        files = os.listdir(scenes_dir) if os.path.isdir(scenes_dir) else []
        self.file_names = sorted(
            os.path.join(scenes_dir, f)
            for f in files
            if f.split(".")[0] in set(self.scan_names)
        )
        self.fold_classes = FOLD[cfg.cvfold]
        with open(os.path.join(self.root, "class2scans.pkl"), "rb") as f:
            self.class2scans = pickle.load(f)
        with open(os.path.join(self.root, "class2instances.pkl"), "rb") as f:
            self.class2instances = pickle.load(f)

    def __len__(self):
        return len(self.file_names)

    # ------------- scene loading -------------

    def _scene_path(self, scene_name):
        return os.path.join(self.root, "scenes", f"{scene_name}.npy")

    def load_single(self, scene_name, rng, aug=True, crop=True):
        data = np.load(self._scene_path(scene_name))
        xyz_origin = data[:, :3]
        rgb = data[:, 3:6]
        label = data[:, 6].astype(np.int32)
        instance_label = data[:, 7].astype(np.int32)

        if aug:
            xyz_middle = augment_affine(xyz_origin, rng, jitter=True, flip=True, rot=True)
        else:
            xyz_middle = xyz_origin
        xyz = xyz_middle * self.scale
        if aug:
            xyz = elastic(xyz, 6 * self.scale // 50, 40 * self.scale / 50, rng)
            xyz = elastic(xyz, 20 * self.scale // 50, 160 * self.scale / 50, rng)
        xyz -= xyz.min(0)
        if crop:
            xyz, valid = crop_to_budget(xyz, self.max_npoint, self.full_scale[1], rng)
            xyz_middle, xyz = xyz_middle[valid], xyz[valid]
            rgb, label, instance_label = rgb[valid], label[valid], instance_label[valid]
        return xyz_middle, xyz, rgb, label, instance_label

    def _query_scene(self, scene_name, sampled_class, rng, aug):
        xyz_middle, xyz, rgb, label, instance_label = self.load_single(
            scene_name, rng, aug=aug, crop=aug
        )
        # binary semantics: 1 where the sampled class lives
        binary = (label == sampled_class).astype(np.int32)
        instance_label = instance_label.copy()
        instance_label[binary == 0] = -100
        instance_label = compact_instance_labels(instance_label)
        return {
            "points": xyz_middle.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "coords": np.floor(xyz).astype(np.int32),
            "labels": binary,
            "instance_labels": instance_label,
        }

    def _support_scene(self, scene_name, instance_id, rng, region_crop=False):
        """Support scene; region_crop=True crops to the instance bbox x1
        region like the reference's load_single_block path
        (scannetv2_fs_inst.py:367-395, used by testMergeFS when
        fix_support is off). Training supports and the frozen-support-set
        path feed the full scene (load_single(support=True), :470 and
        test_fs.py:67). `cfg.full_scale_support` (a minimum dynamic
        spatial shape in the reference) is subsumed by our static
        tpu_spatial_shape padding."""
        xyz_middle, xyz, rgb, label, instance_label = self.load_single(
            scene_name, rng, aug=False, crop=False
        )
        if region_crop:
            keep = region_crop_instance(xyz_middle, instance_label, instance_id, scale_factor=1)
            xyz_middle, rgb = xyz_middle[keep], rgb[keep]
            label, instance_label = label[keep], instance_label[keep]
            xyz = xyz_middle * self.scale
            xyz -= xyz.min(0)
        mask = (instance_label == instance_id).astype(np.int32)
        return {
            "points": xyz_middle.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "coords": np.floor(xyz).astype(np.int32),
            "labels": label,
            "instance_labels": instance_label,
            "support_masks": mask,
        }

    # ------------- train episodes -------------

    def train_batches(self, batch_size, seed=0, epochs=1):
        """Generator of (support batch, query batch, infos) episodes.
        ``batch_size`` is the global batch: a process draws batch_size /
        world episodes a step, from its own rank-offset stream, and every
        process yields len // batch_size batches."""
        from geoformer_tpu_torch.parallel.dist import get_world_size, local_seed

        per_rank = local_batch_size(batch_size, get_world_size())
        rng = np.random.default_rng(local_seed(seed))
        pyrng = random.Random(local_seed(seed))
        n_batches = max(len(self) // batch_size, 1)
        for _ in range(epochs):
            for _ in range(n_batches):
                queries, supports, infos = [], [], []
                for _ in range(per_rank):
                    cls = pyrng.choice(self.fold_classes)
                    query_name = pyrng.choice(self.class2scans[cls])
                    queries.append(self._query_scene(query_name, cls, rng, aug=True))
                    # bounded retry, gated on more than 100 points of the
                    # support instance itself (the JAX module's documented
                    # deviation from the reference's class-count gate)
                    for _ in range(20):
                        sup_name, sup_inst = pyrng.choice(self.class2instances[cls])
                        sup = self._support_scene(sup_name, sup_inst, rng)
                        if sup["support_masks"].sum() > 100:
                            break
                    supports.append(sup)
                    infos.append({"class": cls, "query": query_name, "support": sup_name})
                yield (
                    pad_batch(supports, self.cfg.tpu_max_points, rng),
                    pad_batch(queries, self.cfg.tpu_max_points, rng),
                    infos,
                )

    # ------------- test protocol -------------

    def load_test_combinations(self):
        path = os.path.join(self.root, f"test_combinations_fold{self.cfg.cvfold}.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def load_support_sets(self, k_shot=None):
        k_shot = k_shot or self.cfg.k_shot
        path = os.path.join(
            self.root, "support_sets",
            f"{self.cfg.type_support}{self.cfg.cvfold}_{k_shot}shot_10sets.pkl",
        )
        with open(path, "rb") as f:
            return pickle.load(f)

    def test_batches(self):
        """Yield (scene_name, active_classes, ONE query batch per scene).

        The per-class query batches of the reference protocol differ only
        in their binary labels (scannetv2_fs_inst.py:testMergeFS) — which
        the eval forward never reads — so the scene is padded and encoded
        once and every active class decodes against the same cache (the
        reference's own `remember` path reuses its cache across the scene
        the same way, geoformer_fs.py:439-527)."""
        rng = np.random.default_rng(self.cfg.test_seed)
        combs = self.load_test_combinations()
        for path in self.file_names:
            name = os.path.basename(path).split(".")[0][:12]
            comb = combs.get(name, {})
            active = comb.get("active_label", [])
            if not active:
                continue
            batch = pad_batch(
                [self._query_scene(name, active[0], rng, aug=False)],
                self.cfg.tpu_max_points, rng,
            )
            yield name, active, batch

    def support_batch(self, scene_name, instance_id, rng=None, region_crop=None):
        rng = rng or np.random.default_rng(self.cfg.test_seed)
        # per-scene (non-frozen) test supports use the bbox region crop,
        # matching testMergeFS's fix_support=False branch
        if region_crop is None:
            region_crop = not getattr(self.cfg, "fix_support", True)
        sup = self._support_scene(scene_name, instance_id, rng, region_crop=region_crop)
        return pad_batch([sup], self.cfg.tpu_max_points, rng)
