"""Full-resolution prediction assembly shared by the eval drivers.

The device path predicts on at most `tpu_max_points` points per scene
(`data/collate.py:pad_scene` subsamples over-capacity scenes, recording the
kept raw indices in `sel`). The reference, by contrast, always scores masks
at the scene's full N (test.py:33-134; testMerge has no eval crop,
datasets/scannetv2_inst.py:389-455). This module restores that contract:
predicted masks are projected back to raw resolution by 1-nearest-neighbor
over the kept points (exact — identity — on every kept point, nearest kept
point elsewhere), and ground truth is taken at raw resolution, never
truncated.

The port's copy of geoformer_tpu/evaluation/predictions.py
(host code, kept name for name): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def scene_alignment(batch: dict, scene_index: int = 0):
    """(n_points, n_raw, sel) for one scene of a padded batch.

    n_points = points actually on device, sel[:n_points] = their raw
    indices. n_raw may exceed n_points when the scene was subsampled.
    Batches predating the `sel` key fall back to identity alignment.
    """
    n_points = int(np.asarray(batch["n_points"][scene_index]))
    if "sel" not in batch:
        return n_points, n_points, np.arange(n_points)
    n_raw = int(np.asarray(batch["n_raw"][scene_index]))
    sel = np.asarray(batch["sel"][scene_index])[:n_points].astype(np.int64)
    return n_points, n_raw, sel


def nn_projection(raw_xyz: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """For every raw point, the position (0..len(sel)) of its nearest kept
    point. Kept points map to themselves (distance 0)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(raw_xyz[sel])
    _, nn = tree.query(raw_xyz, k=1, workers=-1)
    return nn.astype(np.int64)


def masks_to_raw(masks: np.ndarray, batch: dict, raw_xyz: np.ndarray,
                 scene_index: int = 0) -> np.ndarray:
    """[Q, P(padded or n_points)] device masks -> [Q, n_raw] raw-resolution
    masks, aligned with untruncated ground truth."""
    n_points, n_raw, sel = scene_alignment(batch, scene_index)
    masks = masks[:, :n_points]
    if n_raw == n_points:
        return masks
    if raw_xyz.shape[0] != n_raw:
        raise ValueError(
            f"raw scene has {raw_xyz.shape[0]} points but batch records n_raw={n_raw}"
        )
    nn = nn_projection(raw_xyz, sel)
    return masks[:, nn]


def labels_to_raw(labels: np.ndarray, batch: dict, raw_xyz: np.ndarray,
                  scene_index: int = 0) -> np.ndarray:
    """Per-point labels/scores [P, ...] -> raw resolution [n_raw, ...]."""
    n_points, n_raw, sel = scene_alignment(batch, scene_index)
    labels = labels[:n_points]
    if n_raw == n_points:
        return labels
    nn = nn_projection(raw_xyz, sel)
    return labels[nn]
