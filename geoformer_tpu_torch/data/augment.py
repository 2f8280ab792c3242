"""Host-side point cloud augmentation (numpy; the port's copy of
geoformer_tpu/data/augment.py).

Semantics of the reference dataloader (datasets/scannetv2_inst.py:142-232):
jitter/flip/rotate affine, elastic distortion, random crop to the point
budget. The elastic blur and trilinear gather run in the native C++ library
(geoformer_tpu_torch/native.py) wherever g++ builds it, numpy/scipy
otherwise, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from geoformer_tpu_torch import native


def augment_affine(xyz, rng, jitter=False, flip=False, rot=False):
    m = np.eye(3)
    if jitter:
        m += rng.standard_normal((3, 3)) * 0.1
    if flip:
        m[0][0] *= rng.integers(0, 2) * 2 - 1
    if rot:
        theta = rng.random() * 2 * math.pi
        m = np.matmul(
            m,
            [[math.cos(theta), math.sin(theta), 0],
             [-math.sin(theta), math.cos(theta), 0],
             [0, 0, 1]],
        )
    return np.matmul(xyz, m)


def elastic(x, gran, mag, rng):
    """Elastic distortion over a blurred noise grid (scannetv2_inst.py:142-161)."""
    bb = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = np.stack(
        [rng.standard_normal(tuple(bb)).astype(np.float32) for _ in range(3)]
    )
    noise = native.elastic_blur(noise)
    g = native.trilinear_gather(noise, float(gran), x.astype(np.float32))
    return x + g * mag


def crop_to_budget(xyz, max_npoint, full_scale, rng):
    """Random shift-crop until <= max_npoint points fit in full_scale^3
    (scannetv2_inst.py:206-222). xyz is scaled voxel-space coords >= 0."""
    xyz_offset = xyz.copy()
    valid = xyz_offset.min(1) >= 0
    fs = np.array([full_scale] * 3, np.float64)
    room_range = xyz.max(0) - xyz.min(0)
    while valid.sum() > max_npoint:
        offset = np.clip(fs - room_range + 0.001, None, 0) * rng.random(3)
        xyz_offset = xyz + offset
        valid = (xyz_offset.min(1) >= 0) & ((xyz_offset < fs).sum(1) == 3)
        fs[:2] -= 32
    return xyz_offset, valid


def compact_instance_labels(instance_label):
    """Remap instance ids to contiguous [0, n) keeping -100
    (scannetv2_inst.py:224-232 getCroppedInstLabel semantics)."""
    out = np.full_like(instance_label, -100)
    ids = np.unique(instance_label[instance_label >= 0])
    for new, old in enumerate(ids):
        out[instance_label == old] = new
    return out
