"""Host-side label helpers (numpy).

The port's copy of the part of geoformer_tpu/data/augment.py that the eval
loaders call. The training augmentations (affine jitter, elastic
distortion, crop to the point budget) come with the training slice.
"""

from __future__ import annotations

import numpy as np


def compact_instance_labels(instance_label):
    """Remap instance ids to contiguous [0, n) keeping -100
    (scannetv2_inst.py:224-232 getCroppedInstLabel semantics)."""
    out = np.full_like(instance_label, -100)
    ids = np.unique(instance_label[instance_label >= 0])
    for new, old in enumerate(ids):
        out[instance_label == old] = new
    return out
