"""Padded batch assembly: variable scenes -> fixed [B, P, ...] arrays.

The device contract: every batch has static shapes; `point_mask` marks real
points. Scenes larger than the capacity are subsampled (uniform, like the
reference's crop budget); smaller scenes are zero-padded.

The port's copy of geoformer_tpu/data/collate.py
(host code, kept name for name): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def pad_scene(scene: dict, max_points: int, rng=None):
    n_raw = scene["points"].shape[0]
    n = n_raw
    if n > max_points:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, max_points, replace=False)
        sel.sort()
        scene = {
            k: (v[sel] if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n else v)
            for k, v in scene.items()
        }
        n = max_points
    else:
        sel = np.arange(n)

    def pad(a, fill=0):
        out = np.full((max_points,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    return {
        "points": pad(scene["points"].astype(np.float32)),
        "feats": pad(scene["feats"].astype(np.float32)),
        "coords": pad(scene["coords"].astype(np.int32)),
        "labels": pad(scene["labels"].astype(np.int32), fill=-100),
        "instance_labels": pad(scene["instance_labels"].astype(np.int32), fill=-100),
        "support_masks": pad(scene.get("support_masks", np.zeros(n, np.int32)).astype(np.int32)),
        "point_mask": pad(np.ones(n, bool)),
        "pc_mins": scene["points"].min(0).astype(np.float32) if n else np.zeros(3, np.float32),
        "pc_maxs": scene["points"].max(0).astype(np.float32) if n else np.ones(3, np.float32),
        "n_points": np.int32(n),
        # raw-scene alignment: slot i of the padded arrays is raw point
        # sel[i] (identity when the scene fits; -1 in the pad region).
        # Eval drivers project masks back to raw resolution through this —
        # the reference always scores at full N (test.py:33-134, no eval
        # crop in scannetv2_inst.py:389-455).
        "sel": pad(sel.astype(np.int32), fill=-1),
        "n_raw": np.int32(n_raw),
    }


def pad_batch(scenes: list[dict], max_points: int, rng=None) -> dict:
    """List of per-scene dicts -> stacked [B, P, ...] numpy batch."""
    padded = [pad_scene(s, max_points, rng) for s in scenes]
    return {k: np.stack([p[k] for p in padded]) for k in padded[0]}
