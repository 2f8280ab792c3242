"""Ground-truth id encoding for the ScanNet protocol.

gt_id = benchmark_semantic_id * 1000 + instance_index + 1, 0 for
unannotated points (reference data/scannetv2/prepare_data_inst_gttxt.py:
33-71). Raw labels are the 0-19 remap; BENCHMARK_SEMANTIC_LABELS maps them
back to nyu40 benchmark ids.

The port's copy of geoformer_tpu/evaluation/gt.py
(host code, kept name for name): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from geoformer_tpu_torch.data.scannet import BENCHMARK_SEMANTIC_LABELS


def make_gt_ids(raw_labels: np.ndarray, instance_labels: np.ndarray) -> np.ndarray:
    out = np.zeros(instance_labels.shape, np.int64)
    bench = np.asarray(BENCHMARK_SEMANTIC_LABELS)
    for inst_id in np.unique(instance_labels):
        if inst_id < 0:
            continue
        sel = instance_labels == inst_id
        sem = int(raw_labels[sel][0])
        if sem == -100:
            sem = 0
        out[sel] = bench[sem] * 1000 + inst_id + 1
    return out


def load_gt_ids(path: str) -> np.ndarray:
    """Read a gt txt (one id per line), reference util/utils_3d.py:9-16
    load_ids."""
    return np.loadtxt(path, dtype=np.int64)


def load_benchmark_predictions(listing_path: str) -> dict:
    """Read a ScanNet benchmark submission for one scene
    (util/utils_3d.py:18-73 get_instances input side): the per-scene txt
    lists `mask_rel_path label_id conf`; masks are 0/1 txt files relative to
    the listing's directory. Returns the evaluator's pred_info dict."""
    import os

    base = os.path.dirname(os.path.abspath(listing_path))
    label_ids, confs, masks = [], [], []
    with open(listing_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            rel, label_id, conf = parts
            masks.append(np.loadtxt(os.path.join(base, rel), dtype=np.int32))
            label_ids.append(int(label_id))
            confs.append(float(conf))
    return {
        "label_id": np.asarray(label_ids, np.int64),
        "conf": np.asarray(confs, np.float64),
        "mask": masks,
    }
