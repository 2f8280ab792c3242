"""Eval engine (port of the eval half of geoformer_tpu/engine.py).

``Engine(cfg)`` builds the supervised GeoFormer on the card (or on the
device the caller names) and ``eval_batch`` runs the eval forward plus the
per-scene matrix NMS that test.py applies after it (test.py:40-43). The
training step waits for the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from geoformer_tpu_torch import default_device, set_fp32_precision
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
from geoformer_tpu_torch.ops.nms import matrix_nms
from geoformer_tpu_torch.weights import random_state_dict

_DTYPES = {"coords": torch.long, "point_mask": torch.bool}


class Engine:
    def __init__(self, cfg, device=None, state_dict=None, seed: int = 0):
        """Raises when no device is given and CUDA is absent. Without a
        state_dict the weights are seeded random (``random_state_dict``)."""
        self.device = default_device(device)
        set_fp32_precision()
        self.cfg = cfg
        self.mc = ModelConfig.from_cfg(cfg)
        self.model = GeoFormer(self.mc)
        if state_dict is None:
            state_dict = random_state_dict(self.model, seed)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> dict:
        """Eval forward on a [B, ...] batch: the JAX forward's outputs
        (semantic_scores, voxel_stats, fg_idx, fg_valid, query_valid,
        cls_logits, mask_logits, proposals) plus ``nms``: per-scene
        matrix-NMS keep flags and decayed scores [B, Q]."""
        tensors = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            tensors[k] = t.to(self.device, dtype=_DTYPES.get(k, t.dtype))
        out = self.model(tensors)
        props = out["proposals"]
        keeps, scores = [], []
        for i in range(props["scores"].shape[0]):
            keep, sc = matrix_nms(props["masks"][i], props["scores"][i], props["classes"][i],
                                  props["keep"][i], sigma=2.0,
                                  final_score_thresh=self.cfg.TEST_NMS_THRESH)
            keeps.append(keep)
            scores.append(sc)
        out["nms"] = {"keep": torch.stack(keeps), "scores": torch.stack(scores)}
        return out
