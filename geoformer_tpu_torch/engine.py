"""Train and eval engine (port of geoformer_tpu/engine.py).

``Engine(cfg)`` builds the supervised GeoFormer, or with ``few_shot=True``
GeoFormerFS, on the card (or on the device the caller names). The supervised
engine's ``eval_batch`` runs the eval forward plus the per-scene matrix NMS
that the test driver applies after it (test.py:40-43); the few-shot engine
is driven through its stages (``process_support``, ``encode_scene``,
``decode_with_support``, the last with test_fs.py:104-108's NMS over one
category). ``train_step`` is one step of either model: the prepare phase
(epoch <= prepare_epochs; the supervised model's semantic head only, the
criterion's semantic CE) or the full phase, its backward pass and the
optimizer's update (``init_state`` builds the optimizer).

``mesh`` (parallel/mesh.py; by default that of the process group, a world
of 1 without one) is the JAX Engine's data mesh: ``train_step`` and the
eval methods take the global batch and run this rank's rows of it
(``train_step(..., sharded=True)`` takes rows a rank loaded itself). A
training step runs under the ambient mesh, so its batch norms, draws and
loss normalisers are the global batch's, its gradient the global one, and
its returned loss and loss terms the global batch's on every rank.

A ("data", "model") mesh (``make_mesh(model_parallel=M)`` under torchrun,
as the JAX callers build ``Engine(cfg, mesh=make_mesh(model_parallel=M))``)
splits each scene's queries over the M ranks of its model group
(models/geoformer.py). ``train_step`` and ``eval_batch`` run under it;
``eval_batch`` returns the proposals and NMS of each scene once, on model
index 0 of its group (the other model ranks' outputs hold neither).
``encode_scene`` and ``decode_with_support`` run under the model group
alone: each rank decodes its own scene, as the JAX driver decodes one scene
outside any data mesh. Dropout draws from the process's generator: seed it
by the data index (``mesh.data_rank``), so that the ranks of a model group,
which run the same backbone, draw the same masks.
"""

from __future__ import annotations

import numpy as np
import torch

from geoformer_tpu_torch import default_device, set_fp32_precision
from geoformer_tpu_torch.losses import FSInstSetCriterion, InstSetCriterion
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
from geoformer_tpu_torch.models.geoformer_fs import GeoFormerFS
from geoformer_tpu_torch.ops.nms import matrix_nms
from geoformer_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh, set_mesh, shard_batch
from geoformer_tpu_torch.parallel.train_state import TrainState
from geoformer_tpu_torch.utils.scheduler import adjust_learning_rate, cosine_lr_after_step
from geoformer_tpu_torch.weights import random_state_dict

_DTYPES = {"coords": torch.long, "point_mask": torch.bool}


class Engine:
    def __init__(self, cfg, device=None, state_dict=None, seed: int = 0,
                 few_shot: bool = False, mesh=None):
        """Raises when no device is given and CUDA is absent. Without a
        state_dict the weights are seeded random (``random_state_dict``,
        the same on every rank)."""
        self.device = default_device(device)
        self.mesh = mesh or make_mesh(device=self.device)
        set_fp32_precision()
        self.cfg = cfg
        self.few_shot = few_shot
        self.mc = ModelConfig.from_cfg(cfg)
        self.model = GeoFormerFS(self.mc) if few_shot else GeoFormer(self.mc)
        if state_dict is None:
            state_dict = random_state_dict(self.model, seed)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.criterion = FSInstSetCriterion(cfg) if few_shot else InstSetCriterion(cfg)
        self.state = None
        self.last_voxel_stats = {}  # the capacity counters of the last train_step

    # ---------------- train ----------------

    def init_state(self) -> TrainState:
        """The optimizer over the trainable modules, step 0."""
        self.state = TrainState(self.cfg, self.model, self.mesh)
        return self.state

    def learning_rate(self, epoch: int) -> float:
        cfg = self.cfg
        if (not self.few_shot) and epoch <= cfg.prepare_epochs:
            return cosine_lr_after_step(cfg.lr, epoch, cfg.prepare_epochs, cfg.epochs)
        return adjust_learning_rate(cfg.base_lr, cfg.warm_lr, cfg.final_lr, cfg.warm_lr_epochs,
                                    cfg.epochs, epoch)

    def train_step(self, batch: dict, epoch: int, generator: torch.Generator,
                   support: dict | None = None, sharded: bool = False):
        """One training (micro-)step on a global [B, ...] batch (and the
        few-shot model's support batch), or with ``sharded`` on this rank's
        rows of it: forward in training mode, criterion, backward, update.
        ``generator`` (on the engine's device, seeded alike on every rank)
        draws the random subsamples. -> (loss, loss_dict, lr); the loss and
        the dict's values are detached tensors on the device, the global
        batch's."""
        if self.state is None:
            self.init_state()
        cfg = self.cfg
        prepare = epoch <= cfg.prepare_epochs
        epoch_repr = 0 if prepare else cfg.prepare_epochs + 1
        lr = self.learning_rate(epoch)
        if not sharded:
            batch = shard_batch(batch, self.mesh)
            support = shard_batch(support, self.mesh) if support is not None else None
        tb = self.to_device(batch)
        self.model.train()
        try:
            with set_mesh(self.mesh):
                if self.few_shot:
                    out = self.model(self.to_device(support), tb, train=True,
                                     generator=generator)
                else:
                    out = self.model(tb, train=True, semantic_only=prepare, generator=generator)
                loss, loss_dict = self.criterion(out, tb, epoch_repr)
                loss.backward()
            self.last_voxel_stats = out["voxel_stats"]
        finally:
            self.model.eval()
        self.state.apply_gradients(lr)
        # each rank's loss terms are its parts of the global batch's
        names = sorted(loss_dict)
        total = all_reduce_sum(torch.stack([loss_dict[k].detach().to(loss.dtype)
                                            for k in names]), self.mesh, axis="all",
                               site="loss_terms")
        loss_dict = dict(zip(names, total.unbind()))
        return loss_dict["loss"], loss_dict, lr

    def to_device(self, batch: dict) -> dict:
        """A numpy (or tensor) batch as tensors on the engine's device."""
        tensors = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            tensors[k] = t.to(self.device, dtype=_DTYPES.get(k, t.dtype))
        return tensors

    def _nms(self, props: dict, classes) -> dict:
        """Per-scene matrix NMS -> keep flags and decayed scores [B, Q]."""
        keeps, scores = [], []
        for i in range(props["scores"].shape[0]):
            keep, sc = matrix_nms(props["masks"][i], props["scores"][i], classes[i],
                                  props["keep"][i], sigma=2.0,
                                  final_score_thresh=self.cfg.TEST_NMS_THRESH)
            keeps.append(keep)
            scores.append(sc)
        return {"keep": torch.stack(keeps), "scores": torch.stack(scores)}

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> dict:
        """Supervised eval forward on a global [B, ...] batch, of which this
        rank runs its rows [B/N, ...]: the JAX forward's outputs
        (semantic_scores, voxel_stats, fg_idx, fg_valid, query_valid,
        cls_logits, mask_logits, proposals) plus ``nms``: per-scene
        matrix-NMS keep flags and decayed scores [B/N, Q]; on a model rank
        other than its group's first, no ``proposals`` and no ``nms``."""
        if self.few_shot:
            raise ValueError("the few-shot engine runs process_support, encode_scene "
                             "and decode_with_support")
        with set_mesh(self.mesh):
            out = self.model(self.to_device(shard_batch(batch, self.mesh)))
        if self.mesh.model_rank:
            del out["proposals"]
            return out
        out["nms"] = self._nms(out["proposals"], out["proposals"]["classes"])
        return out

    # ---------------- few-shot stages ----------------

    @torch.no_grad()
    def process_support(self, support_batch: dict) -> torch.Tensor:
        """Support batch -> [B, 2m] embedding."""
        return self.model.process_support(self.to_device(support_batch))

    @torch.no_grad()
    def encode_scene(self, scene_batch: dict) -> dict:
        """Global scene batch -> the support-independent cache of this
        rank's rows (plus their point_mask, pc_mins and pc_maxs, which the
        decode needs); ``decode_with_support`` takes such a cache."""
        tb = self.to_device(shard_batch(scene_batch, self.mesh))
        with set_mesh(self.mesh.model_view()):
            cache = self.model.encode_scene(tb)
        cache.update(point_mask=tb["point_mask"], pc_mins=tb["pc_mins"], pc_maxs=tb["pc_maxs"])
        return cache

    @torch.no_grad()
    def decode_with_support(self, cache: dict, support_embeddings) -> dict:
        """One decode of a cached scene [B=1 or more] against support
        embeddings [B, 2m]: proposals with the matrix NMS over one category
        applied (``keep`` is the NMS's)."""
        emb = torch.as_tensor(support_embeddings, dtype=torch.float32, device=self.device)
        with set_mesh(self.mesh.model_view()):
            dec = self.model.decode_with_support(cache, emb, cache["pc_mins"], cache["pc_maxs"])
        props = self.model.proposals(dec, cache["point_mask"])
        nms = self._nms(props, torch.zeros_like(props["scores"], dtype=torch.long))
        return {"masks": props["masks"], "scores": props["scores"], "keep": nms["keep"],
                "similarity": dec["similarity"], "mask_logits": dec["mask_logits"]}
