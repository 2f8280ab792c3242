"""GeoFormerFS: episodic few-shot model (port of
geoformer_tpu/models/geoformer_fs.py).

Adds to the supervised model:
  * process_support: backbone over the support scene, masked aggregation
    (npoint=32, avg pooling), mean -> a 2m support embedding
  * support/query fusion: aggregation tensor [ctx*sup, ctx-sup, ctx]
  * similarity_net scoring the first Q contexts
  * no classification head; proposals gated by similarity instead

``encode_scene`` is support-independent and cacheable; ``decode_with_support``
is the cheap per-support leg, which the test driver runs per class and run
against one cached scene. In training the decode predicts with every decoder
layer on a random fg subsample, and ``process_support`` still runs without a
gradient and with its modules in eval mode, as in the JAX model.

Data parallelism: as in models/geoformer.py, a rank holds its rows of the
global query and support batches; the similarity net's batch norms take
the global batch's statistics, and the subsample draws are the rank's rows
of the global batch's table (``draw_subsample``). Dropout draws per rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from geoformer_tpu_torch.models.blocks import GenericMLP, MaskedBatchNorm
from geoformer_tpu_torch.models.geoformer import (
    GeoFormerBase,
    ModelConfig,
    pack_by_mask,
    scatter_fg_masks,
)
from geoformer_tpu_torch.ops import gather_rows

SUPPORT_CAPACITY = 4096  # packed support-mask points fed to the aggregator
SUPPORT_NPOINT = 32      # FPS centers over the support instance


class SimilarityNet(nn.Module):
    """MLP(6m -> 6m BN ReLU -> 6m BN ReLU -> 1); layer names as flax
    auto-names them."""

    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(dim)
        self.Dense_2 = nn.Linear(dim, 1)

    def forward(self, x, mask):
        h = F.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask))
        h = F.relu(self.MaskedBatchNorm_1(self.Dense_1(h), mask))
        return self.Dense_2(h)[..., 0]


@contextlib.contextmanager
def _eval_mode(*modules: nn.Module):
    """The modules (and their children) in eval mode, their own modes back
    afterwards."""
    saved = [(m, m.training) for mod in modules for m in mod.modules()]
    for mod in modules:
        mod.eval()
    try:
        yield
    finally:
        for m, mode in saved:
            m.training = mode


class GeoFormerFS(GeoFormerBase):
    """Few-shot GeoFormer."""

    def __init__(self, mc: ModelConfig):
        super().__init__(mc)
        agg_dim = 2 * mc.m
        self.encoder_to_decoder_projection = GenericMLP(
            3 * agg_dim, (3 * agg_dim,), mc.dec_dim, norm="bn", output_use_activation=True,
            output_use_norm=True, output_use_bias=False)
        self.similarity_net = SimilarityNet(3 * agg_dim)

    def _pos_range(self, pc_mins, pc_maxs):
        """The few-shot reference passes the correct [pc_mins, pc_maxs] range,
        unlike the supervised model's flipped one (GeoFormerBase._pos_range)."""
        return pc_mins, pc_maxs

    # ---------------- support ----------------

    @torch.no_grad()
    def process_support(self, support_batch):
        """Support scene (with ``support_masks`` [B,P]) -> [B, 2m] embedding:
        the mean over the valid ones of 32 avg-pooled ball groups centered
        on the masked instance. No gradient, and eval mode in training too."""
        with _eval_mode(self.backbone, self.semantic, self.set_aggregator):
            return self._support_embedding(support_batch)

    def _support_embedding(self, support_batch):
        point_feats, _, _, _ = self.forward_backbone(support_batch)
        sup_mask = (support_batch["support_masks"] > 0) & support_batch["point_mask"]
        idx, valid = pack_by_mask(sup_mask, min(SUPPORT_CAPACITY, point_feats.shape[1]))
        locs = gather_rows(support_batch["points"], idx)
        feats = gather_rows(point_feats, idx)
        _, grouped, _, _, inds_valid, hit = self.set_aggregator.group(
            locs, feats, valid, SUPPORT_NPOINT)
        center_ok = hit.any(dim=-1) & inds_valid
        group_mask = center_ok[..., None].expand(grouped.shape[:-1])
        ctx = self.set_aggregator(grouped, group_mask, pooling="avg")  # [B,32,2m]
        m = center_ok.to(ctx.dtype)[..., None]
        return (ctx * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)

    # ---------------- scene encoding (cacheable) ----------------

    def encode_scene(self, scene_batch, train: bool = False,
                     generator: torch.Generator | None = None):
        point_feats, semantic_scores, semantic_preds, vox_stats = self.forward_backbone(
            scene_batch)
        fg_idx, fg_valid = self.foreground_pack(semantic_preds, scene_batch["point_mask"])
        fg_locs = gather_rows(scene_batch["points"], fg_idx)
        fg_feats = gather_rows(point_feats, fg_idx)
        mask_feats = self.run_mask_tower(fg_feats, fg_valid)
        context_locs, context_feats, context_inds, context_valid = self.forward_aggregator(
            fg_locs, fg_feats, fg_valid, train, generator)
        geo_dist, graph_ovf, graph_wovf = self.forward_geodesic(
            fg_locs, fg_valid, context_inds, context_valid, train)
        return {
            "semantic_scores": semantic_scores,
            "voxel_stats": dict(vox_stats, n_radius_cell_overflow=graph_ovf,
                                n_radius_window_overflow=graph_wovf),
            "fg_idx": fg_idx,
            "fg_valid": fg_valid,
            "fg_locs": fg_locs,
            "mask_feats": mask_feats,
            "context_locs": context_locs,
            "context_feats": context_feats,
            "context_inds": context_inds,
            "context_valid": context_valid,
            "geo_dist": geo_dist,
        }

    # ---------------- fused decode ----------------

    def decode_with_support(self, cache, support_embeddings, pc_mins, pc_maxs,
                            train: bool = False, generator: torch.Generator | None = None):
        """cache from ``encode_scene``, support_embeddings [B,2m] ->
        mask_logits [L,B,Q,F] (every decoder layer on a random fg subsample
        in training, the last layer on every fg slot at eval), similarity
        [B,Q] logits, and fg_idx, fg_valid (of the mask head's fg slots),
        query_valid."""
        q = self.mc.n_query_points
        ctx = cache["context_feats"]  # [B,K,2m]
        sup = support_embeddings[:, None, :]  # [B,1,2m]
        aggregation = torch.cat([ctx * sup, ctx - sup, ctx], dim=-1)  # [B,K,6m]
        dec_outputs, query_locs, query_valid = self.run_decoder(
            self.encoder_to_decoder_projection, cache["context_locs"], aggregation,
            cache["context_valid"], cache["geo_dist"], cache["context_inds"], pc_mins, pc_maxs)
        similarity = self._detach_if_fixed("similarity_net",
                                           self.similarity_net(aggregation[:, :q], query_valid))
        _, mask_logits, sub_idx, fg_valid = self.layer_predictions(
            None, dec_outputs, cache["geo_dist"], cache["mask_feats"], cache["fg_locs"],
            cache["fg_valid"], query_locs, query_valid, train, generator)
        fg_idx = cache["fg_idx"] if sub_idx is None else torch.gather(cache["fg_idx"], 1, sub_idx)
        return {
            "mask_logits": mask_logits,
            "similarity": similarity,
            "fg_idx": fg_idx,
            "fg_valid": fg_valid,
            "query_valid": query_valid,
        }

    def proposals(self, dec, point_mask):
        """Proposals of one decode at the config's thresholds."""
        mc = self.mc
        return generate_fs_proposal(
            dec["mask_logits"][-1], torch.sigmoid(dec["similarity"]), dec["fg_idx"],
            dec["fg_valid"], point_mask, logit_thresh=0.2,
            score_thresh=mc.test_score_thresh, npoint_thresh=mc.test_npoint_thresh,
            sim_score_thresh=mc.similarity_thresh)

    def forward(self, support_batch, scene_batch, train: bool = False,
                support_embeddings=None, generator: torch.Generator | None = None):
        """Encode the scene, embed the support (unless given), decode, and at
        eval the proposals. ``train`` must match the model's mode."""
        self._check_mode(train)
        cache = self.encode_scene(scene_batch, train, generator)
        outputs = {"semantic_scores": cache["semantic_scores"],
                   "voxel_stats": cache["voxel_stats"]}
        if support_embeddings is None:
            support_embeddings = self.process_support(support_batch)
        dec = self.decode_with_support(cache, support_embeddings, scene_batch["pc_mins"],
                                       scene_batch["pc_maxs"], train, generator)
        outputs.update(dec)
        if not train:
            outputs["proposals"] = self.proposals(dec, scene_batch["point_mask"])
        return outputs


def generate_fs_proposal(mask_logits, similarity, fg_idx, fg_valid, point_mask,
                         logit_thresh=0.2, score_thresh=0.5, npoint_thresh=100,
                         sim_score_thresh=0.5):
    """Few-shot proposals: mask_logits [B,Q,F], similarity [B,Q] (after the
    sigmoid) -> masks [B,Q,P] bool, scores = mask_score * sqrt(similarity),
    keep gated on similarity, size and mask score."""
    probs = torch.sigmoid(mask_logits)
    mask_bool = (probs >= logit_thresh) & fg_valid[:, None, :]
    npoints = mask_bool.sum(dim=2)
    mask_scores = (probs * mask_bool).sum(dim=2) / (npoints + 1e-6)
    scores = mask_scores * torch.sqrt(similarity.clamp(min=0.0))
    keep = ((similarity >= sim_score_thresh) & (npoints >= npoint_thresh)
            & (mask_scores >= score_thresh))
    masks = scatter_fg_masks(mask_bool, fg_idx, point_mask.shape[1])
    return {"masks": masks, "scores": scores, "keep": keep}
