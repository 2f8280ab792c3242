"""GeoFormer, fully supervised, eval forward (port of
geoformer_tpu/models/geoformer.py: ModelConfig, pack_by_mask,
strided_pack_by_mask, GeoFormer eval, generate_proposal).

voxelize -> sparse U-Net -> semantic head -> fg packing -> mask tower ->
set aggregator (strided subsample + FPS + ball group) -> radius kNN +
two-level geodesic -> Fourier embeddings -> rel-attention decoder ->
dynamic-conv mask head -> proposals.

Submodule names follow the JAX variable tree (``backbone``, ``semantic``,
``mask_tower{i}``, ``decoder/layer{i}/...``), so weights.from_jax_variables
maps one onto the other. Training branches (random subsampling, the
per-layer outputs for the loss) wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch import nn

from geoformer_tpu_torch.models.aggregator import SetAggregator
from geoformer_tpu_torch.models.blocks import GenericMLP, MLPConvBlock
from geoformer_tpu_torch.models.decoder import TransformerDecoder
from geoformer_tpu_torch.models.dynamic_conv import (
    Controller,
    dynamic_param_sizes,
    mask_heads_forward,
    parse_dynamic_params,
)
from geoformer_tpu_torch.models.pos_embedding import PositionEmbeddingCoordsFourier
from geoformer_tpu_torch.models.unet import SemanticHead, SparseUNetBackbone
from geoformer_tpu_torch.ops import gather_rows
from geoformer_tpu_torch.ops.geodesic import geodesic_distance_hier
from geoformer_tpu_torch.ops.radius_graph import radius_knn
from geoformer_tpu_torch.ops.sparse_conv import build_grid_plan, plan_stats, voxel_capacities
from geoformer_tpu_torch.ops.voxelize import devoxelize, voxel_mean_pool


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model settings (the JAX ModelConfig, same fields and defaults)."""

    m: int = 16
    classes: int = 13
    input_channel: int = 3
    use_coords: bool = True
    train_fold: int = 0
    cvfold: int = 0
    dec_nlayers: int = 4
    dec_dim: int = 64
    dec_ffn_dim: int = 64
    dec_nhead: int = 4
    dec_dropout: float = 0.1
    n_decode_point: int = 2048
    n_query_points: int = 128
    n_downsampling: int = 50000
    spatial: int = 1024
    depth: int = 7
    max_voxels: int = 131072
    voxel_decay: float = 0.5
    max_fg_points: int = 131072
    train_subsample: int = 30000
    knn_neighbors: int = 64
    geodesic_radius: float = 0.05
    radius_cell_cap: int = 24
    radius_cell_div: int = 2
    geodesic_int16: bool = False
    geodesic_steps_train: int = 32
    geodesic_steps_eval: int = 64
    geodesic_hier: bool = True
    geodesic_fine_sweeps: int = 2
    geodesic_fine_k: int = 16
    geodesic_k_sub: int = 8
    geodesic_cell_factor: float = 2.0
    geodesic_coarse_eps: float = 0.0
    ball_radius: float = 0.2
    ball_cell_cap: int = 32
    knn_window: int = 0
    knn_cellwin: bool = False
    knn_dense_grid: int = 256
    knn_select: str = "pallas"
    ball_nsample: int = 64
    test_score_thresh: float = 0.1
    test_npoint_thresh: int = 50
    similarity_thresh: float = 0.5
    subm_k: int = 27
    brick_occupancy: int = 32
    bf16: bool = False
    remat: bool = False
    brick_fold_max_c: int = 32
    brick_fold_train: bool = False
    fix_modules: tuple = ()

    @classmethod
    def from_cfg(cls, cfg):
        fix = tuple(cfg.fix_module)
        if "unet" in fix:
            fix = fix + ("backbone",)
        if "semantic_linear" in fix or "semantic" in fix:
            fix = fix + ("semantic",)
        return cls(
            fix_modules=fix,
            similarity_thresh=cfg.similarity_thresh,
            m=cfg.m,
            classes=cfg.classes,
            input_channel=cfg.input_channel,
            use_coords=cfg.use_coords,
            train_fold=cfg.train_fold,
            cvfold=cfg.cvfold,
            dec_nlayers=cfg.dec_nlayers,
            dec_dim=cfg.dec_dim,
            dec_ffn_dim=cfg.dec_ffn_dim,
            dec_nhead=cfg.dec_nhead,
            dec_dropout=cfg.dec_dropout,
            n_decode_point=cfg.n_decode_point,
            n_query_points=cfg.n_query_points,
            n_downsampling=cfg.n_downsampling,
            spatial=cfg.tpu_spatial_shape,
            depth=cfg.tpu_unet_depth,
            max_voxels=cfg.tpu_max_voxels,
            voxel_decay=cfg.tpu_voxel_decay,
            max_fg_points=cfg.tpu_max_fg_points,
            train_subsample=cfg.tpu_train_subsample,
            knn_neighbors=cfg.tpu_knn_neighbors,
            radius_cell_cap=cfg.tpu_radius_cell_cap,
            radius_cell_div=cfg.tpu_radius_cell_div,
            geodesic_int16=cfg.tpu_geodesic_int16,
            geodesic_radius=cfg.tpu_geodesic_radius,
            geodesic_steps_train=cfg.tpu_geodesic_steps_train,
            geodesic_steps_eval=cfg.tpu_geodesic_steps_eval,
            geodesic_hier=cfg.tpu_geodesic_hier,
            geodesic_fine_sweeps=cfg.tpu_geodesic_fine_sweeps,
            geodesic_fine_k=cfg.tpu_geodesic_fine_k,
            geodesic_k_sub=cfg.tpu_geodesic_k_sub,
            geodesic_cell_factor=cfg.tpu_geodesic_cell_factor,
            geodesic_coarse_eps=cfg.tpu_geodesic_coarse_eps,
            ball_radius=cfg.tpu_ball_radius,
            ball_nsample=cfg.tpu_ball_nsample,
            ball_cell_cap=cfg.tpu_ball_cell_cap,
            knn_window=cfg.tpu_knn_window,
            knn_cellwin=cfg.tpu_knn_cellwin,
            knn_dense_grid=cfg.tpu_knn_dense_grid,
            knn_select=cfg.tpu_knn_select,
            test_score_thresh=cfg.TEST_SCORE_THRESH,
            test_npoint_thresh=cfg.TEST_NPOINT_THRESH,
            subm_k=cfg.tpu_subm_k,
            brick_occupancy=cfg.tpu_brick_occupancy,
            bf16=cfg.tpu_bf16 or cfg.tpu_compute_dtype == "bfloat16",
            remat=cfg.tpu_remat,
            brick_fold_max_c=cfg.tpu_brick_fold_max_c,
            brick_fold_train=cfg.tpu_brick_fold_train,
        )


def pack_by_mask(mask: torch.Tensor, capacity: int):
    """Pack valid entries to the front (stable): [B,P] -> (idx [B,cap],
    valid [B,cap])."""
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    idx = order[:, :capacity]
    return idx, torch.gather(mask, 1, idx)


def strided_pack_by_mask(mask: torch.Tensor, capacity: int):
    """Deterministic uniform subsample of a PACKED prefix mask [B,P]: every
    (n/capacity)-th entry when the n valid entries exceed capacity, else
    the identity prefix. f32 index arithmetic, as in the JAX module."""
    n = mask.sum(dim=1)  # [B]
    i = torch.arange(capacity, device=mask.device)
    step = n.to(torch.float32) / float(capacity)
    strided = torch.floor(i[None, :].to(torch.float32) * step[:, None]).long()
    lim = (n - 1).clamp(min=0)[:, None]
    idx = torch.where((n > capacity)[:, None],
                      torch.minimum(strided.clamp(min=0), lim), i[None, :])
    idx = idx.clamp(max=mask.shape[1] - 1)
    return idx, i[None, :] < n.clamp(max=capacity)[:, None]


class GeoFormer(nn.Module):
    """Fully-supervised GeoFormer, eval forward."""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        self.mc = mc
        m = mc.m
        in_ch = mc.input_channel + (3 if mc.use_coords else 0)
        self.backbone = SparseUNetBackbone(in_ch, m, mc.depth)
        self.semantic = SemanticHead(m, mc.classes)
        for i in range(3):
            self.add_module(f"mask_tower{i}", MLPConvBlock(m, m))
        self.mask_out = nn.Linear(m, m)
        agg_dim = 2 * m
        self.set_aggregator = SetAggregator(m, (agg_dim, agg_dim, agg_dim),
                                            radius=mc.ball_radius, nsample=mc.ball_nsample,
                                            ball_cell_cap=mc.ball_cell_cap)
        self.pos_embedding = PositionEmbeddingCoordsFourier(mc.dec_dim)
        self.query_projection = GenericMLP(mc.dec_dim, (mc.dec_dim,), mc.dec_dim,
                                           hidden_use_bias=True, output_use_activation=True)
        self.decoder = TransformerDecoder(mc.dec_nlayers, mc.dec_dim, mc.dec_nhead,
                                          mc.dec_ffn_dim, mc.dec_dropout)
        _, _, num_gen = dynamic_param_sizes(m, use_coords=True)
        self.controller_head = Controller(mc.dec_dim, m, num_gen)
        self.encoder_to_decoder_projection = GenericMLP(
            agg_dim, (2 * m,), mc.dec_dim, norm="bn", output_use_activation=True,
            output_use_norm=True, output_use_bias=False)
        self.detr_sem_head = GenericMLP(mc.dec_dim, (mc.dec_dim, mc.dec_dim), mc.classes,
                                        norm="bn")
        self.geodesic_passes = []  # (coarse sweeps, fine sweeps) per scene, last forward
        # a dict to collect per-stage wall ms of the next forwards (each stage
        # ends in a device synchronize); None = off, no synchronizing
        self.stage_ms = None
        self._t = 0.0

    def _stage(self, name: str | None) -> None:
        """Close the running stage as ``name`` (None: start the clock)."""
        if self.stage_ms is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        if name is not None:
            self.stage_ms[name] = (t - self._t) * 1e3
        self._t = t

    # ---------------- backbone ----------------

    def forward_backbone(self, batch):
        mc = self.mc
        caps = voxel_capacities(mc.max_voxels, mc.depth, mc.voxel_decay)
        plan = build_grid_plan(batch["coords"], batch["point_mask"], mc.spatial, mc.depth, caps)
        feats = batch["feats"]
        if mc.use_coords:
            feats = torch.cat([feats, batch["points"]], dim=-1)
        voxel_out = self.backbone(voxel_mean_pool(feats, plan.grids[0]), plan)
        point_feats = devoxelize(voxel_out, plan.grids[0])
        semantic_scores = self.semantic(point_feats, batch["point_mask"])
        semantic_preds = torch.where(batch["point_mask"], semantic_scores.argmax(dim=-1), -1)
        return point_feats, semantic_scores, semantic_preds, plan_stats(plan)

    def foreground_pack(self, semantic_preds, point_mask):
        mc = self.mc
        if mc.train_fold == mc.cvfold:
            fg_cond = semantic_preds >= 4
        else:
            fg_cond = semantic_preds == 3
        return pack_by_mask(fg_cond & point_mask, mc.max_fg_points)

    def run_mask_tower(self, fg_feats, fg_valid):
        x = fg_feats
        for i in range(3):
            x = getattr(self, f"mask_tower{i}")(x, fg_valid)
        return self.mask_out(x)

    # ---------------- aggregator ----------------

    def forward_aggregator(self, fg_locs, fg_feats, fg_valid):
        """Strided subsample of fg -> FPS K centers -> ball group -> SharedMLP.
        Returns context_locs [B,K,3], context_feats [B,K,2m], context_inds
        [B,K] (into the fg arrays), context_valid [B,K]."""
        mc = self.mc
        sub_idx, sub_valid = strided_pack_by_mask(fg_valid, mc.n_downsampling)
        sub_locs = gather_rows(fg_locs, sub_idx)
        sub_feats = gather_rows(fg_feats, sub_idx)
        new_xyz, grouped, _, inds, inds_valid, hit = self.set_aggregator.group(
            sub_locs, sub_feats, sub_valid, mc.n_decode_point)
        center_ok = hit.any(dim=-1) & inds_valid
        group_mask = center_ok[..., None].expand(grouped.shape[:-1])
        context_feats = self.set_aggregator(grouped, group_mask)
        context_inds = torch.gather(sub_idx, 1, inds)
        return new_xyz, context_feats, context_inds, inds_valid

    # ---------------- geodesic ----------------

    def forward_geodesic(self, fg_locs, fg_valid, context_inds, context_valid):
        """Radius-kNN graph + two-level geodesic solve -> (geo [B,F,Q],
        n_radius_cell_overflow [B], n_radius_window_overflow [B])."""
        mc = self.mc
        if not mc.geodesic_hier:
            raise NotImplementedError("only the hierarchical geodesic solver is ported")
        q = mc.n_query_points
        k_graph = mc.knn_neighbors
        if mc.geodesic_fine_k:
            # the solver reads only the nearest max(fine_k, k_sub) slots and
            # radius_knn packs ascending: a narrower table is identical
            k_graph = min(k_graph, max(mc.geodesic_fine_k, mc.geodesic_k_sub))
        d2, nbr_i, graph_ovf, graph_wovf = radius_knn(
            fg_locs, fg_valid, mc.geodesic_radius, k_graph,
            cell_cap=mc.radius_cell_cap, cell_div=mc.radius_cell_div,
            window=mc.knn_window, cellwin=mc.knn_cellwin,
            dense_grid=mc.knn_dense_grid, select=mc.knn_select)
        self._stage("radius_graph")
        nbr_d = torch.sqrt(d2.clamp(max=4.0).clamp(min=0.0))
        geo, self.geodesic_passes = geodesic_distance_hier(
            nbr_i, nbr_d, context_inds[:, :q], context_valid[:, :q], fg_valid,
            mc.geodesic_radius, mc.geodesic_steps_eval, fg_locs,
            fine_sweeps=mc.geodesic_fine_sweeps, cell_factor=mc.geodesic_cell_factor,
            k_sub=mc.geodesic_k_sub, fine_k=mc.geodesic_fine_k or None,
            coarse_eps=mc.geodesic_coarse_eps)
        return geo, graph_ovf, graph_wovf

    # ---------------- decoder ----------------

    def _pos_range(self, pc_mins, pc_maxs):
        """REFERENCE QUIRK kept for checkpoint parity: the supervised model
        normalizes positions over the FLIPPED range [pc_maxs, pc_mins]."""
        return pc_maxs, pc_mins

    def rel_pos_tensor(self, query_locs, context_locs, geo_dist, context_inds, pc_mins,
                       pc_maxs):
        """Geodesic-guided relative position embedding: geo_dist [B,F,Q] ->
        [B,Q,K,dec_dim]."""
        b, k, _ = context_locs.shape
        q = query_locs.shape[1]
        rel = (query_locs[:, :, None, :] - context_locs[:, None, :, :]).abs()  # [B,Q,K,3]
        geo_ctx = gather_rows(geo_dist, context_inds).transpose(1, 2)  # [B,Q,K]
        max_geo = geo_ctx.amax(dim=2)
        max_geo = torch.where(max_geo < 0, max_geo.amax(), max_geo)  # batch-global fallback
        geo3 = geo_ctx[..., None].expand(b, q, k, 3)
        geo3 = torch.where(geo3 < 0, max_geo[:, :, None, None] + rel, geo3)
        ra, rb = self._pos_range(pc_mins, pc_maxs)
        return self.pos_embedding(geo3.reshape(b, q * k, 3), ra, rb).reshape(b, q, k, -1)

    def run_decoder(self, context_locs, context_feats, context_valid, geo_dist, context_inds,
                    pc_mins, pc_maxs):
        q = self.mc.n_query_points
        ctx_feats = self.encoder_to_decoder_projection(context_feats, context_valid)
        query_locs = context_locs[:, :q]
        query_valid = context_valid[:, :q]
        ra, rb = self._pos_range(pc_mins, pc_maxs)
        query_pos = self.query_projection(self.pos_embedding(query_locs, ra, rb), query_valid)
        rel_pos = self.rel_pos_tensor(query_locs, context_locs, geo_dist, context_inds,
                                      pc_mins, pc_maxs)
        dec_outputs = self.decoder(ctx_feats[:, :q], ctx_feats, query_pos, rel_pos,
                                   query_valid, context_valid)
        return dec_outputs, query_locs, query_valid

    # ---------------- mask head ----------------

    def get_mask_prediction(self, x, geo_dist, mask_feats, fg_locs, fg_valid, query_locs,
                            query_valid):
        """One decoder layer's output x [B,Q,d] -> cls logits [B,Q,classes],
        dynamic-conv mask logits [B,Q,F] (-1e4 at pad fg slots)."""
        cls_logits = self.detr_sem_head(x, query_valid)
        params = self.controller_head(x, query_valid)
        w1, b1, w2, b2 = parse_dynamic_params(params, self.mc.m, use_coords=True)
        mask_logits = torch.stack([
            mask_heads_forward(geo_dist[i], mask_feats[i], w1[i], b1[i], w2[i], b2[i],
                               fg_locs[i], query_locs[i])
            for i in range(x.shape[0])])
        mask_logits = torch.where(fg_valid[:, None, :], mask_logits, -1e4)
        return cls_logits, mask_logits

    def forward(self, batch):
        """Eval forward. batch: points [B,P,3], feats [B,P,C], coords
        [B,P,3] int, point_mask [B,P], pc_mins/pc_maxs [B,3]."""
        mc = self.mc
        outputs = {}
        self._stage(None)
        point_feats, semantic_scores, semantic_preds, vox_stats = self.forward_backbone(batch)
        outputs["semantic_scores"] = semantic_scores
        self._stage("backbone")

        fg_idx, fg_valid = self.foreground_pack(semantic_preds, batch["point_mask"])
        fg_locs = gather_rows(batch["points"], fg_idx)
        fg_feats = gather_rows(point_feats, fg_idx)
        outputs["fg_idx"], outputs["fg_valid"] = fg_idx, fg_valid

        mask_feats = self.run_mask_tower(fg_feats, fg_valid)
        self._stage("foreground")
        context_locs, context_feats, context_inds, context_valid = self.forward_aggregator(
            fg_locs, fg_feats, fg_valid)
        self._stage("aggregator")
        geo_dist, graph_ovf, graph_wovf = self.forward_geodesic(
            fg_locs, fg_valid, context_inds, context_valid)
        self._stage("geodesic")
        outputs["voxel_stats"] = dict(vox_stats, n_radius_cell_overflow=graph_ovf,
                                      n_radius_window_overflow=graph_wovf)

        dec_outputs, query_locs, query_valid = self.run_decoder(
            context_locs, context_feats, context_valid, geo_dist, context_inds,
            batch["pc_mins"], batch["pc_maxs"])
        outputs["query_valid"] = query_valid
        self._stage("decoder")

        cls_logits, mask_logits = self.get_mask_prediction(
            dec_outputs[-1], geo_dist, mask_feats, fg_locs, fg_valid, query_locs, query_valid)
        self._stage("mask_head")
        outputs["cls_logits"] = cls_logits[None]  # [1,B,Q,classes]
        outputs["mask_logits"] = mask_logits[None]  # [1,B,Q,F]

        sem_fg = gather_rows(torch.softmax(semantic_scores, dim=-1), fg_idx)
        outputs["proposals"] = generate_proposal(
            mask_logits, cls_logits, fg_idx, fg_valid, sem_fg, batch["point_mask"],
            logit_thresh=0.5, score_thresh=mc.test_score_thresh,
            npoint_thresh=mc.test_npoint_thresh)
        self._stage("proposals")
        return outputs


def generate_proposal(mask_logits, cls_logits, fg_idx, fg_valid, sem_scores_fg, point_mask,
                      logit_thresh=0.5, score_thresh=0.5, npoint_thresh=100):
    """Static-shape proposals: mask_logits [B,Q,F], cls_logits [B,Q,classes]
    -> dict of masks [B,Q,P] bool (scattered to point resolution), scores,
    classes and keep [B,Q]."""
    b, q, _ = mask_logits.shape
    p = point_mask.shape[1]
    probs = torch.sigmoid(mask_logits)
    cls_prob = torch.softmax(cls_logits, dim=-1)
    cls_pred = cls_logits.argmax(dim=-1)  # [B,Q]
    mask_bool = (probs >= logit_thresh) & fg_valid[:, None, :]
    npoints = mask_bool.sum(dim=2)
    mask_scores = (probs * mask_bool).sum(dim=2) / (npoints + 1e-6)
    cls_scores = torch.gather(cls_prob, 2, cls_pred[..., None])[..., 0]
    sem_q = torch.einsum("bqf,bfc->bqc", mask_bool.to(sem_scores_fg.dtype), sem_scores_fg) / (
        npoints[..., None] + 1e-6)
    sem_scores_q = torch.gather(sem_q, 2, cls_pred[..., None])[..., 0]
    scores = mask_scores * torch.sqrt(cls_scores) * sem_scores_q
    keep = (cls_pred >= 4) & (npoints >= npoint_thresh) & (mask_scores >= score_thresh)
    # fg_idx is a permutation prefix: the scatter indices are unique
    masks = torch.zeros(b, q, p, dtype=torch.bool, device=mask_logits.device)
    bidx = torch.arange(b, device=masks.device)[:, None, None]
    qidx = torch.arange(q, device=masks.device)[None, :, None]
    masks[bidx, qidx, fg_idx[:, None, :]] = mask_bool
    return {"masks": masks, "scores": scores, "classes": cls_pred, "keep": keep}
