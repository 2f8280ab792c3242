"""GeoFormer, fully supervised (port of geoformer_tpu/models/geoformer.py:
ModelConfig, pack_by_mask, random_pack_by_mask, strided_pack_by_mask,
GeoFormerBase, GeoFormer, generate_proposal).

voxelize -> sparse U-Net -> semantic head -> fg packing -> mask tower ->
set aggregator (subsample + FPS + ball group) -> radius kNN + geodesic
(two-level, or exact in float32 or int16) -> Fourier embeddings ->
rel-attention decoder -> dynamic-conv mask head -> proposals (eval) or
every decoder layer's outputs on a random fg subsample (training).

Submodule names follow the JAX variable tree (``backbone``, ``semantic``,
``mask_tower{i}``, ``decoder/layer{i}/...``), so weights.from_jax_variables
maps one onto the other.

Training (``forward(batch, train=True)``, the model in ``train()`` mode):
the aggregator subsamples the foreground at random and the mask head runs
on a random ``train_subsample`` of it (``random_pack_by_mask``, drawn from
the caller's ``torch.Generator``). A module named in ``fix_modules`` (the
config's ``fix_module``) runs in eval mode, and its output is detached, as
the JAX model's ``train_for`` and ``stop_gradient`` do. The radius graph and
the geodesic solve take only data and run without a gradient; so do the
FPS (K2) and the k-smallest selection (K1), whose outputs are indices.

Data parallelism (parallel/mesh.py): a rank runs its own rows of the
global batch. Its batch norms take the global batch's statistics
(models/blocks.py), and its subsample draws are its rows of the global
batch's table (``draw_subsample``), so each scene packs as it does in a
single process. Dropout draws from the process's own generator, seeded
per rank by the drivers: statistically the same, not the same masks (the
equality checks run with dropout 0).

Model parallelism (the JAX ``model`` mesh axis, parallel/mesh.py): the
ranks of a model group hold the same scenes and run the backbone, the mask
tower, the aggregator (K2) and the radius graph (K1) alike; each then
solves the geodesic table's columns of its own queries
(``mesh.query_slice``, the ``_shard_solve`` counterpart; the table stays
[B, F, Q/M]) and runs the rel-pos embedding, the decoder and the mask head
on them. The decoder's self-attention gathers its [B, Q, d] keys and
values over the model group; at eval the last layer's class and mask
logits are gathered before the proposals, as the JAX eval all-gathers
them. The rel-pos fallback maximum spans the ranks that JAX's batch-wide
``jnp.max`` spans, the mask head's the scene's queries
(``all_reduce_max``).
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
from geoformer_tpu_torch.ops.geodesic import geodesic_distance, geodesic_distance_hier
from geoformer_tpu_torch.ops.radius_graph import radius_knn
from geoformer_tpu_torch.ops.sparse_conv import build_grid_plan, plan_stats, voxel_capacities
from geoformer_tpu_torch.ops.voxelize import devoxelize, voxel_mean_pool
from geoformer_tpu_torch.parallel.mesh import (
    all_gather_queries,
    all_reduce_max,
    data_rows,
    on_query_rows,
    query_slice,
)


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

    def is_fixed(self, name: str) -> bool:
        return name in self.fix_modules

    def train_for(self, name: str, train: bool) -> bool:
        return train and not self.is_fixed(name)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.bf16 else None

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


def draw_subsample(mask: torch.Tensor, capacity: int, generator: torch.Generator):
    """The random draws of ``random_pack_by_mask`` on mask [B,P]: one
    rotation offset in [0, n_valid) per scene [B] when capacity >= P, else
    uniform scores [B,P]. ``generator`` lives on mask's device.

    Under a data mesh (parallel/mesh.py) mask holds this rank's rows of the
    global batch: every rank draws the global batch's table from the same
    seed and keeps its own rows, so a scene's draws are those a single
    process draws for it."""
    b, p = mask.shape
    total, first = data_rows(b)
    rows = slice(first, first + b)
    if capacity >= p:
        n_valid = mask.sum(dim=1).clamp(min=1)
        u = torch.rand(total, generator=generator, device=mask.device)[rows]
        return torch.minimum((u * n_valid).long(), n_valid - 1)
    return torch.rand(total, p, generator=generator, device=mask.device)[rows]


def pack_from_draws(mask: torch.Tensor, capacity: int, draws: torch.Tensor):
    """random_pack_by_mask given its draws (``draw_subsample``). capacity >=
    P: the valid prefix rotated by the offset (P entries, the capacity
    clamped as the JAX slice clamps it); else the valid entries in the
    order of their scores (stable), the first ``capacity`` of them."""
    b, p = mask.shape
    if capacity >= p:
        n_valid = mask.sum(dim=1).clamp(min=1)[:, None]
        pos = torch.arange(p, device=mask.device)[None, :]
        idx = torch.where(pos < n_valid, (pos + draws[:, None]) % n_valid, pos)
    else:
        scores = torch.where(mask, draws, 2.0)
        idx = torch.argsort(scores, dim=1, stable=True)[:, :capacity]
    return idx, torch.gather(mask, 1, idx)


def random_pack_by_mask(mask: torch.Tensor, capacity: int, generator: torch.Generator):
    """Random subsample of the valid entries of a PACKED prefix mask [B,P]
    (the training path; eval uses strided_pack_by_mask) -> (idx [B,cap],
    valid [B,cap]). When capacity covers the whole array the subsample is
    the identity set and the shuffle a random rotation of the valid prefix,
    as in the JAX function."""
    return pack_from_draws(mask, capacity, draw_subsample(mask, capacity, generator))


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


class GeoFormerBase(nn.Module):
    """Submodules and stages shared by the supervised and the few-shot
    model (the JAX GeoFormerBase)."""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        self.mc = mc
        m = mc.m
        in_ch = mc.input_channel + (3 if mc.use_coords else 0)
        self.backbone = SparseUNetBackbone(in_ch, m, mc.depth, compute_dtype=mc.compute_dtype,
                                           remat=mc.remat)
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
        # sweeps of the last forward's solve, per scene: (coarse, fine) of the
        # two-level solver, or the exact solver's sweeps
        self.geodesic_passes = []
        # a dict to collect per-stage wall ms of the next forwards (each stage
        # ends in a device synchronize); None = off, no synchronizing
        self.stage_ms = None
        self._t = 0.0

    def train(self, mode: bool = True):
        """Training mode, with every fixed module (``ModelConfig.is_fixed``)
        in eval mode: running statistics, no dropout."""
        super().train(mode)
        if mode:
            for name, module in self.named_children():
                if self.mc.is_fixed(_FIX_NAME.get(name, name)):
                    module.eval()
        return self

    def _check_mode(self, train: bool) -> None:
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a model in "
                             f"{'training' if self.training else 'eval'} mode")

    def _detach_if_fixed(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x.detach() if self.mc.is_fixed(name) else x

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
        # the compact slot tables, as in JAX, only without bricks (bricks are
        # an exact layout of the 27-offset conv, which the rulebook computes)
        compact = mc.subm_k < 27 and not mc.brick_occupancy
        plan = build_grid_plan(batch["coords"], batch["point_mask"], mc.spatial, mc.depth, caps,
                               subm_k=mc.subm_k if compact else None)
        feats = batch["feats"]
        if mc.use_coords:
            feats = torch.cat([feats, batch["points"]], dim=-1)
        voxel_out = self.backbone(voxel_mean_pool(feats, plan.grids[0]), plan)
        point_feats = self._detach_if_fixed("backbone", devoxelize(voxel_out, plan.grids[0]))
        semantic_scores = self._detach_if_fixed(
            "semantic", self.semantic(point_feats, batch["point_mask"]))
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
        return self._detach_if_fixed("mask_tower", self.mask_out(x))

    # ---------------- aggregator ----------------

    def forward_aggregator(self, fg_locs, fg_feats, fg_valid, train: bool = False,
                           generator: torch.Generator | None = None):
        """Subsample of fg (random in training, strided at eval) -> FPS K
        centers -> ball group -> SharedMLP. Returns context_locs [B,K,3],
        context_feats [B,K,2m], context_inds [B,K] (into the fg arrays),
        context_valid [B,K]."""
        mc = self.mc
        if mc.train_for("set_aggregator", train):
            sub_idx, sub_valid = random_pack_by_mask(fg_valid, mc.n_downsampling, generator)
        else:
            sub_idx, sub_valid = strided_pack_by_mask(fg_valid, mc.n_downsampling)
        sub_locs = gather_rows(fg_locs, sub_idx)
        sub_feats = gather_rows(fg_feats, sub_idx)
        new_xyz, grouped, _, inds, inds_valid, hit = self.set_aggregator.group(
            sub_locs, sub_feats, sub_valid, mc.n_decode_point)
        center_ok = hit.any(dim=-1) & inds_valid
        group_mask = center_ok[..., None].expand(grouped.shape[:-1])
        context_feats = self._detach_if_fixed("set_aggregator",
                                              self.set_aggregator(grouped, group_mask))
        context_inds = torch.gather(sub_idx, 1, inds)
        return new_xyz, context_feats, context_inds, inds_valid

    # ---------------- geodesic ----------------

    @torch.no_grad()
    def forward_geodesic(self, fg_locs, fg_valid, context_inds, context_valid,
                         train: bool = False):
        """Radius-kNN graph + geodesic solve -> (geo [B,F,Qr],
        n_radius_cell_overflow [B], n_radius_window_overflow [B]): the
        two-level solver (``geodesic_hier``) or the exact one, in float32
        or int16 (``geodesic_int16``). Training takes
        ``geodesic_steps_train`` steps, eval ``geodesic_steps_eval``. The
        graph is built for the whole scene on every rank of a model group;
        the solve runs the seed columns of this rank's queries Qr
        (``query_slice``; all Q without a model axis): the columns are
        independent, so the table is the same columns of the one-process
        table."""
        mc = self.mc
        q = mc.n_query_points
        k_graph = mc.knn_neighbors
        if mc.geodesic_hier and mc.geodesic_fine_k:
            # the two-level solver reads only the nearest max(fine_k, k_sub)
            # slots and radius_knn packs ascending: a narrower table is
            # identical; the exact solver takes the whole table
            k_graph = min(k_graph, max(mc.geodesic_fine_k, mc.geodesic_k_sub))
        d2, nbr_i, graph_ovf, graph_wovf = radius_knn(
            fg_locs, fg_valid, mc.geodesic_radius, k_graph,
            cell_cap=mc.radius_cell_cap, cell_div=mc.radius_cell_div,
            window=mc.knn_window, cellwin=mc.knn_cellwin,
            dense_grid=mc.knn_dense_grid, select=mc.knn_select)
        self._stage("radius_graph")
        # edge lengths rounded once from a float64 root: PyTorch's vectorised
        # float32 sqrt on the CPU is 1 ulp off on ~0.6 % of inputs, where
        # XLA's and CUDA's are correctly rounded
        nbr_d = torch.sqrt(d2.clamp(max=4.0).clamp(min=0.0).double()).to(d2.dtype)
        rows = query_slice(q)
        seeds, seed_mask = context_inds[:, :q][:, rows], context_valid[:, :q][:, rows]
        steps = mc.geodesic_steps_train if train else mc.geodesic_steps_eval
        if mc.geodesic_hier:
            geo, self.geodesic_passes = geodesic_distance_hier(
                nbr_i, nbr_d, seeds, seed_mask, fg_valid, mc.geodesic_radius, steps, fg_locs,
                fine_sweeps=mc.geodesic_fine_sweeps, cell_factor=mc.geodesic_cell_factor,
                k_sub=mc.geodesic_k_sub, fine_k=mc.geodesic_fine_k or None,
                coarse_eps=mc.geodesic_coarse_eps)
        else:
            # no reverse edges: the radius-kNN graph is symmetric up to the
            # k cap, as the JAX model has it
            geo, self.geodesic_passes = geodesic_distance(
                nbr_i, nbr_d, seeds, seed_mask, fg_valid, mc.geodesic_radius, steps,
                symmetrize=False, positions=fg_locs, int16=mc.geodesic_int16)
        return geo, graph_ovf, graph_wovf

    # ---------------- decoder ----------------

    def _pos_range(self, pc_mins, pc_maxs):
        """REFERENCE QUIRK kept for checkpoint parity: the supervised model
        normalizes positions over the FLIPPED range [pc_maxs, pc_mins]."""
        return pc_maxs, pc_mins

    def rel_pos_tensor(self, query_locs, context_locs, geo_dist, context_inds, pc_mins,
                       pc_maxs):
        """Geodesic-guided relative position embedding: geo_dist [B,F,Qr]
        (this rank's query columns), query_locs [B,Qr,3] -> [B,Qr,K,dec_dim].
        A query that reaches no context point (an invalid query slot) takes
        the largest maximum of every query of the batch, as JAX's
        ``jnp.max`` over the whole [B, Q] does under SPMD: over every rank
        of the ambient mesh."""
        b, k, _ = context_locs.shape
        q = query_locs.shape[1]
        rel = (query_locs[:, :, None, :] - context_locs[:, None, :, :]).abs()  # [B,Q,K,3]
        geo_ctx = gather_rows(geo_dist, context_inds).transpose(1, 2)  # [B,Q,K]
        max_geo = geo_ctx.amax(dim=2)
        fallback = all_reduce_max(max_geo.amax(), "all", site="rel_pos_max")
        max_geo = torch.where(max_geo < 0, fallback, max_geo)
        geo3 = geo_ctx[..., None].expand(b, q, k, 3)
        geo3 = torch.where(geo3 < 0, max_geo[:, :, None, None] + rel, geo3)
        ra, rb = self._pos_range(pc_mins, pc_maxs)
        return self.pos_embedding(geo3.reshape(b, q * k, 3), ra, rb).reshape(b, q, k, -1)

    def run_decoder(self, enc2dec, context_locs, context_feats, context_valid, geo_dist,
                    context_inds, pc_mins, pc_maxs):
        """``enc2dec`` is the model's own encoder_to_decoder_projection (2m
        wide in the supervised model, 6m in the few-shot one). -> decoder
        outputs [L,B,Qr,d] and query_locs [B,Qr,3] of this rank's queries,
        query_valid [B,Q] of all of them."""
        q = self.mc.n_query_points
        rows = query_slice(q)
        ctx_feats = self._detach_if_fixed("encoder_to_decoder_projection",
                                          enc2dec(context_feats, context_valid))
        query_locs = context_locs[:, :q][:, rows]
        query_valid = context_valid[:, :q]
        ra, rb = self._pos_range(pc_mins, pc_maxs)
        rel_pos = self.rel_pos_tensor(query_locs, context_locs, geo_dist, context_inds,
                                      pc_mins, pc_maxs)
        with on_query_rows(q):
            query_pos = self.query_projection(self.pos_embedding(query_locs, ra, rb),
                                              query_valid[:, rows])
            dec_outputs = self._detach_if_fixed("decoder", self.decoder(
                ctx_feats[:, :q][:, rows], ctx_feats, query_pos, rel_pos, query_valid,
                context_valid))
        return dec_outputs, query_locs, query_valid

    # ---------------- mask head ----------------

    def get_mask_prediction(self, sem_head, x, geo_dist, mask_feats, fg_locs, fg_valid,
                            query_locs, query_valid):
        """One decoder layer's output x [B,Qr,d] (this rank's rows of the
        query_valid [B,Q] queries; geo_dist [B,F,Qr], query_locs [B,Qr,3])
        -> cls logits [B,Qr,classes] (None without a ``sem_head``),
        dynamic-conv mask logits [B,Qr,F] (-1e4 at pad fg slots). The mask
        head's fallback is the scene's maximum over all Q queries."""
        q = query_valid.shape[1]
        valid = query_valid[:, query_slice(q)]
        with on_query_rows(q):
            cls_logits = sem_head(x, valid) if sem_head is not None else None
            params = self._detach_if_fixed("controller", self.controller_head(x, valid))
        w1, b1, w2, b2 = parse_dynamic_params(params, self.mc.m, use_coords=True)
        scene_max = all_reduce_max(geo_dist.amax(dim=(1, 2)), "model", site="mask_head_max")
        mask_logits = torch.stack([
            mask_heads_forward(geo_dist[i], mask_feats[i], w1[i], b1[i], w2[i], b2[i],
                               fg_locs[i], query_locs[i], compute_dtype=self.mc.compute_dtype,
                               scene_max=scene_max[i])
            for i in range(x.shape[0])])
        mask_logits = torch.where(fg_valid[:, None, :], mask_logits, -1e4)
        return cls_logits, mask_logits

    def layer_predictions(self, sem_head, dec_outputs, geo_dist, mask_feats, fg_locs,
                          fg_valid, query_locs, query_valid, train: bool,
                          generator: torch.Generator | None):
        """Training: every decoder layer's predictions on a random
        ``train_subsample`` of the fg slots -> (cls_logits [L,B,Qr,C] or
        None, mask_logits [L,B,Qr,S], sub_idx [B,S], sub_valid [B,S]) of
        this rank's queries. Eval: the last layer's on every fg slot
        (sub_idx None), of all Q queries (gathered over the model group)."""
        sub_idx = None
        if train:
            sub_idx, fg_valid = random_pack_by_mask(fg_valid, self.mc.train_subsample, generator)
            mask_feats = gather_rows(mask_feats, sub_idx)
            fg_locs = gather_rows(fg_locs, sub_idx)
            geo_dist = gather_rows(geo_dist, sub_idx)
        else:
            dec_outputs = dec_outputs[-1:]
        cls, masks = zip(*(self.get_mask_prediction(sem_head, x, geo_dist, mask_feats, fg_locs,
                                                    fg_valid, query_locs, query_valid)
                           for x in dec_outputs))
        cls_logits = torch.stack(cls) if sem_head is not None else None
        masks = torch.stack(masks)
        if not train:
            q = query_valid.shape[1]
            masks = all_gather_queries(masks, q, dim=2, site="eval_mask_logits")
            if cls_logits is not None:
                cls_logits = all_gather_queries(cls_logits, q, dim=2, site="eval_cls_logits")
        return cls_logits, masks, sub_idx, fg_valid


# child module name -> the name ModelConfig.is_fixed knows it by (the JAX
# model's train_for names); detr_sem_head is never fixed there
_FIX_NAME = {"mask_tower0": "mask_tower", "mask_tower1": "mask_tower",
             "mask_tower2": "mask_tower", "mask_out": "mask_tower",
             "controller_head": "controller", "detr_sem_head": ""}


class GeoFormer(GeoFormerBase):
    """Fully-supervised GeoFormer."""

    def __init__(self, mc: ModelConfig):
        super().__init__(mc)
        self.encoder_to_decoder_projection = GenericMLP(
            2 * mc.m, (2 * mc.m,), mc.dec_dim, norm="bn", output_use_activation=True,
            output_use_norm=True, output_use_bias=False)
        self.detr_sem_head = GenericMLP(mc.dec_dim, (mc.dec_dim, mc.dec_dim), mc.classes,
                                        norm="bn")

    def forward(self, batch, train: bool = False, semantic_only: bool = False,
                generator: torch.Generator | None = None):
        """batch: points [B,P,3], feats [B,P,C], coords [B,P,3] int,
        point_mask [B,P], pc_mins/pc_maxs [B,3]. ``train`` must match the
        model's mode; ``semantic_only`` (the prepare phase) stops after the
        semantic head; ``generator`` draws the training subsamples. Outputs:
        semantic_scores, voxel_stats, fg_idx/fg_valid (of the mask head's fg
        slots), query_valid, cls_logits [L,B,Q,C] and mask_logits [L,B,Q,F]
        (L = every decoder layer in training, the last one at eval), and at
        eval the proposals."""
        self._check_mode(train)
        mc = self.mc
        outputs = {}
        self._stage(None)
        point_feats, semantic_scores, semantic_preds, vox_stats = self.forward_backbone(batch)
        outputs["semantic_scores"] = semantic_scores
        outputs["voxel_stats"] = vox_stats
        self._stage("backbone")
        if semantic_only:
            return outputs

        fg_idx, fg_valid = self.foreground_pack(semantic_preds, batch["point_mask"])
        fg_locs = gather_rows(batch["points"], fg_idx)
        fg_feats = gather_rows(point_feats, fg_idx)

        mask_feats = self.run_mask_tower(fg_feats, fg_valid)
        self._stage("foreground")
        context_locs, context_feats, context_inds, context_valid = self.forward_aggregator(
            fg_locs, fg_feats, fg_valid, train, generator)
        self._stage("aggregator")
        geo_dist, graph_ovf, graph_wovf = self.forward_geodesic(
            fg_locs, fg_valid, context_inds, context_valid, train)
        self._stage("geodesic")
        outputs["voxel_stats"] = dict(vox_stats, n_radius_cell_overflow=graph_ovf,
                                      n_radius_window_overflow=graph_wovf)

        dec_outputs, query_locs, query_valid = self.run_decoder(
            self.encoder_to_decoder_projection, context_locs, context_feats, context_valid,
            geo_dist, context_inds, batch["pc_mins"], batch["pc_maxs"])
        outputs["query_valid"] = query_valid
        self._stage("decoder")

        cls_logits, mask_logits, sub_idx, sub_valid = self.layer_predictions(
            self.detr_sem_head, dec_outputs, geo_dist, mask_feats, fg_locs, fg_valid,
            query_locs, query_valid, train, generator)
        self._stage("mask_head")
        outputs["cls_logits"], outputs["mask_logits"] = cls_logits, mask_logits
        if train:
            outputs["fg_idx"] = torch.gather(fg_idx, 1, sub_idx)
            outputs["fg_valid"] = sub_valid
            return outputs

        outputs["fg_idx"], outputs["fg_valid"] = fg_idx, fg_valid
        sem_fg = gather_rows(torch.softmax(semantic_scores, dim=-1), fg_idx)
        outputs["proposals"] = generate_proposal(
            mask_logits[-1], cls_logits[-1], fg_idx, fg_valid, sem_fg, batch["point_mask"],
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
    masks = scatter_fg_masks(mask_bool, fg_idx, p)
    return {"masks": masks, "scores": scores, "classes": cls_pred, "keep": keep}


def scatter_fg_masks(mask_bool, fg_idx, p: int):
    """mask_bool [B,Q,F] over the packed fg slots -> [B,Q,P] at point
    resolution. fg_idx [B,F] is a prefix of a permutation of [0, P), so the
    scatter indices are unique and in bounds (the JAX code's p + 1 sink
    column is never reached)."""
    b, q, _ = mask_bool.shape
    masks = torch.zeros(b, q, p, dtype=torch.bool, device=mask_bool.device)
    bidx = torch.arange(b, device=masks.device)[:, None, None]
    qidx = torch.arange(q, device=masks.device)[None, :, None]
    masks[bidx, qidx, fg_idx[:, None, :]] = mask_bool
    return masks
