"""Flat config (port of geoformer_tpu/utils/config.py: defaults + load_config).

A copy, not an import: the port does not import the JAX package. ``yaml`` is
imported only inside the file reader, so a caller that builds its config
from Python values (``chip_smoke.py``, ``scannet_eval_config``) needs no
PyYAML.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

_DEFAULTS = dict(
    # GENERAL
    task="train",
    manual_seed=123,
    # META
    train_fold=0,
    cvfold=0,
    k_shot=1,
    similarity_thresh=0.5,
    fix_support=False,
    negative_ratio=2,
    run_num=10,
    type_support="fullscene_fold",
    file_support="support_vectors_df",
    test_model="geoformer",
    test_fold=0,
    # DETR
    dec_nlayers=4,
    dec_dim=64,
    dec_ffn_dim=64,
    dec_dropout=0.1,
    dec_nhead=4,
    use_rel=True,
    n_downsampling=50000,
    n_decode_point=2048,
    n_query_points=128,
    filter_biases_wd=False,
    base_lr=0.0005,
    warm_lr=1e-6,
    warm_lr_epochs=3,
    final_lr=1e-6,
    lr_scheduler="cosine",
    # DATA
    data_root="data",
    dataset="scannetv2",
    filename_suffix=".npy",
    classes=13,
    ignore_label=-100,
    input_channel=3,
    scale=50,
    batch_size=4,
    full_scale=[128, 512],
    full_scale_support=[32, 64],
    max_npoint=250000,
    mode=4,
    # STRUCTURE
    model_name="geoformer",
    m=16,
    block_residual=True,
    block_reps=2,
    use_coords=True,
    # TRAIN
    start_epoch=1,
    prepare_epochs=120,
    epochs=500,
    num_workers=0,
    optim="Adam",
    lr=0.001,
    step_epoch=384,
    multiplier=0.5,
    momentum=0.9,
    weight_decay=0.0001,
    save_freq=10,
    save_freq_last=2,
    grad_accum_steps=1,
    fix_module=[],
    loss_weight=[1.0, 1.0, 1.0, 1.0],
    loss_dice_weight=1.0,
    loss_focal_weight=1.0,
    loss_cls_weight=1.0,
    # TEST
    split="val",
    test_epoch=29999,
    test_workers=0,
    test_seed=567,
    test_batch_size=1,
    TEST_NMS_THRESH=0.3,
    TEST_SCORE_THRESH=0.1,
    TEST_NPOINT_THRESH=50,
    BENCHMARK_SEMANTIC_LABELS=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39],
    eval=True,
    save_semantic=False,
    save_pt_offsets=False,
    save_instance=False,
    save_cluster=False,
    save_fg=False,
    # static-shape capacities and solver knobs (the JAX package's TPU section;
    # the port keeps the names so one YAML drives both packages)
    tpu_bf16=False,
    tpu_remat=False,
    tpu_brick_fold_max_c=32,
    tpu_brick_fold_train=False,
    tpu_max_points=250000,
    tpu_max_voxels=131072,
    tpu_voxel_decay=0.5,
    tpu_max_fg_points=131072,
    tpu_train_subsample=30000,
    tpu_max_instances=64,
    tpu_knn_neighbors=64,
    tpu_radius_cell_cap=24,
    tpu_radius_cell_div=2,
    tpu_knn_window=0,
    tpu_knn_cellwin=False,
    tpu_knn_dense_grid=256,
    tpu_knn_select="pallas",
    tpu_device_matcher=True,
    tpu_brick_occupancy=32,
    tpu_ball_cell_cap=32,
    tpu_subm_k=27,
    tpu_geodesic_int16=False,
    tpu_geodesic_radius=0.05,
    tpu_geodesic_hier=True,
    tpu_geodesic_fine_sweeps=2,
    tpu_geodesic_fine_k=16,
    tpu_geodesic_k_sub=8,
    tpu_geodesic_cell_factor=2.0,
    tpu_geodesic_coarse_eps=0.0,
    tpu_geodesic_steps_train=32,
    tpu_geodesic_steps_eval=64,
    tpu_spatial_shape=1024,
    tpu_unet_depth=7,
    tpu_ball_radius=0.2,
    tpu_ball_nsample=64,
    tpu_compute_dtype="float32",
    # paths filled by CLI
    config=None,
    profile_dir=None,
    pretrain=None,
    resume=None,
    output_path="exp",
    exp_name="default",
)

# config/test_geoformer_scannet.yaml as Python values (every key the file
# sets, section by section), for callers without PyYAML
TEST_GEOFORMER_SCANNET = dict(
    # GENERAL
    task="train", manual_seed=123,
    # META
    train_fold=0, cvfold=0,
    # DETR
    dec_nlayers=4, dec_dim=64, dec_ffn_dim=64, dec_dropout=0.1, dec_nhead=4,
    n_downsampling=50000, n_decode_point=2048, n_query_points=256,
    base_lr=0.0005, warm_lr=0.000001, warm_lr_epochs=3, final_lr=0.000001,
    lr_scheduler="cosine",
    # DATA
    data_root="data", dataset="scannetv2", classes=13, ignore_label=-100,
    input_channel=3, scale=50, batch_size=1, full_scale=[128, 512],
    full_scale_support=[32, 64], max_npoint=250000, mode=4,
    # STRUCTURE
    model_name="geoformer", m=16, block_residual=True, block_reps=2, use_coords=True,
    # TRAIN
    start_epoch=0, prepare_epochs=120, epochs=500, num_workers=4, optim="Adam",
    lr=0.001, multiplier=0.5, momentum=0.9, weight_decay=0.0001, save_freq=10,
    save_freq_last=2, fix_module=[],
    # TEST
    split="val", test_seed=567, TEST_NMS_THRESH=0.3, TEST_SCORE_THRESH=0.5,
    TEST_NPOINT_THRESH=100, eval=True,
    # TPU
    tpu_max_points=250000, tpu_max_voxels=262144, tpu_max_fg_points=131072,
    tpu_train_subsample=30000, tpu_max_instances=64, tpu_knn_neighbors=64,
    tpu_geodesic_radius=0.05, tpu_geodesic_steps_train=32, tpu_geodesic_steps_eval=64,
    tpu_brick_occupancy=64, tpu_spatial_shape=1024, tpu_unet_depth=7,
    tpu_ball_radius=0.2, tpu_ball_nsample=64,
)


class Config(SimpleNamespace):
    """Flat config namespace; attribute access like the reference's cfg."""

    def replace(self, **kw) -> "Config":
        new = copy.deepcopy(vars(self))
        new.update(kw)
        return Config(**new)

    def to_dict(self) -> dict:
        return dict(vars(self))


def load_config(yaml_path: str | None = None, **overrides) -> Config:
    """Build a Config from defaults <- YAML sections <- overrides."""
    merged = copy.deepcopy(_DEFAULTS)
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
        for _section, kv in raw.items():
            if isinstance(kv, dict):
                merged.update(kv)
    merged.update(overrides)
    merged["config"] = yaml_path
    return Config(**merged)


def scannet_eval_config(**overrides) -> Config:
    """config/test_geoformer_scannet.yaml built from Python values."""
    return load_config(None, **{**copy.deepcopy(TEST_GEOFORMER_SCANNET), **overrides})
