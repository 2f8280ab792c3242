"""Per-scene inference throughput of the flagship model (counterpart of the
JAX package's bench.py).

    python3 -m geoformer_tpu_torch.cli.bench [--scale prod|full|half|small]
        [--batch N] [--select ARM] [--device cpu]

Prints ONE JSON line on stdout:
  {"metric": "scene_inference", "value": <scenes/s>, "unit": "scenes/sec",
   "vs_baseline": ..., "p50_latency_s": ..., "first_call_s": ...,
   "kernel_build_s": ..., "points": ..., "dropped_points": ...,
   "degradation_counters": {...}, "fg_points": ..., "device": ...,
   "power_limit_w": ..., ...}

The workload is bench.py's: the supervised eval forward
(``GeoFormer(batch, train=False)``: voxelize -> U-Net -> aggregator ->
kNN + geodesic -> decoder -> dynamic conv -> proposals; no matrix NMS) on
a synthetic ScanNet-scale batch (``synthetic.synthetic_batch``, seed 0)
that is moved to the device once, before timing, with the port's seeded
random weights (``weights.random_state_dict``, seed 0; not flax's init, so
the foreground, and with it the work, can differ from the JAX bench's:
``fg_points`` says how many points it is). ``--scale`` picks the
capacities of ``SCALES`` (bench.py's, copied); the default is ``full``, the
first scale of bench.py's chain.

Each forward draws from one ``torch.Generator`` on the device, seeded once,
and ends by reading to the host one scalar of its outputs and the five
capacity counters (``bench_scalar``, ``counters``): that read is the
synchronisation. The kernel library is built (``kernel_build_s``, on the
card only) before the first forward, which is timed alone
(``first_call_s``); then 8 forwards give the p50 and ``value`` = B / p50.
``dropped_points`` is the sum of the four hard counters (a point that lost
its voxel or its graph edges); the window counter is soft (non-nearest
kNN edges) and only reported. In place of bench.py's ``compile_s`` and
``compile_cache_dir_entries`` (XLA's compile and cache) the line has
``first_call_s`` and ``kernel_build_s``; ``device`` is the card's name and
``power_limit_w`` its limit (nvidia-smi). Every kernel's launch count over
the 9 forwards, and over the first alone, goes to stderr as one JSON line.

Runs on the card unless ``--device`` names another device; without a card
and without ``--device`` it raises. There is no CPU fallback and no retry at
a smaller scale: a failure exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from geoformer_tpu_torch import default_device, kernels
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.synthetic import synthetic_batch
from geoformer_tpu_torch.tools.profiling import card

# No measured reference baseline exists (BASELINE.md), so ``vs_baseline`` is
# null. DERIVED_REFERENCE_RATE is BASELINE.md's op-count reconstruction of
# the upstream PyTorch reference's per-scene eval rate on its own GPU
# (scenes/s), reported as ``vs_derived_bound``.
REFERENCE_SCENES_PER_SEC = None
DERIVED_REFERENCE_RATE = 1.0

SCALES = {
    # reference eval capacity (max_npoint=250000, scannetv2_inst.py:206-222)
    # at the SHIPPED production config's capacities
    # (config/geoformer_scannet.yaml TPU: spatial 1024, 262144 voxels —
    # a 250k-point scene at 2 cm needs ~250k voxel slots; the previous
    # 512/131072 prod scale silently dropped ~half the scene into the pad
    # voxel). Run via `python bench.py --scale prod`; the default fallback
    # chain starts at "full" so round-over-round headline numbers stay
    # comparable
    "prod": dict(
        n_decode_point=2048, n_query_points=256, n_downsampling=50000,
        tpu_max_points=250000, tpu_max_voxels=262144, tpu_max_fg_points=131072,
        tpu_knn_neighbors=64, tpu_geodesic_steps_eval=64, tpu_spatial_shape=1024,
        tpu_unet_depth=7, tpu_ball_nsample=64, tpu_brick_occupancy=64,
    ),
    # production-shaped eval scene (one chip)
    "full": dict(
        n_decode_point=2048, n_query_points=256, n_downsampling=50000,
        tpu_max_points=65536, tpu_max_voxels=65536, tpu_max_fg_points=32768,
        tpu_knn_neighbors=64, tpu_geodesic_steps_eval=64, tpu_spatial_shape=512,
        tpu_unet_depth=7, tpu_ball_nsample=64,
    ),
    "half": dict(
        n_decode_point=1024, n_query_points=128, n_downsampling=16384,
        tpu_max_points=32768, tpu_max_voxels=32768, tpu_max_fg_points=16384,
        tpu_knn_neighbors=32, tpu_geodesic_steps_eval=48, tpu_spatial_shape=512,
        tpu_unet_depth=7, tpu_ball_nsample=32,
    ),
    "small": dict(
        n_decode_point=256, n_query_points=64, n_downsampling=4096,
        tpu_max_points=8192, tpu_max_voxels=8192, tpu_max_fg_points=4096,
        tpu_knn_neighbors=16, tpu_geodesic_steps_eval=32, tpu_spatial_shape=512,
        tpu_unet_depth=5, tpu_ball_nsample=16,
    ),
}

# capacity honesty (bench.py): the first four are HARD drops (the point
# loses its voxel or its graph edges) and make up ``dropped_points``; the
# window counter is SOFT (the point keeps in-radius edges, possibly
# non-nearest) and is only reported
COUNTERS = (
    "n_overflow_points",         # points over the voxel capacity
    "n_oor_points",              # points outside the spatial grid
    "n_brick_overflow",          # voxels over the dense-brick occupancy (0: no bricks)
    "n_radius_cell_overflow",    # fg points dropped from the geodesic graph
    "n_radius_window_overflow",  # SOFT: non-nearest kNN edges
)
SOFT_COUNTER = "n_radius_window_overflow"
TIMED_FORWARDS = 8


def bench_config(scale: str, batch_size: int = 1, select: str | None = None):
    """bench.py's config: the defaults at ``SCALES[scale]``, 64 instances."""
    return load_config(None, batch_size=batch_size, tpu_max_instances=64,
                       **({"tpu_knn_select": select} if select else {}), **SCALES[scale])


def bench_scalar(outputs: dict) -> torch.Tensor:
    """The one scalar bench.py reads of a forward's outputs."""
    return outputs["proposals"]["scores"].sum() + outputs["semantic_scores"][:, :64].sum()


def counters(outputs: dict) -> torch.Tensor:
    """[5] int64: the ``COUNTERS`` of ``voxel_stats``, each summed over the
    batch."""
    stats = outputs["voxel_stats"]
    return torch.stack([stats[k].sum().long() for k in COUNTERS])


def measure(cfg, batch_size: int, device=None, scale: str | None = None,
            select: str | None = None) -> dict:
    """Time the eval forward at ``cfg`` (bench.py's ``measure``); print the
    result line on stdout and the kernels' launch counts on stderr, and
    return the result."""
    engine = Engine(cfg, device=device, seed=0)  # seeded random weights, eval mode
    model, dev = engine.model, engine.device
    batch = engine.to_device(synthetic_batch(cfg, batch_size, seed=0))
    generator = torch.Generator(device=dev).manual_seed(1)

    @torch.no_grad()
    def forward():
        out = model(batch, train=False, generator=generator)
        read = torch.cat([bench_scalar(out).double().view(1), counters(out).double()]).tolist()
        return out, read

    kernel_build_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kernels.lib()
        kernel_build_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, read = forward()
    first_call_s = time.perf_counter() - t0
    first_launches = kernels.launches()
    fg_points = int(out["fg_valid"].sum())
    del out
    counts = {k: int(v) for k, v in zip(COUNTERS, read[1:])}
    dropped_points = sum(v for k, v in counts.items() if k != SOFT_COUNTER)

    times = []
    for _ in range(TIMED_FORWARDS):
        t0 = time.perf_counter()
        forward()
        times.append(time.perf_counter() - t0)
    print(json.dumps({"launches": kernels.launches(), "first_call_launches": first_launches,
                      "forwards": TIMED_FORWARDS + 1}), file=sys.stderr, flush=True)

    p50 = float(np.median(times))
    scenes_per_sec = batch_size / p50
    result = {
        "metric": "scene_inference",
        "value": scenes_per_sec,
        "unit": "scenes/sec",
        "vs_baseline": (scenes_per_sec / REFERENCE_SCENES_PER_SEC
                        if REFERENCE_SCENES_PER_SEC else None),
        "baseline": "unmeasured (no measured reference rate; see BASELINE.md)",
        "vs_derived_bound": scenes_per_sec / DERIVED_REFERENCE_RATE,
        "p50_latency_s": p50,
        "batch_size": batch_size,
        "first_call_s": first_call_s,
        "kernel_build_s": kernel_build_s,
        "scale": scale,
        **({"knn_select": select} if select else {}),
        "points": int(cfg.tpu_max_points),
        "dropped_points": dropped_points,
        "degradation_counters": counts,
        "fg_points": fg_points,
        **card(dev),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=tuple(SCALES), default="full")
    ap.add_argument("--batch", type=int, default=1, help="scenes a forward")
    ap.add_argument("--select", default=None, help="tpu_knn_select override (A/B runs)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (no silent CPU fallback)")
    args = ap.parse_args(argv)
    device = default_device(args.device)  # raises without a card, before any work
    cfg = bench_config(args.scale, args.batch, args.select)
    return measure(cfg, args.batch, device, scale=args.scale, select=args.select)


if __name__ == "__main__":
    main()
