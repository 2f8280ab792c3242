#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (geoformer_tpu_torch).

    python3 chip_smoke.py [--scenes N]

Needs one CUDA card; exits non-zero without one, or when run from a
directory that lacks the port's package. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from geoformer_tpu_torch/csrc into build/;
3. checks the CUDA path against the CPU path on a small scene (same seeded
   weights: fg indices equal, scores within 1e-3);
4. drives the main path, Engine.eval_batch (the supervised eval forward +
   matrix NMS), over N >= 2 synthetic 250,000-point scenes at the
   config/test_geoformer_scannet.yaml settings with seeded random weights,
   and checks every output is finite and of the expected shape, reading
   both kernels' launch counts and the peak device memory over that run;
   then, outside it, times one forward stage by stage, one plain forward
   and one under torch.profiler (device busy share = profiled device time
   / the plain forward's wall time), and runs one forward that captures
   the kernels' input tables;
5. holds each kernel (K1 knn_select, K2 fps) against its plain PyTorch
   version on those captured main-path tables (exact equality), and times
   kernel, plain version and library call with CUDA events;
6. prints a ``kernels`` line with each kernel's launches in the main-path
   run, its times and its bound, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON object per line. Any failed check ends the run
with a non-zero exit and no ``ok`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_finite(torch, name, t) -> None:
    if not bool(torch.isfinite(t).all()):
        fail(f"{name} has non-finite values")


def wall_forward_ms(torch, engine, batch) -> float:
    """Host-clock ms of one eval_batch, from a synchronized start to a
    synchronize after its last device work."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.eval_batch(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def profile_forward(torch, engine, batch) -> None:
    """One plain forward for the wall time, then the same forward under
    torch.profiler: device kernel time (sum over CUDA kernels and copies,
    one stream, so no overlap), its share of the plain forward's wall time,
    the number of device launches, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    wall_ms = wall_forward_ms(torch, engine, batch)
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.eval_batch(batch)
        torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "device_ms": device_ms, "wall_ms": wall_ms,
          "profiled_wall_ms": profiled_wall_ms, "busy_share": device_ms / wall_ms,
          "device_launches": sum(r[2] for r in rows),
          "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]})


def small_reference(torch, cfg_mod, Engine, synthetic_batch) -> dict:
    """Same seeded weights on the card and on the CPU at a small size: the
    CPU runs the kernels' plain versions."""
    cfg = cfg_mod.load_config(
        None, batch_size=1, m=8, dec_dim=32, dec_nhead=4, dec_ffn_dim=32, dec_nlayers=2,
        n_decode_point=128, n_query_points=32, n_downsampling=2048, tpu_max_points=4096,
        tpu_max_voxels=4096, tpu_max_fg_points=2048, tpu_knn_neighbors=16,
        tpu_spatial_shape=256, tpu_unet_depth=4, tpu_ball_nsample=16)
    batch = synthetic_batch(cfg, 1, seed=7)
    outs = {dev: Engine(cfg, device=dev, seed=3).eval_batch(batch) for dev in ("cpu", "cuda")}
    a, b = outs["cpu"], outs["cuda"]
    fg_equal = bool(torch.equal(a["fg_idx"], b["fg_idx"].cpu()))
    sem_err = float((a["semantic_scores"] - b["semantic_scores"].cpu()).abs().max())
    mask_err = float((a["mask_logits"] - b["mask_logits"].cpu()).abs().max())
    res = {"phase": "small_reference", "points": cfg.tpu_max_points, "fg_idx_equal": fg_equal,
           "semantic_max_abs_err": sem_err, "mask_logits_max_abs_err": mask_err, "tol": 1e-3}
    emit(res)
    if not fg_equal or sem_err > 1e-3 or mask_err > 1e-3:
        fail("CUDA path disagrees with the CPU path on the small scene")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", type=int, default=2, help="full-size scenes to run (>= 2)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "geoformer_tpu_torch")):
        print("chip_smoke: geoformer_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from geoformer_tpu_torch import config as cfg_mod
    from geoformer_tpu_torch import kernels
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.synthetic import synthetic_batch

    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    so = kernels.build()
    emit({"phase": "build", "library": os.path.relpath(so, here),
          "seconds": time.time() - t0})

    small_reference(torch, cfg_mod, Engine, synthetic_batch)

    # ---------------- main path: full-width forwards ----------------
    cfg = cfg_mod.scannet_eval_config()
    engine = Engine(cfg, seed=0)
    mc = engine.mc
    P, F, Q, C = cfg.tpu_max_points, mc.max_fg_points, mc.n_query_points, mc.classes
    torch.cuda.reset_peak_memory_stats()
    select_min_k_cand.launches = 0
    fps.launches = 0
    scene_ms = []
    for seed in range(max(args.scenes, 2)):
        batch = synthetic_batch(cfg, 1, seed=seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.eval_batch(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        scene_ms.append(ms)

        shapes = {"semantic_scores": (1, P, C), "cls_logits": (1, 1, Q, C),
                  "mask_logits": (1, 1, Q, F), "fg_idx": (1, F)}
        for name, shape in shapes.items():
            if tuple(out[name].shape) != shape:
                fail(f"{name} shape {tuple(out[name].shape)} != {shape}")
        if tuple(out["proposals"]["masks"].shape) != (1, Q, P):
            fail("proposal masks shape")
        for name in ("semantic_scores", "cls_logits", "mask_logits"):
            check_finite(torch, name, out[name])
        check_finite(torch, "proposal scores", out["proposals"]["scores"])
        check_finite(torch, "nms scores", out["nms"]["scores"])
        emit({"phase": "forward", "seed": seed, "points": P, "ms": ms,
              "voxel_stats": {k: v.tolist() for k, v in out["voxel_stats"].items()},
              "fg_points": int(out["fg_valid"].sum()),
              "proposals_keep": int(out["proposals"]["keep"].sum()),
              "proposals_after_nms": int(out["nms"]["keep"].sum()),
              "geodesic_passes": [list(p) for p in engine.model.geodesic_passes],
              "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    launches = {"knn_select": select_min_k_cand.launches, "fps": fps.launches}
    emit({"phase": "main_path", "scenes": len(scene_ms), "ms_per_scene": scene_ms,
          "launches": launches})
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # outside the counted main-path run: where the time goes in scene 0 (one
    # forward with each stage closed by a device synchronize, then a plain
    # and a profiled forward), then one forward that captures the kernels'
    # input tables for the kernel phases
    batch = synthetic_batch(cfg, 1, seed=0)
    engine.model.stage_ms = {}
    wall_ms = wall_forward_ms(torch, engine, batch)
    stage_ms = engine.model.stage_ms
    engine.model.stage_ms = None
    emit({"phase": "stages", "seed": 0, "ms": wall_ms, "stage_ms": stage_ms,
          "to_device_and_nms_ms": wall_ms - sum(stage_ms.values())})
    profile_forward(torch, engine, batch)
    knn_inputs, fps_inputs = [], []
    select_min_k_cand.capture, fps.capture = knn_inputs, fps_inputs
    engine.eval_batch(batch)
    select_min_k_cand.capture = fps.capture = None
    del out, engine
    torch.cuda.empty_cache()

    # ---------------- kernel phases on the captured main-path tables ----------------
    rows = []
    d2, cand, k = knn_inputs[0]
    n, w = d2.shape
    v_k, i_k = select_min_k_cand(d2, cand, k)
    v_p, i_p = select_min_k_cand_plain(d2, cand, k)
    torch.cuda.synchronize()
    if not (torch.equal(v_k, v_p) and torch.equal(i_k, i_p)):
        fail("knn_select kernel disagrees with its plain version")
    # what the selection must move: d2 read once, only the k picked ids of
    # cand (4 B each, not whole sectors), vals and ids written once
    bytes_ = n * w * 4 + n * k * 4 + n * k * 8
    ops = n * w * k
    b_bytes, b_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    rows.append({
        "name": "knn_select", "route": "cuda", "source": "geoformer_tpu_torch/csrc/knn_select.cu",
        "replaces": "geoformer_tpu/ops/knn_select_pallas.py:34",
        "launches": launches["knn_select"],
        "max_abs_err": float((v_k - v_p).abs().max()),
        "ms": time_ms(torch, lambda: select_min_k_cand(d2, cand, k), 20),
        "plain_ms": time_ms(torch, lambda: select_min_k_cand_plain(d2, cand, k), 3),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": time_ms(torch, lambda: torch.topk(d2, k, dim=1, largest=False), 20),
        "shape": [n, w, k]})
    emit({"phase": "kernel", **rows[-1]})
    del d2, cand, knn_inputs

    pts, msk, ns = fps_inputs[0]
    b, p, _ = pts.shape
    i_k = fps(pts, msk, ns)
    i_p = fps_plain(pts, msk, ns)
    torch.cuda.synchronize()
    if not torch.equal(i_k, i_p):
        fail(f"fps kernel disagrees with its plain version ({int((i_k != i_p).sum())} picks)")
    n_valid = int(msk.sum())
    ops = (ns - 1) * n_valid * 9
    bytes_ = b * p * 13 + b * ns * 4
    b_bytes, b_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    rows.append({
        "name": "fps", "route": "cuda", "source": "geoformer_tpu_torch/csrc/fps.cu",
        "replaces": "geoformer_tpu/ops/fps_pallas.py:29",
        "launches": launches["fps"],
        "max_abs_err": float((i_k - i_p).abs().max()),
        "ms": time_ms(torch, lambda: fps(pts, msk, ns), 10),
        "plain_ms": time_ms(torch, lambda: fps_plain(pts, msk, ns), 2),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "shape": [b, p, ns]})
    emit({"phase": "kernel", **rows[-1]})

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
