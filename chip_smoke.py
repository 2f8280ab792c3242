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
6. runs the row-gather probe (tools/gather_probe.py: kernel K3 and its plain
   version, all ``OK``);
7. writes a synthetic dataset (4 scenes of 250,000 points, 2 of them val)
   and two checkpoints of seeded random weights into build/smoke_data (the
   few-shot one with its foreground class biased on, see there), and
   drives both eval drivers on it from their command lines: cli.test at the
   config/test_geoformer_scannet.yaml settings and cli.test_fs at the
   config/test_geoformer_fs_scannet.yaml settings (run_num cut to 2). Each
   must end in a finite AP table with every capacity counter at 0 and must
   launch K1 and K2;
8. holds K3 against its plain version at the probe's shape and at the
   forward's foreground gather, K2 at the two shapes of the few-shot
   path (support instance, 20,000-point aggregator) and K1 at the few-shot
   path's table, captured there;
9. prints a ``kernels`` line with each kernel's launches on its paths (K2's
   by shape: every counted run logs the shape of each K2 call, and a row's
   ``launches`` are those made at its shape), its times and its bound, the
   card's line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON object per line. Any failed check ends the run
with a non-zero exit and no ``ok`` line.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
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


def device_ms(torch, fn, reps: int, flush=None) -> float:
    """Mean device time of fn() from torch.profiler (sum over the CUDA
    kernels and copies it enqueues). For kernels of a few microseconds,
    where a loop between two CUDA events runs at the host's launch pace and
    not at the device's. With ``flush`` (a buffer several times the L2's
    size) every call finds the L2 cold: the buffer is filled before it, and
    the fill kernels' time is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.fill_(0.0)
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == cuda]
    if flush is not None:
        if not any("FillFunctor" in k for k, _ in events):
            fail("the L2 flush's fill kernel was not found in the profile")
        events = [(k, t) for k, t in events if "FillFunctor" not in k]
    total_us = sum(t for _, t in events)
    if total_us <= 0:
        fail("torch.profiler recorded no device time")
    return total_us / 1e3 / reps


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


class FpsShapeLog(list):
    """Stands in for ``fps.capture`` during a counted run: of each call it
    keeps the shape [B, P, n_samples] and drops the tensors, so that the
    run's launches can be told apart by shape."""

    def append(self, call):
        points, _, n_samples = call
        super().append((*points.shape[:2], n_samples))

    def by_shape(self) -> dict:
        return {json.dumps(list(k)): self.count(k) for k in sorted(set(self))}


def read_launches(counters, fps_log) -> dict:
    """The wrappers' counts after a counted run, K2's also by shape; every
    logged K2 call must have been a launch."""
    launches = {k: fn.launches for k, fn in counters.items()}
    if len(fps_log) != launches["fps"]:
        fail(f"fps: {len(fps_log)} calls logged, {launches['fps']} launches counted")
    launches["fps_by_shape"] = fps_log.by_shape()
    return launches


def bits(torch, t):
    """float32 tensors as their bit patterns, so that equality holds NaN
    payloads and the sign of zero too."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def kernel_row(torch, *, name, source, replaces, launches, kernel, plain, library, bytes_, ops,
               shape, reps, plain_reps, timer=time_ms, **extra) -> dict:
    """Hold ``kernel()`` against ``plain()`` (exact equality of every output)
    and time both, and ``library()`` where there is one, with ``timer``.
    ``bytes_`` and ``ops`` are what the function must move and do on these
    inputs."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(g.shape == w.shape and torch.equal(bits(torch, g), bits(torch, w)) for g, w in zip(got, want)):
        fail(f"{name} kernel disagrees with its plain version at {shape}")
    err = max(float((g.double() - w.double()).abs().nan_to_num().max()) for g, w in zip(got, want))
    b_bytes, b_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": timer(torch, kernel, reps),
        "plain_ms": timer(torch, plain, plain_reps),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": timer(torch, library, reps) if library is not None else None,
        "shape": shape, **extra}
    emit({"phase": "kernel", **row})
    return row


def fps_row(torch, fps, fps_plain, inputs, launches) -> dict:
    pts, msk, ns = inputs
    b, p, _ = pts.shape
    n_valid = int(msk.sum())
    return kernel_row(
        torch, name="fps", source="geoformer_tpu_torch/csrc/fps.cu",
        replaces="geoformer_tpu/ops/fps_pallas.py:29", launches=launches,
        kernel=lambda: fps(pts, msk, ns), plain=lambda: fps_plain(pts, msk, ns), library=None,
        # points and mask read once, picks written once; 9 operations per
        # valid point and pick
        bytes_=b * p * 13 + b * ns * 4, ops=(ns - 1) * n_valid * 9,
        shape=[b, p, ns], reps=10, plain_reps=2, n_valid=n_valid)


def row_gather_row(torch, row_gather, row_gather_plain, x, idx, launches) -> dict:
    """K3 takes a few microseconds, so its times are the profiler's device
    times: with the L2 flushed before every call (``ms``, ``plain_ms``,
    ``library_ms``, to stand beside a bound at the device memory's rate) and
    with the L2 warm (``l2_warm``); ``wrapper_loop_ms`` is the pace of a
    loop over the wrapper, which the host sets."""
    n, q = idx.shape[0], x.shape[1]
    idx64 = idx.reshape(-1).long()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=x.device)  # 256 MB
    fns = {"ms": lambda: row_gather(x, idx), "plain_ms": lambda: row_gather_plain(x, idx),
           "library_ms": lambda: torch.index_select(x, 0, idx64)}
    return kernel_row(
        torch, name="row_gather", source="geoformer_tpu_torch/csrc/row_gather.cu",
        replaces="tools/pallas_gather_probe.py:65", launches=launches,
        kernel=fns["ms"], plain=fns["plain_ms"], library=fns["library_ms"],
        # each gathered row read once and written once, each id read once
        bytes_=n * (2 * q * 4 + 4), ops=0, shape=[x.shape[0], q, n], reps=50, plain_reps=50,
        timer=functools.partial(device_ms, flush=flush),
        l2_warm={k: device_ms(torch, fn, 50) for k, fn in fns.items()},
        wrapper_loop_ms=time_ms(torch, fns["ms"], 50))


def write_smoke_data(torch, cfg_mod, Engine, here) -> dict:
    """A synthetic dataset of full-size scenes, the two drivers' configs and
    two checkpoints of seeded random weights, under build/smoke_data."""
    import yaml

    from geoformer_tpu_torch.synthetic import write_dataset
    from geoformer_tpu_torch.weights import save_jax_checkpoint

    t0 = time.time()
    root = os.path.join(here, "build", "smoke_data")
    write_dataset(root, n_scenes=4, n_points=250000, seed=0)
    common = dict(data_root=root, output_path=os.path.join(root, "exp"), split="val")
    cfgs = {"test": cfg_mod.scannet_eval_config(**common),
            # the published protocol runs 10 support sets; 2 keep the smoke short
            "test_fs": cfg_mod.scannet_fs_eval_config(run_num=2, **common)}
    paths = {}
    for name, cfg in cfgs.items():
        values = {k: v for k, v in cfg.to_dict().items() if k != "config"}
        paths[name] = {"config": os.path.join(root, f"{name}.yaml"),
                       "ckpt": os.path.join(root, f"{name}.ckpt")}
        with open(paths[name]["config"], "w") as f:
            yaml.safe_dump({"ALL": values}, f)
        engine = Engine(cfg, seed=0, few_shot=name == "test_fs")
        if name == "test_fs":
            # The few-shot config evaluates fold 1 with a backbone of fold 0:
            # its foreground is semantic class 3 ("outside the fold"), which
            # random weights never predict. A bias on that one logit makes
            # every point foreground, as in the supervised run, so that the
            # path runs at its full capacities (131,072 fg points, 20,000
            # aggregator points) and not on an empty scene.
            with torch.no_grad():
                engine.model.semantic.Dense_2.bias[3] += 1e4
        save_jax_checkpoint(paths[name]["ckpt"], engine.model)
    emit({"phase": "dataset", "root": os.path.relpath(root, here), "scenes": 4, "val_scenes": 2,
          "points": 250000, "cut": {"run_num": [10, 2]}, "seconds": time.time() - t0})
    return {"cfgs": cfgs, "paths": paths}


def run_driver(torch, name, main, paths, counters) -> dict:
    """One eval driver from its command line, with the kernels' launch
    counts set to 0 just before and read just after."""
    for fn in counters.values():
        fn.launches = 0
    fps_log = counters["fps"].capture = FpsShapeLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = main(["--config", paths["config"], "--pretrain", paths["ckpt"],
                    "--output_path", os.path.join(os.path.dirname(paths["config"]), "exp"),
                    "--exp_name", name])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counters["fps"].capture = None
    launches = read_launches(counters, fps_log)
    avgs = summary["avgs"]
    res = {"phase": f"driver_{name}", "all_ap": avgs["all_ap"], "all_ap_50%": avgs["all_ap_50%"],
           "all_ap_25%": avgs["all_ap_25%"], "scenes": summary["scenes"],
           "n_degraded": summary["n_degraded"], "launches": launches, "seconds": seconds,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if "stage_ms" in summary:
        res["stage_ms"] = {k: {"calls": len(v), "mean": sum(v) / len(v), "max": max(v)}
                           for k, v in summary["stage_ms"].items()}
    emit(res)
    if not all(math.isfinite(avgs[k]) for k in ("all_ap", "all_ap_50%", "all_ap_25%")):
        fail(f"driver {name}: AP is not finite")
    if len(summary["scenes"]) != 2:
        fail(f"driver {name}: {len(summary['scenes'])} scenes evaluated, expected 2")
    if summary["n_degraded"]:
        fail(f"driver {name}: a scene ran over a static capacity")
    for k in ("knn_select", "fps"):
        if launches[k] <= 0:
            fail(f"driver {name}: kernel {k} was not launched")
    if any(r["fg_points"] <= 0 for r in summary["scenes"]):
        fail(f"driver {name}: a scene had no foreground point")
    return res


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
    from geoformer_tpu_torch.cli import test as cli_test
    from geoformer_tpu_torch.cli import test_fs as cli_test_fs
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.synthetic import synthetic_batch
    from geoformer_tpu_torch.tools import gather_probe

    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    so = kernels.build()
    emit({"phase": "build", "library": os.path.relpath(so, here),
          "sources": [os.path.basename(p) for p in kernels.sources()],
          "seconds": time.time() - t0})

    small_reference(torch, cfg_mod, Engine, synthetic_batch)

    # ---------------- main path: full-width forwards ----------------
    cfg = cfg_mod.scannet_eval_config()
    engine = Engine(cfg, seed=0)
    mc = engine.mc
    P, F, Q, C = cfg.tpu_max_points, mc.max_fg_points, mc.n_query_points, mc.classes
    counters = {"knn_select": select_min_k_cand, "fps": fps, "row_gather": row_gather}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    fps_log = fps.capture = FpsShapeLog()
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
    fps.capture = None
    launches = read_launches(counters, fps_log)
    emit({"phase": "main_path", "scenes": len(scene_ms), "ms_per_scene": scene_ms,
          "launches": launches})
    for name in ("knn_select", "fps"):
        if launches[name] <= 0:
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
    # the forward's own foreground gather (gather_rows(point_feats, fg_idx)),
    # the real-size input of the K3 phase
    with torch.no_grad():
        tb = engine.to_device(batch)
        point_feats, _, semantic_preds, _ = engine.model.forward_backbone(tb)
        fg_idx, _ = engine.model.foreground_pack(semantic_preds, tb["point_mask"])
    gather_x, gather_idx = point_feats[0].contiguous(), fg_idx[0].to(torch.int32)
    del out, engine, tb, point_feats, semantic_preds, fg_idx
    torch.cuda.empty_cache()

    # ---------------- kernel phases on the captured main-path tables ----------------
    d2, cand, k = knn_inputs[0]
    n, w = d2.shape
    k1_row = kernel_row(
        torch, name="knn_select", source="geoformer_tpu_torch/csrc/knn_select.cu",
        replaces="geoformer_tpu/ops/knn_select_pallas.py:34", launches=launches["knn_select"],
        kernel=lambda: select_min_k_cand(d2, cand, k),
        plain=lambda: select_min_k_cand_plain(d2, cand, k),
        library=lambda: torch.topk(d2, k, dim=1, largest=False),
        # what the selection must move: d2 read once, only the k picked ids of
        # cand (4 B each, not whole sectors), vals and ids written once
        bytes_=n * w * 4 + n * k * 4 + n * k * 8, ops=n * w * k, shape=[n, w, k],
        reps=20, plain_reps=3)
    k1_shape = [n, w, k]
    del d2, cand, knn_inputs
    k2_shape = json.dumps([*fps_inputs[0][0].shape[:2], fps_inputs[0][2]])
    k2_row = fps_row(torch, fps, fps_plain, fps_inputs[0],
                     launches["fps_by_shape"].get(k2_shape, 0))
    if k2_row["launches"] != launches["fps"]:
        fail(f"fps: the main path launched {launches['fps_by_shape']}, held at {k2_shape}")
    del fps_inputs

    # ---------------- K3's own path: the row-gather probe ----------------
    row_gather.launches = 0
    probe = gather_probe.run_probe()
    probe_launches = row_gather.launches
    emit({"phase": "gather_probe", "results": probe, "launches": probe_launches})
    if any(r != "OK" for r in probe.values()):
        fail(f"gather probe: {probe}")
    if probe_launches <= 0:
        fail("kernel row_gather was not launched by the probe")

    # ---------------- the two eval drivers on a dataset on disk ----------------
    data = write_smoke_data(torch, cfg_mod, Engine, here)
    by_path = {"eval_batch": launches, "gather_probe": {"row_gather": probe_launches}}
    for name, main_fn in (("test", cli_test.main), ("test_fs", cli_test_fs.main)):
        by_path[f"driver_{name}"] = run_driver(
            torch, name, main_fn, data["paths"][name], counters)["launches"]

    # the few-shot path's own K2 shapes (the support instance's 32 picks, the
    # 20,000-point aggregator) and its K1 table, captured from one support and
    # one scene outside the counted run; each K2 row's launches are those the
    # counted driver run made at that row's shape
    from geoformer_tpu_torch.data.episodic import FSInstDataset
    from geoformer_tpu_torch.weights import load_jax_checkpoint

    fs_cfg = data["cfgs"]["test_fs"]
    fs_engine = Engine(fs_cfg, few_shot=True,
                       state_dict=load_jax_checkpoint(data["paths"]["test_fs"]["ckpt"]))
    fs_data = FSInstDataset(fs_cfg, "val")
    _, active, scene_batch = next(fs_data.test_batches())
    support = fs_data.load_support_sets()[0][active[0]][0]
    fs_inputs, fs_knn_inputs = [], []
    fps.capture, select_min_k_cand.capture = fs_inputs, fs_knn_inputs
    fs_engine.process_support(fs_data.support_batch(*support))
    fs_engine.encode_scene(scene_batch)
    fps.capture = select_min_k_cand.capture = None
    del fs_engine
    torch.cuda.empty_cache()
    # K1 on the few-shot path: the shape held above, and exact at this table too
    d2, cand, k = fs_knn_inputs[0]
    if len(fs_knn_inputs) != 1 or [*d2.shape, k] != k1_shape:
        fail(f"few-shot knn_select shape {[*d2.shape, k]} x {len(fs_knn_inputs)}, held {k1_shape}")
    if not all(torch.equal(bits(torch, g), bits(torch, w)) for g, w in zip(
            select_min_k_cand(d2, cand, k), select_min_k_cand_plain(d2, cand, k))):
        fail("knn_select kernel disagrees with its plain version on the few-shot path's table")
    del d2, cand, fs_knn_inputs
    torch.cuda.empty_cache()
    fs_by_shape = by_path["driver_test_fs"]["fps_by_shape"]
    fs_rows = [fps_row(torch, fps, fps_plain, inp,
                       fs_by_shape.get(json.dumps([*inp[0].shape[:2], inp[2]]), 0))
               for inp in fs_inputs]
    shapes = [r["shape"] for r in fs_rows]
    if shapes != [[1, 4096, 32], [1, fs_cfg.n_downsampling, fs_cfg.n_decode_point]]:
        fail(f"few-shot fps shapes {shapes}")
    if any(r["launches"] <= 0 for r in fs_rows) or sum(
            r["launches"] for r in fs_rows) != by_path["driver_test_fs"]["fps"]:
        fail(f"few-shot fps launches by shape {fs_by_shape} do not match the held shapes {shapes}")

    # ---------------- K3 at the probe's shape and at the forward's fg gather ----------------
    px, pidx = (torch.from_numpy(a).cuda() for a in gather_probe.probe_inputs())
    k3_row = row_gather_row(torch, row_gather, row_gather_plain, px, pidx, probe_launches)
    # the forward gathers with PyTorch's indexing, so this shape's launches
    # are what the three counted model paths read off K3's counter
    k3_large = row_gather_row(
        torch, row_gather, row_gather_plain, gather_x, gather_idx,
        sum(by_path[p]["row_gather"] for p in ("eval_batch", "driver_test", "driver_test_fs")))

    k2_row["other_shapes"] = fs_rows
    k3_row["other_shapes"] = [k3_large]
    rows = [k1_row, k2_row, k3_row]
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c.get(row["name"])}
    k2_row["launches_by_path_and_shape"] = {p: c["fps_by_shape"] for p, c in by_path.items()
                                            if c.get("fps_by_shape")}
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
