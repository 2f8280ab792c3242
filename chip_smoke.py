#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (geoformer_tpu_torch).

    python3 chip_smoke.py [--scenes N]

Needs one CUDA card; exits non-zero without one, or when run from a
directory that lacks the port's package. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from geoformer_tpu_torch/csrc into build/;
3. checks the CUDA path against the CPU path on a small scene (same seeded
   weights: fg indices equal, scores within 1e-3), then holds K1, K2 and
   K3 bit-equal to their plain versions on the corner cases of their
   designs (``kernel_edges``: kernels/edge_cases.py; K2's cluster size and
   K1's exact-path rows printed per case, none among the rows K1's design
   must sort and all among those it must send to its exact path,
   ``knn_path_rows``; K3 on every width class at either side of its
   rows-a-thread threshold, misaligned views and a table of more than 2^31
   words, as 16-byte units, words and by the per-unit kernel) and times K2's
   chain of dependent picks on an all-invalid scene, where no distance is
   updated;
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
   kernel, plain version and library call with CUDA events (K1's row adds
   the share of rows that took its exact path, K2's its cluster size and
   its device time from torch.profiler, ``profiler_ms``);
6. ``offpath``: the branches that config keys reach, at the same capacity
   on one synthetic scene: (a) Engine.eval_batch with the exact geodesic
   solver (``tpu_geodesic_hier: False``), then also in int16
   (``tpu_geodesic_int16``), each counted like the main path (geodesic ms,
   sweeps and whether they reached ``geodesic_steps_eval``, peak memory,
   capacity counters, which must read 0, K1's and K2's launches, K1 at
   [131072, 648] with k = 64), and int16's largest distance from float32;
   (b) the exact solve on a crop of that scene's graph (16,384 points, 64
   seeds) bit-equal between the card and the CPU in both types, its seed
   columns in two halves equal to the whole; (c) ``radius_knn`` at the
   scene's foreground shape in each off-path arm against the shipped arm;
   (d) the brute-force ball query at the aggregator's shapes against the
   hash path; (e) the backbone with ``tpu_subm_k`` 9 and 18 (compact slot
   tables) against the exact conv, with each level's largest live-offset
   count; then K1 held against its plain version at k = 64 on the exact
   solver's table, and, on ``kernel`` lines of their own (``table``, no
   launch count: no path makes them), on a uniform table of its shape live
   in every lane and on that table with each row's smallest values packed
   in 7 lanes' slots (K1's exact path);
7. runs the row-gather probe (tools/gather_probe.py: kernel K3 and its plain
   version, all ``OK``);
8. writes a synthetic dataset (4 scenes of 250,000 points, 2 of them val)
   and two checkpoints of seeded random weights into build/smoke_data (the
   few-shot one with its foreground class biased on, see there), and
   drives both eval drivers on it from their command lines: cli.test at the
   config/test_geoformer_scannet.yaml settings and cli.test_fs at the
   config/test_geoformer_fs_scannet.yaml settings (run_num cut to 2). Each
   must end in a finite AP table with every capacity counter at 0 and must
   launch K1 and K2;
   then ``library``: the library ops at the shapes of a real scene on
   synthetic inputs, each held against the port's own CPU run on the same
   inputs (``knn`` at [1, 131072] x [1, 131072], k = 16, its CPU run on the
   first LIB_CPU_ROWS queries; ``three_nn`` + ``three_interpolate`` from
   2,048 centers to 50,000 points, C = 128; ``sec_*``, ``roipool`` and its
   gradient over 131,072 x 32 rows in 256 segments, one empty;
   ``get_iou`` and ``greedy_nms`` over [256, 250000] proposal masks and 40
   instances; ``bfs_cluster`` over 131,072 points at PointGroup's settings,
   the CPU on LIB_CPU_ROWS rows of its ball query and on the card's
   table), the native elastic (its library must build) against the
   numpy/scipy fallback on this host, and cli.test with save_semantic: True
   and --profile_dir, counted: its PLY/OBJ files, their semantic labels equal to
   the run's argmax, a trace naming K1's and K2's kernels, and K1's and K2's
   launches equal to the plain cli.test run's;
9. holds K3 against its plain version at the probe's shape, at the
   forward's foreground gather and at one block's slab of the geodesic fine
   sweep (4,096 ids from scene 0's radius-kNN table into a [131073, 128]
   table), each timed beside the per-unit kernel on a ``k3_parent_vs_new``
   line, K2 at the two shapes of the few-shot
   path (support instance, 20,000-point aggregator) and K1 at the few-shot
   path's table, captured there;
10. drives the training paths (``train_paths``): writes a dataset of 4B
   scenes with their points shuffled, every second one thinned below the
   250,000-point capacity (the first 2B the train split, two steps an epoch
   at the batch size B) and a pretrain checkpoint
   whose semantic head makes every point foreground, then runs cli.train on
   config/geoformer_scannet.yaml (its widths, bf16 and remat; epochs cut as
   TRAIN_CUTS says: one prepare epoch, one full epoch), cli.test on the
   checkpoint it wrote (the ``chain``), and cli.train_fs from it on
   config/geoformer_fs_scannet.yaml (TRAIN_FS_CUTS), each from its command
   line and counted; each prints ms a step by phase, the losses, the matched
   instances, peak memory, every capacity counter (all must read 0), the
   matcher's share of the step, the residual blocks rematerialized and the
   sparse-conv operands narrowed to bf16, and K1's and K2's launches (K2's
   at both few-shot shapes); then holds K1 and K2 against their plain
   versions at the training shapes (B > 1), captured in one training-mode
   forward outside the counted runs;
11. ``train_small_reference``: one full-phase training step at a small size
   and the published U-Net depth on the card and on the CPU, same weights,
   batch and subsample draws, in float32 and in float64: in float64 the loss
   and every gradient within 1e-9 x max(1, |cpu|inf); in float32 the card
   no further from the float64 step than the CPU, leaf by leaf (see
   there); K1's and K2's card outputs equal to their plain versions' on the
   CPU run's inputs;
12. data parallelism, with ranks that are processes of this script
   (``--rank-task``) started as torchrun starts them, on the one card over
   ``gloo``; any rank's failure fails the run: ``ddp_reference`` (the step of
   11 on two ranks, one scene a rank, against the one-process step on the
   card: float64 within 1e-9, float32 against float64 as 11 holds it, the
   ranks' models bit-equal after two steps), ``ddp_train`` (cli.train on
   config/geoformer_scannet.yaml at two ranks and a global batch of 4, one
   prepare and one full epoch of two steps: each rank's s/step, peak
   memory, capacity counters, model digest and K1/K2 launches; then its
   checkpoint through a one-process cli.test), ``ddp_eval`` (cli.test at two
   ranks against one process: every scene's predictions and the AP table
   equal) and, beside it, ``ddp_nccl`` (cli.train at a world of 1 under
   nccl for one prepare step);
13. model parallelism (the JAX ``model`` mesh axis: each scene's queries
   split over the M = 2 ranks of a model group), with data x model ranks of
   this script on the one card over ``gloo``: ``mp_reference`` (the step of
   11 at 1x2 and 2x2 ranks against the one-process step of 12: float64
   within 1e-9, each rank's geodesic table bit-equal to its columns of the
   one-process table, the same matches, float32 as 12 holds it, the ranks
   bit-equal after two steps, and no collective moving an activation as
   large as one scene's [F, Q] table), ``mp_train`` (two full-phase steps of
   Engine.train_step at config/geoformer_scannet.yaml's widths, 2x2 ranks,
   a global batch of 4: each rank's s/step, peak memory, stage ms, counters
   and K1/K2 launches; the geodesic solve alone at Q and at Q/2 seeds and a
   one-process step on one data index's scenes beside them) and ``mp_eval``
   (Engine.eval_batch on the two 250,000-point val scenes at 1x2 against one
   process at B = 2 and at B = 1, scene 0 compared stage by stage: integer
   stages equal, float stages within the bound that the B = 1 / B = 2
   distance sets, see MP_EVAL_RATIO);
14. the throughput entry points, each run as a subprocess as a user runs
   it: ``bench_eval`` runs cli.bench (bench.py's scene_inference line) at
   the ``prod`` and the ``full`` scale, B = 1, and fails unless the rate is
   above 0, no hard capacity counter is above 0 (the soft window counter is
   printed), the foreground is not empty, the line names the card and its
   power limit, and K1's and K2's launches over the run are 9 x those of
   its first forward; then one forward at ``full`` outside the counted
   runs holds K1 and K2 against their plain versions at any shape that no
   phase above held (K1's [32768, 648] table), on ``kernel`` lines;
15. ``train_bench``: tools/train_bench.py's counterpart at its defaults
   (B = 1, full phase, 250,000 points, bf16 and remat), with ``--prepare``
   and with ``--fs``, two timed steps each, then ``--mesh 2`` (1 x 2
   gloo ranks on the one card) for one: each must print a finite loss and
   p50 step, scenes/s and peak memory beside the card's name and power
   limit, and each full-phase run must launch K1 and K2 on every rank;
16. prints a ``kernels`` line with each kernel's launches on its paths (K2's
   by shape: every counted run logs the shape of each K2 call, and a row's
   ``launches`` are those made at its shape; K2's row at two scenes,
   [2, 50000] x 2,048, counts the data- and model-parallel ranks'
   launches), its times and its bound, the
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
import re
import signal
import subprocess
import sys
import time

import numpy as np

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


def device_ms(torch, fn, reps: int, flush=None, only=None) -> float:
    """Device time of one fn() from torch.profiler (each kernel's median
    launch), the L2 flushed before every call with ``flush``
    (tools/profiling.py ``device_ms``)."""
    from geoformer_tpu_torch.tools.profiling import device_ms as profiled

    return profiled(fn, reps, flush=flush, only=only)


def check_finite(torch, name, t) -> None:
    if not bool(torch.isfinite(t).all()):
        fail(f"{name} has non-finite values")


def timed(torch, fn):
    """(fn(), host-clock ms), from a synchronized start to a synchronize
    after its last device work."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def wall_forward_ms(torch, engine, batch) -> float:
    """Host-clock ms of one eval_batch."""
    return timed(torch, lambda: engine.eval_batch(batch))[1]


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


class CallLog(list):
    """Stands in for a kernel wrapper's ``capture`` (K1's or K2's) during a
    counted run: of each call it keeps the shape ([N, W, k] or [B, P,
    n_samples]) and drops the tensors, so that the run's launches can be
    told apart by shape; with ``keep`` (outside a counted run) it also keeps
    the tensors of the first call at each shape."""

    def __init__(self, keep: bool = False):
        super().__init__()
        self.keep = keep
        self.first = {}

    def append(self, call):
        a, _, k = call
        key = (*a.shape, k) if a.ndim == 2 else (*a.shape[:2], k)
        super().append(key)
        if self.keep and key not in self.first:
            self.first[key] = call

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
    inputs. ``launches`` None: a table no path makes, no launch count."""
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
    if launches is None:
        del row["launches"]
    emit({"phase": "kernel", **row})
    return row


def exact_share(torch, select, d2, cand, k) -> float:
    """Share of the rows of this table that take K1's exact path."""
    rows = torch.zeros(1, dtype=torch.int32, device=d2.device)
    select(d2, cand, k, exact_rows=rows)
    return int(rows) / d2.shape[0]


def fps_row(torch, fps, fps_plain, inputs, launches) -> dict:
    """K2 at one shape. ``profiler_ms`` is the kernel's device time from
    torch.profiler: at 32 picks a launch takes tens of microseconds, as
    long as the wrapper's host time, and the CUDA-event loop reads both."""
    from geoformer_tpu_torch.kernels.fps import cluster_size

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
        shape=[b, p, ns], reps=10, plain_reps=2, n_valid=n_valid,
        cluster_size=cluster_size(p),
        profiler_ms=device_ms(torch, lambda: fps(pts, msk, ns), 10, only="fps_kernel"))


def row_gather_row(torch, row_gather, row_gather_plain, x, idx, launches) -> dict:
    """K3 takes a few microseconds, so its times are the profiler's device
    times: with the L2 flushed before every call (``ms``, ``plain_ms``,
    ``library_ms``, to stand beside a bound at the device memory's rate) and
    with the L2 warm (``l2_warm``); ``wrapper_loop_ms`` is the pace of a
    loop over the wrapper, which the host sets. The bound reads each
    distinct row once (``bound_ms_all_ids``: each id's row). Then the
    per-unit kernel (``per_unit``, the first design: one unit a thread)
    against the new one, in turns, flushed and warm, on a
    ``k3_parent_vs_new`` line of its own."""
    from geoformer_tpu_torch.tools.k3_sources import gather_bytes, per_unit
    from geoformer_tpu_torch.tools.profiling import compare, l2_flush

    n, q = idx.shape[0], x.shape[1]
    idx64 = idx.reshape(-1).long()
    moved = gather_bytes(x, idx)
    fns = {"ms": lambda: row_gather(x, idx), "plain_ms": lambda: row_gather_plain(x, idx),
           "library_ms": lambda: torch.index_select(x, 0, idx64)}
    row = kernel_row(
        torch, name="row_gather", source="geoformer_tpu_torch/csrc/row_gather.cu",
        replaces="tools/pallas_gather_probe.py:65", launches=launches,
        kernel=fns["ms"], plain=fns["plain_ms"], library=fns["library_ms"],
        bytes_=moved["bytes"], ops=0, shape=[x.shape[0], q, n], reps=50, plain_reps=50,
        timer=functools.partial(device_ms, flush=l2_flush(x.device)),
        l2_warm={k: device_ms(torch, fn, 50) for k, fn in fns.items()},
        wrapper_loop_ms=time_ms(torch, fns["ms"], 50), distinct_rows=moved["distinct_rows"],
        bound_ms_all_ids=moved["bytes_all_ids"] / HBM_BYTES_PER_S * 1e3)
    versus = compare({"per_unit": functools.partial(per_unit, x, idx),
                      "rows": functools.partial(row_gather, x, idx)},
                     ["per_unit", "rows", "rows", "per_unit"])
    emit({"phase": "k3_parent_vs_new", "shape": row["shape"], **versus})
    row["per_unit_ms"] = versus["per_unit"]["ms"]
    return row


def write_yaml(path: str, cfg) -> str:
    """``cfg`` as a driver's YAML config file at ``path``."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"ALL": {k: v for k, v in cfg.to_dict().items() if k != "config"}}, f)
    return path


def write_smoke_data(torch, cfg_mod, Engine, here) -> dict:
    """A synthetic dataset of full-size scenes, the two drivers' configs and
    two checkpoints of seeded random weights, under build/smoke_data."""
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
        paths[name] = {"config": write_yaml(os.path.join(root, f"{name}.yaml"), cfg),
                       "ckpt": os.path.join(root, f"{name}.ckpt")}
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


def run_driver(torch, name, main, paths, counters, label=None, extra=()) -> dict:
    """One eval driver from its command line (plus ``extra`` arguments),
    with the kernels' launch counts set to 0 just before and read just
    after. ``label`` names the run (its phase and experiment directory) when
    it is not ``name``."""
    label = label or name
    for fn in counters.values():
        fn.launches = 0
    fps_log = counters["fps"].capture = CallLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = main(["--config", paths["config"], "--pretrain", paths["ckpt"],
                    "--output_path", os.path.join(os.path.dirname(paths["config"]), "exp"),
                    "--exp_name", label, *extra])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counters["fps"].capture = None
    launches = read_launches(counters, fps_log)
    avgs = summary["avgs"]
    res = {"phase": f"driver_{label}", "all_ap": avgs["all_ap"], "all_ap_50%": avgs["all_ap_50%"],
           "all_ap_25%": avgs["all_ap_25%"], "scenes": summary["scenes"],
           "n_degraded": summary["n_degraded"], "launches": launches, "seconds": seconds,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if "stage_ms" in summary:
        res["stage_ms"] = {k: {"calls": len(v), "mean": sum(v) / len(v), "max": max(v)}
                           for k, v in summary["stage_ms"].items()}
    emit(res)
    if not all(math.isfinite(avgs[k]) for k in ("all_ap", "all_ap_50%", "all_ap_25%")):
        fail(f"driver {label}: AP is not finite")
    if len(summary["scenes"]) != 2:
        fail(f"driver {label}: {len(summary['scenes'])} scenes evaluated, expected 2")
    if summary["n_degraded"]:
        fail(f"driver {label}: a scene ran over a static capacity")
    for k in ("knn_select", "fps"):
        if launches[k] <= 0:
            fail(f"driver {label}: kernel {k} was not launched")
    if any(r["fg_points"] <= 0 for r in summary["scenes"]):
        fail(f"driver {label}: a scene had no foreground point")
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


# K3 on a table of more than 2^31 words ([K3_BIG_ROWS, 128] f32, 8.6 GB):
# ids at its end, where a 32-bit word offset would wrap
K3_BIG_ROWS = 16777472


def k3_large_table(torch) -> list:
    """K3 bit-equal to its plain version on a table of more than 2^31 words,
    [K3_BIG_ROWS, 128] (rows of 32 16-byte units) and the same buffer viewed
    as rows of 1,024 words (the per-unit kernel), each aligned (16-byte
    units) and viewed one word in (words): its last rows and its first,
    seeded, gathered by ids at both ends."""
    from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain

    words = K3_BIG_ROWS * 128
    flat = torch.zeros(words + 1, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ends = 64 * 1024 + 1
    flat[:ends] = torch.randn(ends, generator=gen, device="cuda")
    flat[-ends:] = torch.randn(ends, generator=gen, device="cuda")
    cases = []
    for q in (128, 1024):
        p = words // q
        idx = torch.cat([torch.arange(p - 64, p), torch.arange(0, 64),
                         torch.arange(p - 1, p - 65, -1)]).to(torch.int32).cuda()
        for misaligned in (False, True):
            x = flat[int(misaligned):int(misaligned) + words].view(p, q)
            ok = torch.equal(bits(torch, row_gather(x, idx)), bits(torch, row_gather_plain(x, idx)))
            cases.append({"kernel": "row_gather", "case": "over_2^31_words",
                          "shape": [p, q, idx.numel()], "words": words,
                          "misaligned": misaligned, "equal": ok})
    del flat, x
    torch.cuda.empty_cache()
    return cases


def kernel_edges(torch) -> dict:
    """K1, K2 and K3 bit-equal to their plain versions on the corner cases
    of their designs (K3 also on a table of more than 2^31 words), K1's
    exact path taken by no row that its design must sort and by every row
    that it must send there (``knn_path_rows``), and the time of K2's chain
    of picks with no distance to update (an all-invalid scene of the main
    path's size)."""
    from geoformer_tpu_torch.kernels.edge_cases import (
        fps_cases,
        gather_cases,
        gather_table,
        knn_cases,
        knn_path_rows,
    )
    from geoformer_tpu_torch.kernels.fps import cluster_size, fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain

    cases, bad = [], []
    for name, d2_np, cand, k in knn_cases():
        d2, cand = torch.from_numpy(d2_np).cuda(), torch.from_numpy(cand).cuda()
        rows = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = select_min_k_cand(d2, cand, k, exact_rows=rows)
        want = select_min_k_cand_plain(d2, cand, k)
        ok = all(torch.equal(bits(torch, g), bits(torch, w)) for g, w in zip(got, want))
        cases.append({"kernel": "knn_select", "case": name, "shape": [*d2.shape, k],
                      "exact_rows": int(rows), "equal": ok})
        bad += [] if ok else [f"knn_select {name}"]
        sort, to_exact = knn_path_rows(name, d2_np, k)
        for mask, want in ((sort, 0), (to_exact, int(to_exact.sum()))):
            rows.zero_()
            pick = torch.from_numpy(mask).cuda()
            select_min_k_cand(d2[pick], cand[pick], k, exact_rows=rows)
            bad += [] if int(rows) == want else [f"knn_select {name} exact rows"]
    for name, pts, msk, ns in fps_cases():
        pts, msk = torch.from_numpy(pts).cuda(), torch.from_numpy(msk).cuda()
        ok = torch.equal(fps(pts, msk, ns), fps_plain(pts, msk, ns))
        cases.append({"kernel": "fps", "case": name, "shape": [*pts.shape[:2], ns],
                      "cluster_size": cluster_size(pts.shape[1]), "equal": ok})
        bad += [] if ok else [f"fps {name}"]
    for name, x, idx, misaligned in gather_cases():
        x, idx = gather_table(x, misaligned, "cuda"), torch.from_numpy(idx).cuda()
        ok = torch.equal(bits(torch, row_gather(x, idx)), bits(torch, row_gather_plain(x, idx)))
        cases.append({"kernel": "row_gather", "case": name, "shape": [*x.shape, idx.numel()],
                      "misaligned": misaligned, "equal": ok})
        bad += [] if ok else [f"row_gather {name}"]
    large = k3_large_table(torch)
    cases += large
    bad += [f"row_gather {c['case']} {c['shape']}" for c in large if not c["equal"]]
    p, ns = 50000, 2048
    pts = torch.zeros(1, p, 3, device="cuda")
    none = torch.zeros(1, p, dtype=torch.bool, device="cuda")
    floor_ms = time_ms(torch, lambda: fps(pts, none, ns), 10)
    res = {"phase": "kernel_edges", "cases": cases,
           "fps_chain": {"shape": [1, p, ns], "cluster_size": cluster_size(p), "ms": floor_ms,
                         "us_per_pick": floor_ms * 1e3 / (ns - 1)}}
    emit(res)
    if bad:
        fail(f"kernels disagree with their plain versions on {bad}")
    return res



# ---------------- the config-reachable off-path branches ----------------

# offpath (b): the crop of the scene's graph on which the exact solve is held
# bit-equal between the card and the CPU: its first OFFPATH_CROP foreground
# points and OFFPATH_SEEDS seeds spread over them
OFFPATH_CROP = 16384
OFFPATH_SEEDS = 64
# offpath (c): tpu_knn_window of the compacted-window arms
OFFPATH_WINDOWS = (64, 128)
# offpath (e): the compact conv's tpu_subm_k (the scene's largest live
# count joins them where it is below 27: a k that drops nothing)
OFFPATH_SUBM_K = (9, 18)


def check_eval_out(torch, out, P, F, Q, C) -> None:
    """Engine.eval_batch's outputs of one scene: shapes and finite values."""
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


def offpath_eval(torch, engine, batch, counters, name: str) -> dict:
    """One Engine.eval_batch with the kernels' counts set to 0 just before and
    read just after; kept for the later checks: the geodesic stage's inputs
    and table, the aggregator's ball-query inputs and K1's input table at
    each shape (CallLog keep). Stage ms (each stage closed by a synchronize),
    sweeps, peak memory, capacity counters."""
    from geoformer_tpu_torch.cli.test import CAPACITY_COUNTERS

    model = engine.model
    mc = model.mc
    kept = {}
    solve, group = model.forward_geodesic, model.set_aggregator.group

    def keep_solve(*a, **kw):
        r = solve(*a, **kw)
        kept.update(geo_inputs=a[:4], geo=r[0])
        return r

    def keep_group(points, feats, mask, npoint):
        r = group(points, feats, mask, npoint)
        kept.update(ball_inputs=(r[0], points, mask))
        return r

    model.forward_geodesic, model.set_aggregator.group = keep_solve, keep_group
    for fn in counters.values():
        fn.launches = 0
    knn_log = counters["knn_select"].capture = CallLog(keep=True)
    fps_log = counters["fps"].capture = CallLog()
    model.stage_ms = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        out = engine.eval_batch(batch)
        torch.cuda.synchronize()
    finally:
        ms = (time.perf_counter() - t) * 1e3
        counters["knn_select"].capture = counters["fps"].capture = None
        del model.forward_geodesic, model.set_aggregator.group
        stage_ms, model.stage_ms = model.stage_ms, None
    launches = read_launches(counters, fps_log)
    launches["knn_select_by_shape"] = knn_log.by_shape()
    check_eval_out(torch, out, batch["points"].shape[1], mc.max_fg_points, mc.n_query_points,
                   mc.classes)
    vs = {k: int(out["voxel_stats"][k].sum()) for k in CAPACITY_COUNTERS}
    geo = kept["geo"]
    steps = mc.geodesic_steps_eval
    pp = -(-geo.shape[1] // 512) * 512
    res = {"phase": "offpath_eval", "variant": name, "ms": ms, "stage_ms": stage_ms,
           "sweeps": model.geodesic_passes, "stopped_at_cap": model.geodesic_passes[0] >= steps,
           "geodesic_steps_eval": steps, "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           # the solver's relaxation table [PP + 1, Q] (sink row included)
           "table_mb": (pp + 1) * geo.shape[2] * (2 if mc.geodesic_int16 else 4) / 1e6,
           "fg_points": int(out["fg_valid"].sum()), "reached_share": float((geo >= 0).float().mean()),
           "capacity_counters": vs, "launches": launches}
    emit(res)
    if any(vs.values()):
        fail(f"offpath {name}: a capacity counter is not 0: {vs}")
    for k in ("knn_select", "fps"):
        if launches[k] <= 0:
            fail(f"offpath {name}: kernel {k} was not launched")
    want = json.dumps([mc.max_fg_points, 27 * mc.radius_cell_cap, mc.knn_neighbors])
    if launches["knn_select_by_shape"].get(want, 0) != launches["knn_select"]:
        fail(f"offpath {name}: K1 ran at {launches['knn_select_by_shape']}, expected {want}")
    return {"res": res, "kept": kept, "knn_log": knn_log}


def bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(bits(torch, a.cpu()), bits(torch, b.cpu()))


def offpath_crop(torch, mc, kept) -> dict:
    """The exact solve (float32 and int16) on a crop of the scene's graph,
    bit-equal between the card and the CPU, its seed columns solved in two
    halves on the card equal to the whole; the crop's graph (K1 on the card,
    its plain version on the CPU) bit-equal too."""
    from geoformer_tpu_torch.ops.geodesic import geodesic_distance
    from geoformer_tpu_torch.ops.radius_graph import radius_knn

    fg_locs, fg_valid = kept["geo_inputs"][:2]
    locs = fg_locs[:, :OFFPATH_CROP].contiguous()
    valid = fg_valid[:, :OFFPATH_CROP].contiguous()
    kw = dict(cell_cap=mc.radius_cell_cap, cell_div=mc.radius_cell_div,
              dense_grid=mc.knn_dense_grid, select=mc.knn_select)
    res = {"phase": "offpath_crop", "points": OFFPATH_CROP, "seeds": OFFPATH_SEEDS}
    graphs = {}
    for dev in ("cuda", "cpu"):
        d2, idx, _, _ = radius_knn(locs.to(dev), valid.to(dev), mc.geodesic_radius,
                                   mc.knn_neighbors, **kw)
        graphs[dev] = (idx, torch.sqrt(d2.clamp(max=4.0).clamp(min=0.0).double()).float())
    res["graph_equal"] = all(bits_equal(torch, a, b) for a, b in zip(graphs["cuda"], graphs["cpu"]))
    seeds = (torch.arange(OFFPATH_SEEDS) * (OFFPATH_CROP // OFFPATH_SEEDS))[None]
    seed_mask = valid.cpu()[:, seeds[0]]
    card = [t.cuda() for t in (*graphs["cuda"], seeds, seed_mask, valid, locs)]
    cpu = [t.cpu() for t in card]
    half = OFFPATH_SEEDS // 2

    def solve(a, cols, int16):
        return geodesic_distance(a[0], a[1], a[2][:, cols], a[3][:, cols], a[4],
                                 mc.geodesic_radius, mc.geodesic_steps_eval, symmetrize=False,
                                 positions=a[5], int16=int16)

    def timed(a, int16):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = solve(a, slice(None), int16)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    ok = res["graph_equal"]
    for int16 in (False, True):
        (g_card, s_card), card_ms = timed(card, int16)
        (g_cpu, s_cpu), cpu_ms = timed(cpu, int16)
        halves = torch.cat([solve(card, slice(0, half), int16)[0],
                            solve(card, slice(half, None), int16)[0]], dim=2)
        r = {"card_equals_cpu": bits_equal(torch, g_card, g_cpu),
             "halves_equal_whole": bits_equal(torch, halves, g_card),
             "sweeps_card": s_card, "sweeps_cpu": s_cpu, "card_ms": card_ms, "cpu_ms": cpu_ms,
             "reached_share": float((g_cpu >= 0).float().mean())}
        res["int16" if int16 else "float32"] = r
        ok = ok and r["card_equals_cpu"] and r["halves_equal_whole"] and s_card == s_cpu
    emit(res)
    if not ok:
        fail("offpath: the exact solve on the crop differs between the card and the CPU")
    return res


def offpath_knn(torch, mc, kept) -> dict:
    """radius_knn at the scene's foreground shape (k = tpu_knn_neighbors, the
    exact solver's graph) in each off-path arm against the shipped arm
    (dense grid, K1): the exact arms bit-equal; the compacted window exact
    where it counts no overflowing window (counted where it does); sort=False
    the same edge set on every row whose in-radius count is <= k."""
    from geoformer_tpu_torch.ops.radius_graph import radius_knn

    fg_locs, fg_valid = kept["geo_inputs"][:2]
    k = mc.knn_neighbors
    base = dict(cell_cap=mc.radius_cell_cap, cell_div=mc.radius_cell_div, dense_grid=256,
                select="pallas")

    def run(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = radius_knn(fg_locs, fg_valid, mc.geodesic_radius, kw.pop("k", k),
                         **dict(base, **kw))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    (ref_d2, ref_idx, ref_drop, _), ref_ms = run()
    # every in-radius candidate of a row: the whole window, sorted
    (all_d2, _, _, _), _ = run(k=27 * mc.radius_cell_cap, select="topk")
    in_radius = (all_d2 < 1e30).sum(dim=-1)
    del all_d2
    arms = {"dense_grid_0": dict(dense_grid=0), "cellwin": dict(cellwin=True),
            "topk": dict(select="topk"), "passes": dict(select="passes"),
            "approx": dict(select="approx"), "unsorted": dict(sort=False),
            **{f"window_{w}": dict(window=w) for w in OFFPATH_WINDOWS}}
    res = {"phase": "offpath_knn", "shape": list(fg_locs.shape), "k": k, "shipped_ms": ref_ms,
           "rows_over_k_in_radius": int((in_radius > k).sum()),
           "max_in_radius": int(in_radius.max()), "arms": {}}
    bad = []
    for name, kw in arms.items():
        (d2, idx, drop, wovf), ms = run(**kw)
        r = {"kw": kw, "ms": ms, "n_dropped": int(drop.sum()), "n_window_pts": int(wovf.sum())}
        if name == "unsorted":
            # the same edges (ids and their d2) as sets, where count <= k
            rows = in_radius <= k
            si, oi = torch.sort(idx, dim=-1)
            ri, orf = torch.sort(ref_idx, dim=-1)
            same = (si == ri).all(-1) & (bits(torch, torch.gather(d2, -1, oi))
                                         == bits(torch, torch.gather(ref_d2, -1, orf))).all(-1)
            r.update(rows_checked=int(rows.sum()), rows_differing=int((rows & ~same).sum()))
            ok = r["rows_differing"] == 0
        else:
            diff = ((idx != ref_idx) | (bits(torch, d2) != bits(torch, ref_d2))).any(-1)
            r["rows_differing"] = int(diff.sum())
            window = name.startswith("window")
            ok = r["rows_differing"] == 0 or (window and r["n_window_pts"] > 0)
        ok = ok and r["n_dropped"] == int(ref_drop.sum())
        if not name.startswith("window"):
            ok = ok and r["n_window_pts"] == 0
        res["arms"][name] = r
        bad += [] if ok else [name]
        del d2, idx
    emit(res)
    if bad:
        fail(f"offpath: radius_knn arms {bad} disagree with the shipped arm")
    return res


def offpath_ball_query(torch, mc, kept) -> dict:
    """The brute-force ball query (tpu_ball_cell_cap 0) at the aggregator's
    shapes against the voxel-hash path at a cell cap that does not bind
    (the scene's largest cell): each center's hits the same points, and a
    center with nsample hits the same ids in the same order. A center with
    fewer hits is laid out differently by the two JAX paths, which the port
    keeps: the brute force sorts the picked lanes by index, so misses (the
    lowest-index points outside the ball) sit among the hits and the pads
    repeat lane 0; the hash path puts the hits first and repeats the first
    hit. At the shipped cap the points the hash path drops and the centers
    whose hits differ are reported."""
    from geoformer_tpu_torch.ops.ball_query import ball_query
    from geoformer_tpu_torch.ops.radius_graph import build_cell_table

    centers, points, mask = kept["ball_inputs"]
    r, ns = mc.ball_radius, mc.ball_nsample
    grid = build_cell_table(points[0], mask[0], r, points.shape[1], 1)[0]
    max_cell = int(grid.counts.max())

    def run(cap):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx, hit = ball_query(centers, points, mask, r, ns, cap)
        torch.cuda.synchronize()
        # each center's hit ids, ascending, misses as P
        hits = torch.sort(torch.where(hit, idx, points.shape[1]), dim=-1)[0]
        return idx, hit, hits, (time.perf_counter() - t) * 1e3

    bi, bh, b_hits, brute_ms = run(0)
    wi, wh, w_hits, wide_ms = run(max_cell)
    _, _, s_hits, shipped_ms = run(mc.ball_cell_cap)
    full = bh.all(-1)
    dropped = int(build_cell_table(points[0], mask[0], r, points.shape[1], mc.ball_cell_cap)[4])
    res = {"phase": "offpath_ball_query", "centers": list(centers.shape[:2]),
           "points": list(points.shape[:2]), "radius": r, "nsample": ns, "brute_ms": brute_ms,
           "centers_with_fewer_hits": int((~full).sum()), "hit_share": float(bh.float().mean()),
           "largest_cell": max_cell, "hash_ms_at_largest_cell": wide_ms,
           "equal_at_largest_cell": bool(torch.equal(b_hits, w_hits) and torch.equal(
               bi[full], wi[full]) and torch.equal(wh, torch.sort(wh.byte(), -1, True)[0].bool())),
           "shipped_cell_cap": mc.ball_cell_cap, "hash_ms_at_shipped_cap": shipped_ms,
           "points_dropped_at_shipped_cap": dropped,
           "centers_differing_at_shipped_cap": int((b_hits != s_hits).any(-1).sum())}
    emit(res)
    if not res["equal_at_largest_cell"]:
        fail("offpath: the brute-force ball query disagrees with the hash path")
    if dropped == 0 and res["centers_differing_at_shipped_cap"]:
        fail("offpath: the ball query differs at a cell cap that drops no point")
    return res


def offpath_subm(torch, cfg, engine, batch) -> dict:
    """The backbone with the compact conv (tpu_subm_k of OFFPATH_SUBM_K and
    the scene's largest live count, no bricks) against the exact 27-slot
    conv on the same weights: the largest live-offset count of each U-Net
    level, and the semantic scores and point features, bit-equal where
    every voxel's count is <= k (the compact table expands to the same
    27-slot map), their distance reported where not."""
    from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
    from geoformer_tpu_torch.ops.sparse_conv import build_grid_plan, voxel_capacities

    mc = engine.model.mc
    with torch.no_grad():
        tb = engine.to_device(batch)
        plan = build_grid_plan(tb["coords"], tb["point_mask"], mc.spatial, mc.depth,
                               voxel_capacities(mc.max_voxels, mc.depth, mc.voxel_decay))
        live = [int((n < n.shape[1]).sum(-1).max()) for n in plan.subm]
        del plan
        feats, scores = engine.model.forward_backbone(tb)[:2]
        res = {"phase": "offpath_subm", "max_live_offsets_by_level": live, "k": {}}
        bad = []
        for k in OFFPATH_SUBM_K + ((max(live),) if max(live) < 27 else ()):
            model = GeoFormer(ModelConfig.from_cfg(cfg.replace(tpu_subm_k=k,
                                                               tpu_brick_occupancy=0)))
            model.load_state_dict(engine.model.state_dict())
            model = model.to(engine.device).eval()
            torch.cuda.synchronize()
            t = time.perf_counter()
            f, s = model.forward_backbone(tb)[:2]
            torch.cuda.synchronize()
            binds = max(live) > k
            r = {"ms": (time.perf_counter() - t) * 1e3, "binds": binds,
                 "levels_binding": [lvl for lvl, n in enumerate(live) if n > k],
                 "point_feats_max_abs_diff": float((f - feats).abs().max()),
                 "semantic_max_abs_diff": float((s - scores).abs().max()),
                 "bit_equal": bits_equal(torch, f, feats) and bits_equal(torch, s, scores)}
            res["k"][k] = r
            bad += [] if binds or r["bit_equal"] else [k]
            del model, f, s
    emit(res)
    if bad:
        fail(f"offpath: the compact conv at k = {bad} differs where no voxel has more live offsets")
    return res


def offpath(torch, cfg_mod, Engine, synthetic_batch, counters) -> dict:
    """The config-reachable off-path branches at the full eval capacity of
    config/test_geoformer_scannet.yaml on one synthetic scene: (a) two
    counted Engine.eval_batch runs with the exact geodesic solver, float32
    then int16, and int16's largest distance from float32; (b) the crop
    held bit-equal card/CPU; (c) the radius_knn arms; (d) the brute-force
    ball query; (e) the compact conv; and K1 held against its plain
    version at the exact solver's table (k = 64). Returns the runs' launches
    by path and K1's row at that shape."""
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand, select_min_k_cand_plain

    cfg = cfg_mod.scannet_eval_config()
    batch = synthetic_batch(cfg, 1, seed=0)
    t0 = time.time()
    engine = Engine(cfg.replace(tpu_geodesic_hier=False), seed=0)
    runs = {"exact": offpath_eval(torch, engine, batch, counters, "exact")}
    runs["int16"] = offpath_eval(torch, Engine(cfg.replace(
        tpu_geodesic_hier=False, tpu_geodesic_int16=True), seed=0), batch, counters, "int16")
    torch.cuda.empty_cache()
    a, b = runs["exact"]["kept"]["geo"], runs["int16"]["kept"].pop("geo")
    both = (a >= 0) & (b >= 0)
    emit({"phase": "offpath_int16", "max_abs_m": float((a - b).abs()[both].max()),
          "mean_abs_m": float((a - b).abs()[both].mean()),
          "reached_differs": int(((a >= 0) != (b >= 0)).sum())})
    del a, b, both
    runs["int16"]["kept"].clear()
    kept = runs["exact"]["kept"]
    mc = engine.model.mc
    offpath_crop(torch, mc, kept)
    offpath_knn(torch, mc, kept)
    offpath_ball_query(torch, mc, kept)
    offpath_subm(torch, cfg, engine, batch)
    del engine
    kept.clear()
    torch.cuda.empty_cache()

    # K1 at the exact solver's table, held against its plain version; its
    # launches are those of the two counted runs at that shape
    shape = (mc.max_fg_points, 27 * mc.radius_cell_cap, mc.knn_neighbors)
    d2, cand, k = runs["exact"]["knn_log"].first[shape]
    n, w = d2.shape
    key = json.dumps(list(shape))
    row = kernel_row(
        torch, name="knn_select", source="geoformer_tpu_torch/csrc/knn_select.cu",
        replaces="geoformer_tpu/ops/knn_select_pallas.py:34",
        launches=sum(r["res"]["launches"]["knn_select_by_shape"][key] for r in runs.values()),
        kernel=lambda: select_min_k_cand(d2, cand, k),
        plain=lambda: select_min_k_cand_plain(d2, cand, k),
        library=lambda: torch.topk(d2, k, dim=1, largest=False),
        bytes_=n * w * 4 + n * k * 4 + n * k * 8, ops=n * w * k, shape=[n, w, k],
        reps=20, plain_reps=3, exact_share=exact_share(torch, select_min_k_cand, d2, cand, k))
    row["launches_by_path"] = {f"offpath_{name}": r["res"]["launches"]["knn_select"]
                               for name, r in runs.items()}
    del d2, cand, runs["exact"]["knn_log"].first[shape]
    # the same shape on two tables that no path makes at k = 64, on kernel
    # lines of their own with no launch count: uniform d2 live in every
    # lane (c near 128 at the k-th pair value), then with the row's
    # smallest values packed in 7 lanes' slots (c > 128: the exact path's
    # cost)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d2 = torch.rand(n, w, generator=gen, device="cuda")
    cand = torch.randint(0, n, (n, w), generator=gen, device="cuda", dtype=torch.int32)
    for table in ("all_live_uniform", "packed_in_7_lanes"):
        if table == "packed_in_7_lanes":
            d2 += (torch.arange(w, device="cuda") % 32 >= 7).float()
        kernel_row(
            torch, name="knn_select", source="geoformer_tpu_torch/csrc/knn_select.cu",
            replaces="geoformer_tpu/ops/knn_select_pallas.py:34", launches=None,
            kernel=lambda: select_min_k_cand(d2, cand, k),
            plain=lambda: select_min_k_cand_plain(d2, cand, k),
            library=lambda: torch.topk(d2, k, dim=1, largest=False),
            bytes_=n * w * 4 + n * k * 4 + n * k * 8, ops=n * w * k, shape=[n, w, k],
            reps=20, plain_reps=3, table=table,
            exact_share=exact_share(torch, select_min_k_cand, d2, cand, k))
    del d2, cand
    emit({"phase": "offpath_done", "seconds": time.time() - t0})
    return {"by_path": {f"offpath_{name}": r["res"]["launches"] for name, r in runs.items()},
            "k1": row}


# ---------------- the library ops and host tools ----------------

# library: the seed of its synthetic inputs, and the queries (of 131,072) and
# ball-query centers whose rows the CPU recomputes (a row of kNN or of the
# dense ball query depends on its own query and all points only)
LIB_SEED = 11
LIB_CPU_ROWS = 2048
# the shapes of a real scene: the forward's 131,072 foreground points, the
# aggregator's 2,048 centers among 50,000 points, a 250,000-point scene with
# 256 proposals and 40 instances
LIB_SIZES = {"fg": 131072, "centers": 2048, "agg_points": 50000, "channels": 128,
             "segment_channels": 32, "segments": 256, "scene": 250000, "proposals": 256,
             "instances": 40}
# bfs_cluster at PointGroup's settings
LIB_CLUSTER = {"radius": 0.03, "nsample": 64, "min_cluster": 50}


def on(tensors, device):
    return [t.to(device) for t in tensors]


def near_tie_rows(torch, queries, points, got_i, want_i, k) -> tuple:
    """Rows where two kNN index lists differ -> (their number, whether each
    sits at a near-tie: the exact float64 gap between the k-th and
    (k+1)-th neighbour under 1e-5 relative, which the matmul trick's
    rounding can swap)."""
    rows = torch.nonzero((got_i != want_i).any(-1)).flatten().tolist()
    ok = True
    p = points.double()
    for r in rows:
        d = ((p - queries[r].double()) ** 2).sum(-1)
        kth, nxt = torch.sort(d)[0][k - 1:k + 1].tolist()
        ok &= nxt - kth <= 1e-5 * max(kth, 1e-12)
    return len(rows), ok


def lib_emit(name: str, equal: bool, failure: str = "on the card disagrees with the CPU run",
             **res) -> dict:
    res = {"phase": f"library_{name}", "equal": bool(equal), **res}
    emit(res)
    if not equal:
        fail(f"library: {name} {failure}")
    return res


def library_knn(torch, rng) -> dict:
    """knn at [1, 131072] queries x [1, 131072] points, k = 16 (the size of
    the radius graph that the reference's FAISS call served): the points of
    a room scan queried against themselves. The CPU recomputes the first
    LIB_CPU_ROWS rows."""
    from geoformer_tpu_torch.ops.knn import knn
    from geoformer_tpu_torch.synthetic import room_points

    k, n = 16, LIB_SIZES["fg"]
    pts = torch.from_numpy(room_points(rng, n))[None]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    gp, gm = on((pts, mask), "cuda")
    (gd, gi), ms = timed(torch, lambda: knn(gp, gp, gm, k))
    (cd, ci), cpu_ms = timed(torch, lambda: knn(pts[:, :LIB_CPU_ROWS], pts, mask, k))
    gd, gi = gd[0, :LIB_CPU_ROWS].cpu(), gi[0, :LIB_CPU_ROWS].cpu()
    n_ties, ties_ok = near_tie_rows(torch, pts[0], pts[0], gi, ci[0], k)
    same = gi == ci[0]
    err = float(((gd - cd[0]).abs() / cd[0].abs().clamp(min=1e-30))[same].max())
    return lib_emit("knn", ties_ok and err <= 1e-6, shape=[1, n, n, k],
                    ms=ms, cpu_ms=cpu_ms, cpu_rows=LIB_CPU_ROWS, near_tie_rows=n_ties,
                    max_rel_err_d2=err, tol="ids equal but at near-ties; d2 rtol 1e-6")


def library_interpolate(torch, rng) -> dict:
    """three_nn + three_interpolate from 2,048 centers to 50,000 points of a
    room scan, C = 128, on the card and on the CPU."""
    from geoformer_tpu_torch.ops import interpolate
    from geoformer_tpu_torch.synthetic import room_points

    n, m, c = LIB_SIZES["agg_points"], LIB_SIZES["centers"], LIB_SIZES["channels"]
    pts = room_points(rng, n)
    unknown = torch.from_numpy(pts)[None]
    known = torch.from_numpy(pts[rng.choice(n, m, replace=False)])[None]
    kmask = torch.ones(1, m, dtype=torch.bool)
    feats = torch.from_numpy(rng.normal(size=(1, c, m)).astype(np.float32))

    def run(u, kn, km, f):
        d, i = interpolate.three_nn(u, kn, km)
        return d, i, interpolate.three_interpolate(f, i, interpolate.three_interpolate_weights(d))

    (gd, gi, go), ms = timed(torch, lambda: run(*on((unknown, known, kmask, feats), "cuda")))
    (cd, ci, co), cpu_ms = timed(torch, lambda: run(unknown, known, kmask, feats))
    gd, gi, go = gd.cpu(), gi.cpu(), go.cpu()
    n_ties, ties_ok = near_tie_rows(torch, unknown[0], known[0], gi[0], ci[0], 3)
    same = (gi == ci).all(-1)[0]
    d_err = float(((gd - cd).abs() / cd.abs().clamp(min=1e-30))[0][same].max())
    out_ok = torch.allclose(go[0][:, same], co[0][:, same], rtol=1e-5, atol=1e-6)
    return lib_emit("interpolate", ties_ok and d_err <= 1e-6 and out_ok,
                    shape={"unknown": n, "known": m, "channels": c}, ms=ms,
                    cpu_ms=cpu_ms, near_tie_rows=n_ties, max_rel_err_dist=d_err,
                    max_abs_err_out=float((go - co).abs().max()),
                    tol="ids as knn; dist rtol 1e-6; out rtol 1e-5, atol 1e-6")


def library_segments(torch, rng) -> dict:
    """sec_mean / sec_min / sec_max / roipool and roipool's gradient over
    131,072 rows x 32 channels in 256 segments, one of them empty, with
    overflow rows after the last offset."""
    from geoformer_tpu_torch.ops import segment_ops

    n, c, m = LIB_SIZES["fg"], LIB_SIZES["segment_channels"], LIB_SIZES["segments"]
    sizes = rng.integers(0, 2 * n // m, m)
    sizes[m // 2] = 0
    sizes = (sizes * (n - n // 128) / sizes.sum()).astype(np.int64)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]))
    feats = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32))

    def run(f, o, up):
        f = f.clone().requires_grad_(True)
        outs = [segment_ops.sec_mean(f, o), segment_ops.sec_min(f, o), segment_ops.sec_max(f, o)]
        pooled = segment_ops.roipool(f, o)
        (pooled * up).sum().backward()
        return [x.detach() for x in outs + [pooled]] + [f.grad]

    got, ms = timed(torch, lambda: run(*on((feats, offsets, g), "cuda")))
    want, cpu_ms = timed(torch, lambda: run(feats, offsets, g))
    got = [x.cpu() for x in got]
    exact = all(torch.equal(a, b) for a, b in zip(got[1:4], want[1:4]))
    close = [torch.allclose(got[i], want[i], rtol=1e-6, atol=1e-6) for i in (0, 4)]
    return lib_emit("segments", exact and all(close),
                    shape=[n, c, m], empty_segments=int((sizes == 0).sum()),
                    overflow_rows=n - int(offsets[-1]), ms=ms, cpu_ms=cpu_ms,
                    min_max_roipool_equal=exact,
                    max_abs_err_mean=float((got[0] - want[0]).abs().max()),
                    max_abs_err_roipool_grad=float((got[4] - want[4]).abs().max()),
                    tol="min/max/roipool exact; mean and roipool grad rtol 1e-6, atol 1e-6")


def library_iou_nms(torch, rng) -> dict:
    """get_iou and greedy_nms over [256, 250000] proposal masks (balls
    around 40 instance centers of a room scan, jittered) and the 40
    instances' masks; scores with ties, a tenth of the proposals invalid."""
    from geoformer_tpu_torch.ops import nms, segment_ops
    from geoformer_tpu_torch.synthetic import room_points

    n, q, i = LIB_SIZES["scene"], LIB_SIZES["proposals"], LIB_SIZES["instances"]
    pts = torch.from_numpy(room_points(rng, n))
    centers = pts[torch.from_numpy(rng.choice(n, i, replace=False))]
    inst = torch.cdist(centers, pts) < 0.3
    pc = centers[torch.arange(q) % i] + torch.from_numpy(
        rng.normal(0, 0.05, (q, 3)).astype(np.float32))
    radius = torch.from_numpy(rng.uniform(0.2, 0.4, (q, 1)).astype(np.float32))
    props = torch.cdist(pc, pts) < radius
    scores = torch.from_numpy(np.round(rng.random(q), 2).astype(np.float32))
    valid = torch.from_numpy(rng.random(q) > 0.1)

    def run(p, i, s, v):
        return segment_ops.get_iou(p, i), nms.greedy_nms(p, s, v, 0.3)

    (giou, gkeep), ms = timed(torch, lambda: run(*on((props, inst, scores, valid), "cuda")))
    (ciou, ckeep), cpu_ms = timed(torch, lambda: run(props, inst, scores, valid))
    equal = torch.equal(giou.cpu(), ciou) and torch.equal(gkeep.cpu(), ckeep)
    return lib_emit("iou_nms", equal, shape={"proposals": q, "points": n, "instances": i},
                    ms=ms, cpu_ms=cpu_ms,
                    kept=int(ckeep.sum()), valid=int(valid.sum()), tol="exact")


def library_cluster(torch, rng) -> dict:
    """bfs_cluster over 131,072 points of a shuffled 250,000-point room scan
    with its surfaces' labels (floor, three walls, furniture boxes) at
    PointGroup's settings. The CPU recomputes LIB_CPU_ROWS rows of the
    dense ball query, then the clustering on the card's ball-query table.
    Beside them: the components' time, and how many of their rounds change
    the labels (a round that changes none is a fixed point)."""
    from geoformer_tpu_torch.ops import cluster
    from geoformer_tpu_torch.ops.ball_query import ball_query
    from geoformer_tpu_torch.synthetic import room_scan

    n = LIB_SIZES["fg"]
    pts, part = room_scan(rng, LIB_SIZES["scene"])
    keep = rng.permutation(LIB_SIZES["scene"])[:n]
    points = torch.from_numpy(pts[keep])
    sem = torch.from_numpy(part[keep].astype(np.int64))
    valid = torch.ones(n, dtype=torch.bool)
    r, ns, mc = LIB_CLUSTER["radius"], LIB_CLUSTER["nsample"], LIB_CLUSTER["min_cluster"]
    gp, gs, gv = on((points, sem, valid), "cuda")
    table, ball_ms = timed(torch, lambda: cluster.ballquery_dense(gp, gv, r, ns))
    (groots, gkeep), ms = timed(torch, lambda: cluster.bfs_cluster(gs, gp, gv, r, ns, mc))
    rows = torch.arange(LIB_CPU_ROWS)
    (ci, ch), ball_cpu_ms = timed(torch, lambda: ball_query(
        points[None, :LIB_CPU_ROWS], points[None], valid[None], r, ns))
    ball_equal = torch.equal(table[0][rows].cpu(), ci[0]) and torch.equal(
        table[2][rows].cpu(), ch[0])
    card_table = tuple(t.cpu() for t in table)
    dense = cluster.ballquery_dense
    cluster.ballquery_dense = lambda *a: card_table
    try:
        (croots, ckeep), cpu_ms = timed(torch, lambda: cluster.bfs_cluster(
            sem, points, valid, r, ns, mc))
    finally:
        cluster.ballquery_dense = dense
    equal = ball_equal and torch.equal(groots.cpu(), croots) and torch.equal(gkeep.cpu(), ckeep)

    # the components alone, and the rounds that change the labels
    idx, _, nbr = table
    fg = gv & (gs >= 0)
    edge = nbr & (gs[idx] == gs[:, None]) & fg[:, None] & fg[idx]
    cap = max(2 * n.bit_length(), 8)
    _, cc_ms = timed(torch, lambda: cluster.connected_components(idx, edge, fg))
    labels = labels0 = torch.arange(n, device=gp.device)
    changing = 0
    for _ in range(cap):
        new = cluster._round(labels, idx, edge, fg, labels0)
        changing += not torch.equal(new, labels)
        labels = new
    sizes = torch.bincount(croots[ckeep])
    return lib_emit("cluster", equal, points=n, **LIB_CLUSTER, ms=ms, cpu_ms=cpu_ms,
                    ballquery_ms=ball_ms, ballquery_cpu_ms_rows=ball_cpu_ms,
                    cpu_rows=LIB_CPU_ROWS, rounds=cap, rounds_changing=changing,
                    components_ms=cc_ms,
                    clusters_kept=int((sizes > 0).sum()), points_kept=int(ckeep.sum()),
                    tol="exact")


def library_elastic(torch, cfg) -> dict:
    """The native elastic (must be the path that runs: a failed g++ build
    fails here) on one 250,000-point scene of the smoke dataset, timed
    against the numpy/scipy fallback on this host, and the training scene
    build (affine, two elastic passes, crop) on each path."""
    import scipy.interpolate  # noqa: F401  (imported before the fallback's timing)
    import scipy.ndimage  # noqa: F401

    from geoformer_tpu_torch import native
    from geoformer_tpu_torch.data.augment import elastic
    from geoformer_tpu_torch.data.scannet import InstDataset

    if not native.available():
        fail(f"library: the native host library did not build: {native.build_error}")
    ds = InstDataset(cfg, "val")
    xyz = ds.load_raw(0)[0] * ds.scale

    def passes():
        rng = np.random.default_rng(LIB_SEED)
        x = elastic(xyz, 6 * ds.scale // 50, 40 * ds.scale / 50, rng)
        return elastic(x, 20 * ds.scale // 50, 160 * ds.scale / 50, rng)

    def scene():
        return ds.build_scene(0, np.random.default_rng(LIB_SEED), True)

    got, ms = timed(torch, passes)
    _, scene_ms = timed(torch, scene)
    lib = native.get_lib
    native.get_lib = lambda: None
    try:
        want, scipy_ms = timed(torch, passes)
        _, scene_scipy_ms = timed(torch, scene)
    finally:
        native.get_lib = lib
    err = float(np.abs(got - want).max())
    return lib_emit("elastic", err <= 1e-3, points=len(xyz), native=True, native_ms=ms,
                    scipy_ms=scipy_ms, build_scene_native_ms=scene_ms,
                    build_scene_scipy_ms=scene_scipy_ms, max_abs_diff_voxels=err,
                    tol="native within 1e-3 voxel units of numpy/scipy")


def ply_labels(path: str, palette) -> np.ndarray:
    """The semantic labels a ``color_semantic`` PLY encodes (palette index
    of each point's color)."""
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    rgb = np.array([ln.split()[3:] for ln in body], np.int64)
    key = lambda c: (c[..., 0] * 256 + c[..., 1]) * 256 + c[..., 2]
    lookup = {int(k): i for i, k in enumerate(key(palette.astype(np.int64)))}
    if len(lookup) != len(palette):
        fail("library: the palette has repeated colors")
    return np.array([lookup[int(k)] for k in key(rgb)], np.int64)


def library_cli_test(torch, main, cfg, paths, counters, by_path, here) -> dict:
    """cli.test on the smoke dataset with save_semantic: True and
    --profile_dir, counted: per scene the semantic PLY (its labels those of the run's
    argmax), the instance PLY and the boxes OBJ; the Chrome trace naming
    K1's and K2's kernels; K1's and K2's launches equal to the plain
    cli.test run's (path T)."""
    from geoformer_tpu_torch.cli.test import label_digest
    from geoformer_tpu_torch.utils.visualize import PALETTE

    prof = fresh_dir(os.path.join(here, "build", "smoke_profile"))
    # thresholds down, so that the random weights' proposals survive and the
    # instance PLY and boxes OBJ are written (the kernels' work is the same)
    config = write_yaml(os.path.join(os.path.dirname(paths["config"]), "test_profiled.yaml"),
                        cfg.replace(TEST_SCORE_THRESH=0.0, TEST_NPOINT_THRESH=10,
                                    TEST_NMS_THRESH=1e-4, save_semantic=True))
    res = run_driver(torch, "test", main, dict(paths, config=config), counters,
                     label="test_profiled", extra=["--profile_dir", prof])
    result = os.path.join(os.path.dirname(paths["config"]), "exp", "test_profiled", "result")
    files_ok, labels_ok = all(r["proposals"] for r in res["scenes"]), True
    for rec in res["scenes"]:
        base = os.path.join(result, rec["scene"])
        files_ok &= all(os.path.exists(base + f) for f in ("_sem.ply", "_inst.ply", "_boxes.obj"))
        labels_ok &= label_digest(ply_labels(base + "_sem.ply", PALETTE)) == rec["semantic_digest"]
    with open(os.path.join(prof, "trace_rank0.json")) as f:
        trace = f.read()
    names = {k: k in trace for k in ("knn_select_kernel", "fps_kernel")}
    same_launches = all(res["launches"][k] == by_path["driver_test"][k]
                        for k in ("knn_select", "fps"))
    out = lib_emit("cli_test", files_ok and labels_ok and all(names.values()) and same_launches,
                   failure="failed a check of its files, its trace or its launches",
                   files=files_ok, proposals=[r["proposals"] for r in res["scenes"]],
                   semantic_labels_equal_argmax=labels_ok,
                   trace_mb=len(trace) / 1e6, trace_names=names,
                   launches={k: res["launches"][k] for k in ("knn_select", "fps")},
                   launches_path_T={k: by_path["driver_test"][k] for k in ("knn_select", "fps")},
                   seconds=res["seconds"])
    out["launches_all"] = res["launches"]
    return out


def library(torch, cli_main, data, counters, by_path, here) -> dict:
    """The library ops on the card at the shapes of a real scene, each held
    against the port's own CPU run on the same inputs; the native elastic;
    cli.test with save_semantic and --profile_dir. Returns the counted
    cli.test run's launches."""
    t0 = time.time()
    rng = np.random.default_rng(LIB_SEED)
    library_knn(torch, rng)
    library_interpolate(torch, rng)
    library_segments(torch, rng)
    library_iou_nms(torch, rng)
    library_cluster(torch, rng)
    torch.cuda.empty_cache()
    library_elastic(torch, data["cfgs"]["test"])
    cli = library_cli_test(torch, cli_main, data["cfgs"]["test"], data["paths"]["test"],
                           counters, by_path, here)
    emit({"phase": "library_done", "seconds": time.time() - t0})
    return cli["launches_all"]


# ---------------- training paths ----------------

# batch size of the two training drivers: the largest of 16, 8, 4, 2 that
# fits the card (B = 16 ran out of the H100's 80 GB in the full phase; B = 8
# peaks at ~51 GB; PERF.md)
TRAIN_BATCH = 8
# cuts of the published training configs (each printed in its phase's ``cut``)
TRAIN_CUTS = {"prepare_epochs": [120, 1], "epochs": [500, 2], "start_epoch": [0, 1]}
TRAIN_FS_CUTS = {"epochs": [40, 1], "start_epoch": [0, 1]}
# foreground logit of the pretrain checkpoint's semantic head (class 4, a
# fold class): every point is foreground, so the mask head trains on the
# full 131,072-point capacity and not on an empty or arbitrary set
FG_BIAS = 30.0
# share of the points dropped from every second training scene: 50,000 of
# the 250,000-point capacity left invalid, each reading devoxelize's pad slot
TRAIN_THIN = 0.2
# train_small_reference: the published configs' U-Net depth, the points of
# its second scene left invalid (a scene below capacity: pad-slot reads in
# devoxelize), and its gates (see there)
SMALL_REF_DEPTH = 7
SMALL_REF_INVALID = 400
SMALL_REF_TOL64 = 1e-9
SMALL_REF_TOL = 1e-4
SMALL_REF_RATIO = 8.0


class TrainProbes:
    """Counts, over a counted training run, the residual blocks run under
    torch.utils.checkpoint (remat), the sparse-conv operands narrowed to
    bf16, and the host wall time of each matcher call (synchronized on
    both sides)."""

    def __init__(self, torch):
        import geoformer_tpu_torch.losses.criterion as crit
        import geoformer_tpu_torch.losses.criterion_fs as crit_fs
        import geoformer_tpu_torch.ops.sparse_conv as sc

        self.torch, self.crit, self.crit_fs, self.sc = torch, crit, crit_fs, sc
        self.remat_blocks = self.bf16_operands = 0
        self.matcher_ms = []
        self.saved = (torch.utils.checkpoint.checkpoint, sc._narrow, crit.matcher)

    def __enter__(self):
        torch = self.torch
        checkpoint, narrow, matcher = self.saved

        def counted_checkpoint(*a, **kw):
            self.remat_blocks += 1
            return checkpoint(*a, **kw)

        def counted_narrow(x, compute_dtype):
            self.bf16_operands += compute_dtype == torch.bfloat16
            return narrow(x, compute_dtype)

        def timed_matcher(cfg):
            assign = matcher(cfg)

            def timed(cost, valid):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = assign(cost, valid)
                torch.cuda.synchronize()
                self.matcher_ms.append((time.perf_counter() - t) * 1e3)
                return out
            return timed

        torch.utils.checkpoint.checkpoint = counted_checkpoint
        self.sc._narrow = counted_narrow
        self.crit.matcher = self.crit_fs.matcher = timed_matcher
        return self

    def __exit__(self, *exc):
        checkpoint, narrow, matcher = self.saved
        self.torch.utils.checkpoint.checkpoint = checkpoint
        self.sc._narrow = narrow
        self.crit.matcher = self.crit_fs.matcher = matcher


def shuffle_points(base: str, seed: int, thin: float = 0.0) -> list:
    """Permute the points of every scene file under ``base``: a synthetic
    room is written surface by surface (floor, walls, then the furniture
    boxes that carry the instances), and the first 131,072 points that the
    foreground pack keeps would hold no instance; a scan's vertex order
    interleaves them. Every second scene keeps only a (1 - ``thin``) share
    of its points, as scans smaller than the point capacity leave point
    slots invalid. -> the scenes' point counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scenes = os.path.join(base, "scenes")
    counts = []
    for i, name in enumerate(sorted(os.listdir(scenes))):
        path = os.path.join(scenes, name)
        data = np.load(path)
        keep = len(data) - (int(len(data) * thin) if i % 2 else 0)
        np.save(path, data[rng.permutation(len(data))[:keep]])
        counts.append(keep)
    return counts


def write_train_data(torch, cfg_mod, Engine, here, batch_size) -> dict:
    """A synthetic dataset of 4B full-size scenes (its first 2B the train
    split: two steps an epoch at batch size B), the two training configs
    (the published YAMLs with only the TRAIN_CUTS / TRAIN_FS_CUTS epoch
    counts and the batch size changed) and the supervised pretrain
    checkpoint, under build/smoke_train."""
    from geoformer_tpu_torch.synthetic import write_dataset
    from geoformer_tpu_torch.weights import save_jax_checkpoint

    import shutil

    root = os.path.join(here, "build", "smoke_train")
    # a checkpoint left by an earlier run would resume past the last epoch
    shutil.rmtree(root, ignore_errors=True)
    base = write_dataset(root, n_scenes=4 * batch_size, n_points=250000, seed=1)
    counts = shuffle_points(base, seed=1, thin=TRAIN_THIN)
    common = dict(data_root=root, output_path=os.path.join(root, "exp"),
                  batch_size=batch_size)
    cfgs = {
        "train": cfg_mod.load_config(os.path.join(here, "config", "geoformer_scannet.yaml"),
                                     **common, **{k: v[1] for k, v in TRAIN_CUTS.items()}),
        "train_fs": cfg_mod.load_config(
            os.path.join(here, "config", "geoformer_fs_scannet.yaml"),
            **common, **{k: v[1] for k, v in TRAIN_FS_CUTS.items()}),
    }
    paths = {name: write_yaml(os.path.join(root, f"{name}.yaml"), cfg)
             for name, cfg in cfgs.items()}
    engine = Engine(cfgs["train"], seed=0)
    with torch.no_grad():
        engine.model.semantic.Dense_2.bias[4] += FG_BIAS
    paths["pretrain"] = os.path.join(root, "pretrain.ckpt")
    save_jax_checkpoint(paths["pretrain"], engine.model)
    del engine
    torch.cuda.empty_cache()
    return {"cfgs": cfgs, "paths": paths, "root": root, "points": counts}


def run_train_driver(torch, name, main, argv, counters, backbone_trains: bool,
                     full_phase: bool = True) -> dict:
    """One training driver from its command line, counted: the kernels'
    launch counts set to 0 just before and read just after, the peak
    device memory over the run, and the TrainProbes. The residual blocks
    are rematerialized when the backbone trains (a frozen backbone runs in
    eval mode, and the JAX model remats it then neither). ``full_phase``:
    the run must reach the full phase (and match gt instances there) and
    launch K1 and K2, which the prepare phase does not run."""
    for fn in counters.values():
        fn.launches = 0
    fps_log = counters["fps"].capture = CallLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with TrainProbes(torch) as probes:
        summary = main(argv)
        torch.cuda.synchronize()
    seconds = time.time() - t0
    counters["fps"].capture = None
    launches = read_launches(counters, fps_log)
    steps = summary["steps"]
    by_phase = {}
    for st in steps:
        by_phase.setdefault(st["phase"], []).append(st["seconds"] * 1e3)
    counters_max = {}
    for st in steps:
        for k, v in st["voxel_stats"].items():
            if k in CAPACITY_KEYS:
                counters_max[k] = max(counters_max.get(k, 0), max(int(x) for x in v))
    full = [st for st in steps if st["phase"] == "full"]
    step_ms = sum(st["seconds"] for st in steps) * 1e3
    res = {"phase": name, "steps": len(steps), "ms_per_step": by_phase,
           "losses": [st["losses"] for st in steps],
           "num_gt": [st["losses"].get("num_gt") for st in full],
           "capacity_counters": counters_max,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "matcher": {"calls": len(probes.matcher_ms), "ms": probes.matcher_ms,
                       "share_of_step_time": sum(probes.matcher_ms) / step_ms if step_ms else None},
           "remat_blocks": probes.remat_blocks, "bf16_conv_operands": probes.bf16_operands,
           "launches": launches, "seconds": seconds, "checkpoint": summary["checkpoint"],
           "param_digest": summary["param_digest"]}
    if not steps:
        fail(f"{name}: no training step ran")
    if not all(math.isfinite(v) for st in steps for v in st["losses"].values()):
        fail(f"{name}: a loss is not finite")
    if any(counters_max.values()):
        fail(f"{name}: a capacity counter is not 0: {counters_max}")
    if full_phase and (not full or not all(n and n > 0 for n in res["num_gt"])):
        fail(f"{name}: a full-phase step matched no gt instance")
    for k in ("knn_select", "fps"):
        if full_phase and launches[k] <= 0:
            fail(f"{name}: kernel {k} was not launched")
    if (probes.remat_blocks > 0) != backbone_trains or probes.bf16_operands <= 0:
        fail(f"{name}: remat ({probes.remat_blocks} blocks; the backbone trains: "
             f"{backbone_trains}) or bf16 ({probes.bf16_operands} operands) not in force")
    return res


CAPACITY_KEYS = ("n_overflow_points", "n_oor_points", "n_dropped_voxels_deeper",
                 "n_brick_overflow", "saturated", "n_radius_cell_overflow",
                 "n_radius_window_overflow")


def capture_train_kernels(torch, Engine, cfg, ckpt, few_shot) -> dict:
    """One training-mode forward (no gradient, outside every counted run)
    of the trained checkpoint on a training batch, capturing the first K1
    table and K2's inputs at each of its shapes."""
    from geoformer_tpu_torch.kernels.fps import fps
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand
    from geoformer_tpu_torch.weights import load_jax_checkpoint

    engine = Engine(cfg, few_shot=few_shot, state_dict=load_jax_checkpoint(ckpt))
    gen = torch.Generator(device=engine.device).manual_seed(5)
    if few_shot:
        from geoformer_tpu_torch.data.episodic import FSInstDataset

        support, batch, _ = next(FSInstDataset(cfg, "train").train_batches(cfg.batch_size, seed=5))
    else:
        from geoformer_tpu_torch.data.scannet import InstDataset

        batch = next(InstDataset(cfg, "train").train_batches(cfg.batch_size, seed=5))
    knn, fps_log = CallLog(keep=True), CallLog(keep=True)
    select_min_k_cand.capture, fps.capture = knn, fps_log
    engine.model.train()
    with torch.no_grad():
        if few_shot:
            engine.model(engine.to_device(support), engine.to_device(batch), train=True,
                         generator=gen)
        else:
            engine.model(engine.to_device(batch), train=True, generator=gen)
    select_min_k_cand.capture = fps.capture = None
    del engine
    torch.cuda.empty_cache()
    return {"knn": next(iter(knn.first.values())), "fps": fps_log.first}


def small_train_step(torch, Engine, cfg, sd, batch, device, dtype, capture=False) -> dict:
    """One full-phase training step of a fresh engine at ``dtype`` (the
    model and the batch's floats cast to it) on ``device``: the loss, the
    matched instances and every gradient (on the CPU, float64), with K1's
    and K2's inputs when ``capture``. At float64 the card has no kernel (K1
    and K2 take float32), so their plain versions pick on the card there:
    the float64 runs check the rest of the step, the float32 runs the
    kernels."""
    import geoformer_tpu_torch.ops.fps as ops_fps
    import geoformer_tpu_torch.ops.radius_graph as ops_rg
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.models.unet import BottleneckTransformer

    engine = Engine(cfg, device=device, state_dict=sd)
    engine.init_state()
    engine.model.to(dtype)
    # no dropout (dec_dropout is 0; the U-Net's bottleneck transformer keeps
    # a fixed 0.1): the two devices would draw other masks
    for mod in engine.model.modules():
        if isinstance(mod, BottleneckTransformer):
            mod.dropout = 0.0
    knn, fps_in = [], []
    if capture:
        select_min_k_cand.capture, fps.capture = knn, fps_in
    plain = dtype == torch.float64 and device != "cpu"
    if plain:
        ops_rg.select_min_k_cand, ops_fps.fps = select_min_k_cand_plain, fps_plain
    try:
        engine.model.train()
        tb = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in engine.to_device(batch).items()}
        out = engine.model(tb, train=True)
        loss, ld = engine.criterion(out, tb, 1)
        loss.backward()
    finally:
        select_min_k_cand.capture = fps.capture = None
        ops_rg.select_min_k_cand, ops_fps.fps = select_min_k_cand, fps
    return {"loss": float(loss.detach()), "num_gt": float(ld["num_gt"]),
            "grads": {k: p.grad.detach().cpu().double() for k, p in
                      engine.model.named_parameters() if p.grad is not None},
            "knn": knn, "fps": fps_in}


def grad_errors(got: dict, want: dict) -> dict:
    """Per gradient leaf: max |got - want| / max(1, |want|inf)."""
    return {k: float((g - got[k]).abs().max()) / max(1.0, float(g.abs().max()))
            for k, g in want.items()}


def small_train_inputs(torch, cfg_mod, synthetic_batch) -> dict:
    """train_small_reference's config (a small size at the published U-Net
    depth), its batch of two scenes (the second below capacity) and its
    seeded weights (the foreground class biased on)."""
    import geoformer_tpu_torch.models.geoformer as gf
    from geoformer_tpu_torch.weights import random_state_dict

    cfg = cfg_mod.load_config(
        None, batch_size=2, m=8, dec_dim=32, dec_nhead=4, dec_ffn_dim=32, dec_nlayers=2,
        dec_dropout=0.0, n_decode_point=128, n_query_points=32, n_downsampling=1024,
        tpu_max_points=4096, tpu_max_voxels=4096, tpu_max_fg_points=2048,
        tpu_train_subsample=1024, tpu_max_instances=16, tpu_knn_neighbors=16,
        tpu_spatial_shape=256, tpu_unet_depth=SMALL_REF_DEPTH, tpu_ball_nsample=16,
        prepare_epochs=0, tpu_remat=True)
    batch = synthetic_batch(cfg, 2, seed=11)
    batch["point_mask"][1, -SMALL_REF_INVALID:] = False  # a scene below capacity
    model = gf.GeoFormer(gf.ModelConfig.from_cfg(cfg))
    sd = random_state_dict(model, 3)
    sd["semantic.Dense_2.bias"][4] += FG_BIAS
    return {"cfg": cfg, "batch": batch, "sd": sd}


def injected_pack(torch):
    """random_pack_by_mask with seeded numpy draws, the same on every device:
    a table for the global batch (one row a scene) of which a rank of a
    data mesh keeps its rows, as draw_subsample does."""
    import numpy as np

    import geoformer_tpu_torch.models.geoformer as gf
    from geoformer_tpu_torch.parallel.mesh import data_rows

    def injected(mask, capacity, generator):
        rng = np.random.default_rng(capacity)
        b, p = mask.shape
        total, first = data_rows(b)
        rows = slice(first, first + b)
        if capacity >= p:
            n = mask.sum(1).clamp(min=1).cpu()
            draws = torch.minimum((torch.from_numpy(rng.random(total)[rows]) * n).long(), n - 1)
        else:
            draws = torch.from_numpy(rng.random((total, p)).astype(np.float32)[rows])
        return gf.pack_from_draws(mask, capacity, draws.to(mask.device))

    return injected


def train_small_reference(torch, cfg_mod, Engine, synthetic_batch) -> dict:
    """One full-phase training step at a small size and the published
    U-Net depth, on the card and on the CPU, in float32 and in float64:
    same weights, same batch, same subsample draws (injected into
    random_pack_by_mask).

    In float64 the card and the CPU must agree to SMALL_REF_TOL64: no
    fault of the step hides under rounding there. In float32 they differ
    by rounding alone, which the deep U-Net amplifies (batch and layer
    norms over the few voxels of its coarse levels cancel: the CPU's own
    float32 gradients are ~1e-2 from its float64 ones there), so each
    float32 run is held against the CPU's float64 step: in every top-level
    module the card's worst error may be at most SMALL_REF_RATIO times the
    CPU's worst, or SMALL_REF_TOL. Leaf by leaf the two errors are not
    comparable: where the CPU's error happens to be small the card's can
    be tens of times larger. K1's and K2's float32 outputs on the card must
    equal their plain versions' outputs on the CPU run's inputs."""
    import geoformer_tpu_torch.models.geoformer as gf
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )

    inputs = small_train_inputs(torch, cfg_mod, synthetic_batch)
    cfg, batch, sd = inputs["cfg"], inputs["batch"], inputs["sd"]
    real_pack, injected = gf.random_pack_by_mask, injected_pack(torch)

    runs = {}
    gf.random_pack_by_mask = injected
    try:
        for run, dev, dt in (("cpu32", "cpu", torch.float32), ("cuda32", "cuda", torch.float32),
                             ("cuda32_again", "cuda", torch.float32),
                             ("cpu64", "cpu", torch.float64), ("cuda64", "cuda", torch.float64)):
            runs[run] = small_train_step(torch, Engine, cfg, sd, batch, dev, dt,
                                         capture=run in ("cpu32", "cuda32"))
    finally:
        gf.random_pack_by_mask = real_pack
    ref = runs["cpu64"]["grads"]
    errs = {
        "f64_card_vs_cpu": grad_errors(runs["cuda64"]["grads"], ref),
        "f32_card_vs_cpu": grad_errors(runs["cuda32"]["grads"], runs["cpu32"]["grads"]),
        "f32_card_vs_f64": grad_errors(runs["cuda32"]["grads"], ref),
        "f32_cpu_vs_f64": grad_errors(runs["cpu32"]["grads"], ref),
        # the card against itself: its scatter-adds sum in no fixed order
        "f32_card_repeat": grad_errors(runs["cuda32_again"]["grads"], runs["cuda32"]["grads"]),
    }
    worst = {name: max(e.items(), key=lambda kv: kv[1]) for name, e in errs.items()}
    # float32, module by module: [card's worst, CPU's worst] against float64
    f32_by_module = {}
    for k in ref:
        pair = f32_by_module.setdefault(k.split(".")[0], [0.0, 0.0])
        pair[0] = max(pair[0], errs["f32_card_vs_f64"][k])
        pair[1] = max(pair[1], errs["f32_cpu_vs_f64"][k])
    over = sorted(m for m, (card, cpu) in f32_by_module.items()
                  if card > max(SMALL_REF_TOL, SMALL_REF_RATIO * cpu))
    card, cpu = errs["f32_card_vs_f64"], errs["f32_cpu_vs_f64"]
    ratio = {k: card[k] / max(cpu[k], 1e-30) for k in ref}
    worst_ratio = max(ratio, key=ratio.get)
    loss_err = {run: abs(r["loss"] - runs["cpu64"]["loss"]) / max(1.0, abs(runs["cpu64"]["loss"]))
                for run, r in runs.items()}
    a, b = runs["cpu32"], runs["cuda32"]
    kernels_equal = {
        "knn_select": all(all(torch.equal(bits(torch, x.cpu()), bits(torch, y)) for x, y in zip(
            select_min_k_cand(*g), select_min_k_cand_plain(*c)))
            for g, c in zip(b["knn"], a["knn"])),
        "fps": all(torch.equal(fps(*g).cpu(), fps_plain(*c)) for g, c in zip(b["fps"], a["fps"])),
    }
    res = {"phase": "train_small_reference", "points": cfg.tpu_max_points, "batch": 2,
           "invalid_points": SMALL_REF_INVALID, "unet_depth": SMALL_REF_DEPTH,
           "loss": {run: r["loss"] for run, r in runs.items()}, "num_gt": a["num_gt"],
           "loss_rel_err_vs_f64": loss_err, "grad_leaves": len(ref),
           "worst": {name: list(kv) for name, kv in worst.items()},
           "f32_by_module": f32_by_module,
           "f32_leaf_worst_ratio": [worst_ratio, ratio[worst_ratio], card[worst_ratio],
                                    cpu[worst_ratio]],
           "tol64": SMALL_REF_TOL64, "tol": SMALL_REF_TOL, "ratio": SMALL_REF_RATIO,
           "f32_modules_over": over,
           "kernel_calls": {"knn_select": len(b["knn"]), "fps": len(b["fps"])},
           "kernels_equal_to_cpu_run": kernels_equal}
    emit(res)
    if any(set(r["grads"]) != set(ref) for r in runs.values()):
        fail("train_small_reference: the runs took gradients of other leaves")
    if worst["f64_card_vs_cpu"][1] > SMALL_REF_TOL64 or loss_err["cuda64"] > SMALL_REF_TOL64:
        fail("train_small_reference: the card's float64 step disagrees with the CPU's")
    if over or loss_err["cuda32"] > max(SMALL_REF_TOL, SMALL_REF_RATIO * loss_err["cpu32"]):
        fail(f"train_small_reference: the card's float32 step is further from the float64 "
             f"step than the CPU's in {over or ['the loss']}")
    if not all(kernels_equal.values()):
        fail("train_small_reference: K1 or K2 on the card differs from the CPU run")
    if not b["knn"] or not b["fps"] or a["num_gt"] <= 0:
        fail("train_small_reference: the step ran no kernel or matched no instance")
    return res


def train_paths(torch, cfg_mod, Engine, here, batch_size, counters, smoke) -> dict:
    """cli.train on the published supervised config (cut epochs), cli.test on
    the checkpoint it wrote, cli.train_fs from that checkpoint on the
    published few-shot config, each counted; then K1 and K2 at the training
    shapes, held against their plain versions."""
    from geoformer_tpu_torch.cli import test as cli_test
    from geoformer_tpu_torch.cli import train as cli_train
    from geoformer_tpu_torch.cli import train_fs as cli_train_fs
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.models.geoformer import ModelConfig

    t0 = time.time()
    data = write_train_data(torch, cfg_mod, Engine, here, batch_size)
    cfgs, paths = data["cfgs"], data["paths"]
    mc = ModelConfig.from_cfg(cfgs["train"])
    emit({"phase": "train_data", "root": os.path.relpath(data["root"], here),
          "scenes": 4 * batch_size, "train_scenes": 2 * batch_size, "points": data["points"],
          "seconds": time.time() - t0})
    exp = os.path.join(data["root"], "exp")
    res = run_train_driver(torch, "train", cli_train.main, [
        "--config", paths["train"], "--pretrain", paths["pretrain"], "--output_path", exp,
        "--exp_name", "train"], counters, backbone_trains=True)
    res.update(batch_size=batch_size, cut=TRAIN_CUTS, config="config/geoformer_scannet.yaml",
               compute_dtype="bfloat16" if mc.bf16 else "float32", remat=mc.remat)
    emit(res)
    trained = res["checkpoint"]
    by_path = {"train": res["launches"]}

    # chain: the eval driver on the checkpoint the training driver wrote
    chain = run_driver(torch, "test", cli_test.main,
                       dict(smoke["paths"]["test"], ckpt=trained), counters, label="chain_test")
    emit({"phase": "chain", "checkpoint": os.path.relpath(trained, here),
          "all_ap": chain["all_ap"], "scenes": len(chain["scenes"])})
    by_path["chain_test"] = chain["launches"]

    res_fs = run_train_driver(torch, "train_fs", cli_train_fs.main, [
        "--config", paths["train_fs"], "--pretrain", trained, "--output_path", exp,
        "--exp_name", "train_fs"], counters,
        backbone_trains=not ModelConfig.from_cfg(cfgs["train_fs"]).is_fixed("backbone"))
    mc_fs = ModelConfig.from_cfg(cfgs["train_fs"])
    res_fs.update(batch_size=batch_size, cut=TRAIN_FS_CUTS,
                  config="config/geoformer_fs_scannet.yaml",
                  compute_dtype="bfloat16" if mc_fs.bf16 else "float32", remat=mc_fs.remat,
                  frozen=list(cfgs["train_fs"].fix_module))
    emit(res_fs)
    by_path["train_fs"] = res_fs["launches"]
    want = {json.dumps([batch_size, 4096, 32]), json.dumps(
        [batch_size, cfgs["train_fs"].n_downsampling, cfgs["train_fs"].n_decode_point])}
    if set(res_fs["launches"]["fps_by_shape"]) != want:
        fail(f"train_fs: fps shapes {res_fs['launches']['fps_by_shape']}, expected {sorted(want)}")

    # K1 and K2 at the training shapes (B > 1), captured outside the counted runs
    sup = capture_train_kernels(torch, Engine, cfgs["train"], trained, False)
    d2, cand, k = sup["knn"]
    n, w = d2.shape
    k1 = kernel_row(
        torch, name="knn_select", source="geoformer_tpu_torch/csrc/knn_select.cu",
        replaces="geoformer_tpu/ops/knn_select_pallas.py:34", launches=res["launches"]["knn_select"],
        kernel=lambda: select_min_k_cand(d2, cand, k),
        plain=lambda: select_min_k_cand_plain(d2, cand, k),
        library=lambda: torch.topk(d2, k, dim=1, largest=False),
        bytes_=n * w * 4 + n * k * 4 + n * k * 8, ops=n * w * k, shape=[n, w, k],
        reps=20, plain_reps=3, path="train", launches_per_forward=batch_size,
        exact_share=exact_share(torch, select_min_k_cand, d2, cand, k))
    del d2, cand, sup["knn"]
    k2 = [fps_row(torch, fps, fps_plain, inp, res["launches"]["fps_by_shape"].get(
        json.dumps(list(key)), 0)) for key, inp in sup["fps"].items()]
    # two of these scenes: K2's shape on the data- and model-parallel ranks
    # (two scenes a rank or a data index), timed once their launches are in
    (pts, msk, ns), = [inp for key, inp in sup["fps"].items()
                       if key[1] == cfgs["train"].n_downsampling]
    two_scenes = (pts[:2].clone(), msk[:2].clone(), ns)
    del sup, pts, msk
    fs = capture_train_kernels(torch, Engine, cfgs["train_fs"], res_fs["checkpoint"], True)
    k2 += [fps_row(torch, fps, fps_plain, inp, res_fs["launches"]["fps_by_shape"].get(
        json.dumps(list(key)), 0)) for key, inp in fs["fps"].items()]
    del fs
    torch.cuda.empty_cache()
    for row in k2:
        row["path"] = "train" if row["shape"][1] == cfgs["train"].n_downsampling else "train_fs"
        if row["shape"][0] < 2 or row["launches"] <= 0:
            fail(f"fps at a training shape {row['shape']}: batch < 2 or no launch")
    return {"by_path": by_path, "k1": k1, "k2": k2, "data": data, "fps_two_scenes": two_scenes}


# ---------------- data parallelism ----------------

# ranks of the data-parallel phases, on the one card over gloo (NCCL refuses
# two ranks on one GPU)
DDP_WORLD = 2
# ddp_train's global batch (two scenes a rank) and its cuts of the published
# config: one prepare and one full epoch of two steps each
DDP_TRAIN_BATCH = 4
DDP_TRAIN_CUTS = {"prepare_epochs": [120, 1], "epochs": [500, 2], "start_epoch": [0, 1]}
# ddp_eval's test_batch_size: two scenes a forward, one a rank
DDP_EVAL_GROUP = 2
# a rank group that outlives this fails its phase
DDP_TIMEOUT_S = 420


def start_ranks(here, task: str, work: str, world: int = DDP_WORLD):
    """``world`` processes of this script in its ``--rank-task`` mode, with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT); ``wait()`` raises if any rank fails or the group
    outlives DDP_TIMEOUT_S, and stops every rank."""
    from geoformer_tpu_torch.parallel.launch import Ranks

    env = dict(os.environ, PYTHONPATH=here)
    return Ranks([sys.executable, os.path.join(here, "chip_smoke.py"), "--rank-task", task,
                  "--work", work], world, DDP_TIMEOUT_S, log_dir=work, env=env, cwd=here)


def fresh_dir(path: str) -> str:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def ddp_steps(torch, Engine, inputs, dtype, mesh=None, steps: int = 2, matches=None) -> dict:
    """``steps`` full-phase Engine.train_steps of train_small_reference's
    inputs at ``dtype`` on the card (on this rank's rows under ``mesh``),
    with its injected draws and no dropout: the first step's loss, matched
    instances, Hungarian matches, geodesic table (this rank's query
    columns), the largest tensor of each collective call site, applied
    (reduced) gradients and BN statistics after it, and a digest of the
    model after the last step, with K1's and K2's launches over the steps.
    ``matches`` (this process's rows) replace the first step's own, which
    are still reported: a float32 run takes float64's, so that a near-tie
    that the auction breaks the other way in float32 does not stand in for
    rounding. At float64 K1 and K2 pick through their plain versions (the
    kernels take float32)."""
    import numpy as np

    import geoformer_tpu_torch.models.geoformer as gf
    import geoformer_tpu_torch.ops.fps as ops_fps
    import geoformer_tpu_torch.ops.radius_graph as ops_rg
    from geoformer_tpu_torch.cli.train import state_digest
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )
    from geoformer_tpu_torch.models.unet import BottleneckTransformer
    from geoformer_tpu_torch.parallel.mesh import TRAFFIC

    engine = Engine(inputs["cfg"], device="cuda", state_dict=inputs["sd"], mesh=mesh)
    state = engine.init_state()
    engine.model.to(dtype)
    for mod in engine.model.modules():
        if isinstance(mod, BottleneckTransformer):
            mod.dropout = 0.0
    batch = {k: v.astype(np.float64) if dtype == torch.float64 and v.dtype == np.float32 else v
             for k, v in inputs["batch"].items()}
    first = {}
    optimizer_step = state.optimizer.step

    def reading(*a, **kw):
        if "grads" not in first:
            first["grads"] = {k: p.grad.detach().cpu().double() for k, p in state.params.items()}
        return optimizer_step(*a, **kw)

    state.optimizer.step = reading
    assign = engine.criterion._assign

    def keeping(cost, valid):
        out = assign(cost, valid)
        if "matches" not in first:
            first["matches"] = out.cpu()
            if matches is not None:
                return matches.to(out.device)
        return out

    engine.criterion._assign = keeping
    geodesic = engine.model.forward_geodesic

    def solving(*a, **kw):
        out = geodesic(*a, **kw)
        first.setdefault("geo", out[0].cpu())
        return out

    engine.model.forward_geodesic = solving
    launches0 = (select_min_k_cand.launches, fps.launches)
    TRAFFIC.reset()
    real_pack = gf.random_pack_by_mask
    gf.random_pack_by_mask = injected_pack(torch)
    if dtype == torch.float64:
        ops_rg.select_min_k_cand, ops_fps.fps = select_min_k_cand_plain, fps_plain
    try:
        gen = torch.Generator(device=engine.device).manual_seed(0)
        for i in range(steps):
            loss, ld, _ = engine.train_step(batch, 1, gen)
            if i == 0:
                first["traffic"] = dict(TRAFFIC.largest)
                first.update(loss=float(loss), num_gt=float(ld["num_gt"]),
                             terms={k: float(v) for k, v in ld.items()}, stats={
                    k: v.detach().cpu().double() for k, v in engine.model.state_dict().items()
                    if k.rsplit(".", 1)[-1] in ("mean", "var")})
    finally:
        gf.random_pack_by_mask = real_pack
        ops_rg.select_min_k_cand, ops_fps.fps = select_min_k_cand, fps
    return dict(first, digest=state_digest(engine.model),
                launches={"knn_select": select_min_k_cand.launches - launches0[0],
                          "fps": fps.launches - launches0[1]})


def ddp_reference_rank(torch, work: str) -> None:
    """A rank of ``ddp_reference``: both dtypes' steps under the mesh."""
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.parallel.dist import process_group
    from geoformer_tpu_torch.parallel.mesh import make_mesh

    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    with process_group("gloo"):
        mesh = make_mesh()
        out = {"float64": ddp_steps(torch, Engine, inputs, torch.float64, mesh)}
        out["float32"] = ddp_steps(torch, Engine, inputs, torch.float32, mesh,
                                   matches=out["float64"]["matches"])
        torch.save(dict(out, device=str(mesh.device)),
                   os.path.join(work, f"rank{mesh.rank}.pt"))


def ddp_reference(torch, cfg_mod, Engine, synthetic_batch, here) -> dict:
    """train_small_reference's step (its config at the published U-Net
    depth, B = 2, its weights and draws) on DDP_WORLD gloo ranks, one scene
    a rank, against the one-process step on the card, twice a dtype. Float64:
    the loss, every applied gradient and every BN statistic within
    SMALL_REF_TOL64 x max(1, |ref|inf) of the one-process step's, the
    matched instances equal. Float32: module by module no further from the
    one-process float64 step than SMALL_REF_RATIO times the one-process
    float32 step is (or SMALL_REF_TOL), as train_small_reference holds the
    card against the CPU. Both dtypes: the ranks' models bit-equal after the
    second step. Each float32 run takes float64's Hungarian matches in its
    first step (its own are reported beside them): the float32 auction may
    break a near-tie the other way, which is not rounding."""
    t0 = time.time()
    inputs = small_train_inputs(torch, cfg_mod, synthetic_batch)
    work = fresh_dir(os.path.join(here, "build", "smoke_ddp", "reference"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ranks = start_ranks(here, "ddp_reference", work)
    try:  # the one-process steps run on the card while the ranks start
        ref = {"float64": ddp_steps(torch, Engine, inputs, torch.float64)}
        ref["float32"] = ddp_steps(torch, Engine, inputs, torch.float32,
                                   matches=ref["float64"]["matches"])
        ranks.wait()
    finally:
        ranks.stop()
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(DDP_WORLD)]
    r64, g64 = ref["float64"], got[0]["float64"]
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
    errs = {"grads": grad_errors(g64["grads"], r64["grads"]),
            "stats": grad_errors(g64["stats"], r64["stats"])}
    worst = {k: max(e.items(), key=lambda kv: kv[1]) for k, e in errs.items()}
    loss_err = rel(g64["loss"], r64["loss"])
    e2 = grad_errors(got[0]["float32"]["grads"], r64["grads"])
    e1 = grad_errors(ref["float32"]["grads"], r64["grads"])
    by_module = {}
    for k in r64["grads"]:
        pair = by_module.setdefault(k.split(".")[0], [0.0, 0.0])
        pair[0], pair[1] = max(pair[0], e2[k]), max(pair[1], e1[k])
    over = sorted(m for m, (two, one) in by_module.items()
                  if two > max(SMALL_REF_TOL, SMALL_REF_RATIO * one))
    digests = {dt: [g[dt]["digest"][:16] for g in got] for dt in ("float64", "float32")}
    # the Hungarian matches of the first step, per scene, against float64's
    ref_matches = r64["matches"]
    matches_equal = {
        "one_process_f32": bool(torch.equal(ref["float32"]["matches"], ref_matches)),
        "ranks_f64": bool(torch.equal(torch.cat([g["float64"]["matches"] for g in got]),
                                      ref_matches)),
        "ranks_f32": bool(torch.equal(torch.cat([g["float32"]["matches"] for g in got]),
                                      ref_matches))}
    terms = {"one_process_f64": r64["terms"], "one_process_f32": ref["float32"]["terms"],
             "ranks_f32": got[0]["float32"]["terms"]}
    res = {"phase": "ddp_reference", "world": DDP_WORLD, "backend": "gloo",
           "rank_devices": [g["device"] for g in got], "batch": 2,
           "unet_depth": SMALL_REF_DEPTH, "points": inputs["cfg"].tpu_max_points,
           "loss": {"one_process": r64["loss"], "ranks": g64["loss"]},
           "num_gt": [r64["num_gt"], g64["num_gt"]], "f64_loss_rel_err": loss_err,
           "f64_worst": {k: list(v) for k, v in worst.items()}, "grad_leaves": len(r64["grads"]),
           "bn_stat_leaves": len(r64["stats"]), "tol64": SMALL_REF_TOL64,
           "f32_by_module": by_module, "f32_modules_over": over,
           "rank_digests_after_2_steps": digests, "matches_equal_to_f64": matches_equal,
           "loss_terms": terms, "seconds": time.time() - t0}
    emit(res)
    if set(g64["grads"]) != set(r64["grads"]) or set(g64["stats"]) != set(r64["stats"]):
        fail("ddp_reference: the ranks took gradients or statistics of other leaves")
    if (loss_err > SMALL_REF_TOL64 or max(v[1] for v in worst.values()) > SMALL_REF_TOL64
            or g64["num_gt"] != r64["num_gt"] or r64["num_gt"] <= 0
            or not matches_equal["ranks_f64"]):
        fail("ddp_reference: the float64 step on two ranks differs from the one-process step")
    if over:
        fail(f"ddp_reference: the float32 step on two ranks is further from float64 in {over}")
    if any(len(set(g[dt]["digest"] for g in got)) != 1 for dt in ("float64", "float32")):
        fail("ddp_reference: the ranks' models differ after two steps")
    return {"res": res, "inputs": inputs, "ref": ref}


def link_dataset(here, name: str, src_base: str, train: list, val: list) -> str:
    """A dataset root under build/ whose scenes are those of ``src_base``
    (linked, not copied), with its own train and val splits."""
    root = fresh_dir(os.path.join(here, "build", name))
    base = os.path.join(root, "scannetv2")
    os.makedirs(base)
    os.symlink(os.path.join(src_base, "scenes"), os.path.join(base, "scenes"))
    for split, names in (("train", train), ("val", val)):
        with open(os.path.join(base, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(names))
    return root


def driver_rank(torch, work: str) -> None:
    """A rank of a driver phase: the driver of spec.json from its command
    line, counted (launches, peak memory, the TrainProbes for a training
    driver), and the process group's backend and device as the driver
    formed them."""
    import importlib

    from geoformer_tpu_torch.kernels.fps import fps
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand
    from geoformer_tpu_torch.kernels.row_gather import row_gather
    from geoformer_tpu_torch.parallel import dist as pdist

    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    mod = importlib.import_module(spec["module"])
    formed = {}
    real_init = pdist.init_distributed

    def recording(*a, **kw):
        out = real_init(*a, **kw)
        formed.update(backend=pdist.backend(), world=pdist.get_world_size())
        return out

    pdist.init_distributed = recording
    counters = {"knn_select": select_min_k_cand, "fps": fps, "row_gather": row_gather}
    if spec["train"]:
        res = run_train_driver(torch, f"{spec['phase']}_rank{rank}", mod.main, spec["argv"],
                               counters, backbone_trains=True, full_phase=spec["full_phase"])
    else:
        res = run_eval_rank(torch, mod.main, spec["argv"], counters)
    formed["device"] = f"cuda:{torch.cuda.current_device()}"
    res.update(rank=rank, process_group=formed)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_eval_rank(torch, main, argv, counters) -> dict:
    """One rank of an eval driver, counted; rank 0's AP table and records."""
    for fn in counters.values():
        fn.launches = 0
    fps_log = counters["fps"].capture = CallLog()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = main(argv)
    torch.cuda.synchronize()
    counters["fps"].capture = None
    return {"seconds": time.time() - t0, "avgs": summary["avgs"], "scenes": summary["scenes"],
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": read_launches(counters, fps_log)}


def ddp_train(torch, cfg_mod, Engine, here, counters, smoke, train) -> dict:
    """``ddp_train``: cli.train on the published supervised config (bf16,
    remat) at DDP_WORLD gloo ranks and a global batch of DDP_TRAIN_BATCH, on
    the first 2 x DDP_TRAIN_BATCH training scenes of the ``train`` phase's
    data (two steps an epoch), one prepare and one full epoch; each rank's
    s/step by phase, peak memory, capacity counters (all 0), model digest
    (equal) and K1 and K2 launches (> 0). Then its checkpoint through a
    one-process cli.test, counted (``ddp_chain_test``)."""
    from geoformer_tpu_torch.cli import test as cli_test

    t0 = time.time()
    base = os.path.join(train["root"], "scannetv2")
    names = [f"scene{i:04d}_00" for i in range(4 * TRAIN_BATCH)]
    root = link_dataset(here, "smoke_ddp_train", base, names[:2 * DDP_TRAIN_BATCH],
                        names[2 * TRAIN_BATCH:])
    cfg = train["cfgs"]["train"].replace(data_root=root, output_path=os.path.join(root, "exp"),
                                         batch_size=DDP_TRAIN_BATCH,
                                         **{k: v[1] for k, v in DDP_TRAIN_CUTS.items()})
    argv = ["--config", write_yaml(os.path.join(root, "train.yaml"), cfg), "--pretrain",
            train["paths"]["pretrain"], "--output_path", cfg.output_path, "--exp_name", "train",
            "--dist_backend", "gloo"]
    work = fresh_dir(os.path.join(here, "build", "smoke_ddp", "train"))
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"phase": "ddp_train", "module": "geoformer_tpu_torch.cli.train",
                   "argv": argv, "train": True, "full_phase": True}, f)
    torch.cuda.empty_cache()
    ranks = start_ranks(here, "driver", work)
    try:
        ranks.wait()
    finally:
        ranks.stop()
    got = []
    for r in range(DDP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            got.append(json.load(f))
    res = {"phase": "ddp_train", "world": DDP_WORLD, "backend": "gloo",
           "global_batch": DDP_TRAIN_BATCH, "cut": DDP_TRAIN_CUTS,
           "config": "config/geoformer_scannet.yaml",
           "ranks": [{k: g[k] for k in ("rank", "process_group", "ms_per_step", "max_memory_gb",
                                        "capacity_counters", "num_gt", "param_digest",
                                        "remat_blocks", "bf16_conv_operands", "seconds")}
                     | {"launches": {k: g["launches"][k]
                                     for k in ("knn_select", "fps", "fps_by_shape")},
                        "losses": g["losses"]} for g in got],
           "seconds": time.time() - t0}
    emit(res)
    if len({g["param_digest"] for g in got}) != 1:
        fail("ddp_train: the ranks' models differ after training")
    if [g["losses"] for g in got[1:]] != [got[0]["losses"]] * (DDP_WORLD - 1):
        fail("ddp_train: the ranks report other global losses")
    if any(g["process_group"].get("backend") != "gloo" or g["process_group"].get("world")
           != DDP_WORLD for g in got):
        fail(f"ddp_train: process groups {[g['process_group'] for g in got]}")
    chain = run_driver(torch, "test", cli_test.main,
                       dict(smoke["paths"]["test"], ckpt=got[0]["checkpoint"]), counters,
                       label="ddp_chain_test")
    emit({"phase": "ddp_chain", "checkpoint": os.path.relpath(got[0]["checkpoint"], here),
          "all_ap": chain["all_ap"], "scenes": len(chain["scenes"])})
    return {"res": res, "ranks": got, "checkpoint": got[0]["checkpoint"], "root": root,
            "chain": chain}


def ddp_eval_and_nccl(torch, cfg_mod, here, smoke, train, ddp) -> dict:
    """``ddp_eval``: cli.test at DDP_WORLD gloo ranks and test_batch_size 2
    on the smoke's 250,000-point val scenes, from ddp_train's checkpoint
    with the class head's logit of class 4 raised by FG_BIAS (so that its
    queries are proposals of the foreground class and the predictions
    compared are not empty), against one process: every scene's
    predictions (digest) and the AP table exactly equal to those of the
    one-process run at test_batch_size 1, whose forwards have the ranks'
    shapes (one scene each). The one-process run of the same command line
    (two scenes a forward) is compared and reported beside it: on the card
    a forward's rounding may depend on its batch size, with or without
    ranks (``one_process_b1_vs_b2``). ``ddp_nccl`` (started with it): cli.train at a world of
    1 under nccl for one prepare step (B = 2 on two training scenes): the
    NCCL process group, the rank's device and the collectives' call sites
    on the card. The one-process eval runs while the ranks do."""
    from geoformer_tpu_torch.cli import test as cli_test
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.weights import load_jax_checkpoint, save_jax_checkpoint

    t0 = time.time()
    cfg = smoke["cfgs"]["test"].replace(test_batch_size=DDP_EVAL_GROUP)
    cut = {"test_batch_size": [smoke["cfgs"]["test"].test_batch_size, DDP_EVAL_GROUP]}
    root = os.path.dirname(smoke["paths"]["test"]["config"])
    engine = Engine(cfg, state_dict=load_jax_checkpoint(ddp["checkpoint"]))
    with torch.no_grad():
        engine.model.detr_sem_head.Dense_2.bias[4] += FG_BIAS
    ckpt = os.path.join(root, "ddp_eval.ckpt")
    save_jax_checkpoint(ckpt, engine.model)
    del engine
    argv = ["--config", write_yaml(os.path.join(root, "ddp_eval.yaml"), cfg), "--pretrain",
            ckpt, "--output_path", os.path.join(root, "exp")]
    argv_b1 = ["--config", write_yaml(os.path.join(root, "ddp_eval_b1.yaml"),
                                      cfg.replace(test_batch_size=1))] + argv[2:]
    work = fresh_dir(os.path.join(here, "build", "smoke_ddp", "eval"))
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"phase": "ddp_eval", "module": "geoformer_tpu_torch.cli.test", "train": False,
                   "argv": argv + ["--exp_name", "ddp_eval_world2", "--dist_backend", "gloo"]}, f)
    base = os.path.join(train["root"], "scannetv2")
    nccl_root = link_dataset(here, "smoke_ddp_nccl", base, ["scene0000_00", "scene0001_00"], [])
    ncfg = train["cfgs"]["train"].replace(data_root=nccl_root, batch_size=2, epochs=1,
                                          prepare_epochs=1, start_epoch=1,
                                          output_path=os.path.join(nccl_root, "exp"))
    nwork = fresh_dir(os.path.join(here, "build", "smoke_ddp", "nccl"))
    with open(os.path.join(nwork, "spec.json"), "w") as f:
        json.dump({"phase": "ddp_nccl", "module": "geoformer_tpu_torch.cli.train", "train": True,
                   "full_phase": False, "argv": [
                       "--config", write_yaml(os.path.join(nccl_root, "train.yaml"), ncfg),
                       "--pretrain", train["paths"]["pretrain"], "--output_path",
                       ncfg.output_path, "--exp_name", "train", "--dist_backend", "nccl"]}, f)
    torch.cuda.empty_cache()
    ranks = start_ranks(here, "driver", work)
    try:
        nccl = start_ranks(here, "driver", nwork, world=1)
        try:
            single = {b: cli_test.main(a + ["--exp_name", f"ddp_eval_world1_b{b}"])
                      for b, a in ((1, argv_b1), (2, argv))}
            ranks.wait()
            nccl.wait()
        finally:
            nccl.stop()
    finally:
        ranks.stop()
    got = []
    for r in range(DDP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            got.append(json.load(f))
    with open(os.path.join(nwork, "rank0.json")) as f:
        n = json.load(f)
    keys = ("scene", "pred_digest", "proposals", "fg_points")
    pick = lambda scenes: [[s[k] for k in keys] for s in scenes]
    # the AP tables through JSON on both sides (NaN for a class with no gt)
    as_json = lambda avgs: json.dumps(avgs, sort_keys=True)
    same = lambda a, b: {"scenes": pick(a["scenes"]) == pick(b["scenes"]),
                         "ap_table": as_json(a["avgs"]) == as_json(b["avgs"])}
    equal = same(got[0], single[1])
    beside = {"vs_one_process_b2": same(got[0], single[2]),
              "one_process_b1_vs_b2": same(single[1], single[2])}
    res = {"phase": "ddp_eval", "world": DDP_WORLD, "backend": "gloo", "cut": cut,
           "checkpoint": os.path.relpath(ckpt, here),
           "all_ap": [single[1]["avgs"]["all_ap"], got[0]["avgs"]["all_ap"]],
           "scenes": pick(got[0]["scenes"]), "equal_to_one_process_b1": equal, **beside,
           "one_process_b2_scenes": pick(single[2]["scenes"]),
           "ranks": [{k: g[k] for k in ("rank", "process_group", "seconds", "max_memory_gb")}
                     | {"launches": {k: g["launches"][k]
                                     for k in ("knn_select", "fps", "fps_by_shape")}}
                     for g in got], "seconds": time.time() - t0}
    emit(res)
    nres = {"phase": "ddp_nccl", "process_group": n["process_group"], "steps": n["steps"],
            "ms_per_step": n["ms_per_step"], "losses": n["losses"],
            "capacity_counters": n["capacity_counters"], "max_memory_gb": n["max_memory_gb"],
            "launches": {k: n["launches"][k] for k in ("knn_select", "fps")},
            "seconds": n["seconds"]}
    emit(nres)
    if not all(equal.values()):
        fail(f"ddp_eval: two ranks differ from one process: {equal}")
    if len(got[0]["scenes"]) != 2 or sum(s["proposals"] for s in single[1]["scenes"]) <= 0:
        fail("ddp_eval: expected two scenes with proposals")
    if any(g["launches"][k] <= 0 for g in got for k in ("knn_select", "fps")):
        fail("ddp_eval: a rank launched no K1 or K2")
    if n["process_group"].get("backend") != "nccl" or n["process_group"].get("world") != 1:
        fail(f"ddp_nccl: process group {n['process_group']}")
    return {"eval": res, "nccl": nres, "rank_launches": [g["launches"] for g in got]}


# ---------------- model parallelism (the JAX ``model`` mesh axis) ----------------

# the model axis of the model-parallel phases, and mp_reference's layouts
# (data x model ranks, all on the one card over gloo)
MP = 2
MP_LAYOUTS = ((1, MP), (2, MP))
# mp_train: __graft_entry__.py's dp x mp dry-run layout, at its global batch
# of two scenes a data index, two full-phase steps
MP_TRAIN_LAYOUT = (2, MP)
MP_TRAIN_BATCH = 4
MP_TRAIN_STEPS = 2
# mp_eval's gate on the ranks' float stages against one process at the same
# batch: at most MP_EVAL_RATIO x how far the card's B = 1 forward is from its
# B = 2 forward at that stage, or MP_EVAL_TOL (PERF.md)
MP_EVAL_RATIO = 8.0
MP_EVAL_TOL = 1e-5
MP_EVAL_MASK_ENTRIES = 16


def mp_ranks(torch, here, phase: str, layout, payload: dict):
    """The data x model ranks of an ``mp_*`` phase (this script's ``mp``
    rank task), started with ``payload`` saved for them -> (work dir,
    Ranks)."""
    work = fresh_dir(os.path.join(here, "build", "smoke_mp", f"{phase}_{layout[0]}x{layout[1]}"))
    torch.save(dict(payload, phase=phase, model_parallel=layout[1]),
               os.path.join(work, "spec.pt"))
    return work, start_ranks(here, "mp", work, world=layout[0] * layout[1])


def mp_results(torch, work: str, world: int) -> list:
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def wait_all(groups) -> None:
    """Wait for every rank group; any failure stops them all."""
    try:
        for ranks in groups:
            ranks.wait()
    finally:
        for ranks in groups:
            ranks.stop()


def mp_rank(torch, work: str) -> None:
    """A rank of an ``mp_*`` phase: its mesh is make_mesh(model_parallel=M)
    under gloo; its results go to rank{r}.pt."""
    from geoformer_tpu_torch.parallel.dist import process_group
    from geoformer_tpu_torch.parallel.mesh import make_mesh

    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    with process_group("gloo"):
        mesh = make_mesh(model_parallel=spec["model_parallel"])
        run = {"mp_reference": mp_reference_rank, "mp_train": mp_train_rank,
               "mp_eval": mp_eval_rank}[spec["phase"]]
        out = run(torch, spec, mesh)
        torch.save(dict(out, rank=mesh.rank, data_rank=mesh.data_rank,
                        model_rank=mesh.model_rank, device=str(mesh.device)),
                   os.path.join(work, f"rank{mesh.rank}.pt"))


def kernels_match_plain(torch, knn_log, fps_log) -> dict:
    """K1 and K2 against their plain versions on the first call of each
    shape that ``knn_log`` / ``fps_log`` (CallLogs with ``keep``) held:
    exact equality, False where no call was held."""
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )

    knn, pts = list(knn_log.first.values()), list(fps_log.first.values())
    return {"knn_select": bool(knn) and all(
                all(torch.equal(bits(torch, a), bits(torch, b)) for a, b in zip(
                    select_min_k_cand(*c), select_min_k_cand_plain(*c))) for c in knn),
            "fps": bool(pts) and all(torch.equal(fps(*c), fps_plain(*c)) for c in pts)}


def held_against_plain(torch, run) -> dict:
    """``run()`` with K1's and K2's calls logged (the first of each shape
    kept), outside any counted or timed run: their inputs stay on the card
    -> ``kernels_match_plain`` on them."""
    from geoformer_tpu_torch.kernels.fps import fps
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand

    logs = select_min_k_cand.capture, fps.capture = CallLog(keep=True), CallLog(keep=True)
    try:
        run()
    finally:
        select_min_k_cand.capture = fps.capture = None
    return kernels_match_plain(torch, *logs)


def k12_launches(reset: bool = False) -> dict | None:
    """K1's and K2's launch counters set to 0 and K2's calls logged from
    then on (``reset``), or read with K2's by shape (the log ends)."""
    from geoformer_tpu_torch.kernels.fps import fps
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand

    if reset:
        select_min_k_cand.launches = fps.launches = 0
        fps.capture = CallLog()
        return None
    log, fps.capture = fps.capture, None
    return read_launches({"knn_select": select_min_k_cand, "fps": fps}, log)


def activation_bytes(traffic: dict) -> int:
    """The largest tensor a step's collectives moved, the gradient's
    all-reduce (a parameter-sized buffer in any data-parallel step) aside."""
    return max((v for k, v in traffic.items() if k != "gradients"), default=0)


def mp_reference_rank(torch, spec, mesh) -> dict:
    from geoformer_tpu_torch.engine import Engine

    out = {"float64": ddp_steps(torch, Engine, spec["inputs"], torch.float64, mesh)}
    out["float32"] = ddp_steps(torch, Engine, spec["inputs"], torch.float32, mesh,
                               matches=out["float64"]["matches"])
    return out


def mp_reference(torch, here, ddp) -> dict:
    """ddp_reference's step (train_small_reference's inputs: the published
    U-Net depth, B = 2) on the MP_LAYOUTS data x model meshes, each scene's
    queries split over MP model ranks, against ddp_reference's one-process
    steps on the card. Float64: loss, every applied gradient and every BN
    statistic within SMALL_REF_TOL64 x max(1, |ref|inf), the matched
    instances and each scene's matches equal, and each rank's geodesic table
    bit-equal to its columns of the one-process table (the -1 pattern
    included; float32's too). Float32: module by module no further from the
    float64 step than SMALL_REF_RATIO times the one-process float32 step (as
    ddp_reference). Both: ranks bit-equal after two steps; the largest
    activation any collective moved below one scene's [F, Q] table."""
    t0 = time.time()
    inputs, ref = ddp["inputs"], ddp["ref"]
    cfg = inputs["cfg"]
    groups = {layout: mp_ranks(torch, here, "mp_reference", layout, {"inputs": inputs})
              for layout in MP_LAYOUTS}
    wait_all([ranks for _, ranks in groups.values()])
    r64, r32 = ref["float64"], ref["float32"]
    res = {"phase": "mp_reference", "backend": "gloo", "batch": 2,
           "unet_depth": SMALL_REF_DEPTH, "points": cfg.tpu_max_points,
           "queries": cfg.n_query_points, "tol64": SMALL_REF_TOL64, "layouts": {}}
    failures = []
    for (n_data, m), (work, _) in groups.items():
        got = mp_results(torch, work, n_data * m)
        name = f"{n_data}x{m}"
        g64 = got[0]["float64"]
        errs = {"grads": grad_errors(g64["grads"], r64["grads"]),
                "stats": grad_errors(g64["stats"], r64["stats"])}
        worst = {k: max(e.items(), key=lambda kv: kv[1]) for k, e in errs.items()}
        loss_err = abs(g64["loss"] - r64["loss"]) / max(1.0, abs(r64["loss"]))
        e2 = grad_errors(got[0]["float32"]["grads"], r64["grads"])
        e1 = grad_errors(r32["grads"], r64["grads"])
        by_module = {}
        for k in r64["grads"]:
            pair = by_module.setdefault(k.split(".")[0], [0.0, 0.0])
            pair[0], pair[1] = max(pair[0], e2[k]), max(pair[1], e1[k])
        over = sorted(mod for mod, (mp_err, one) in by_module.items()
                      if mp_err > max(SMALL_REF_TOL, SMALL_REF_RATIO * one))
        b = 2 // n_data
        per = cfg.n_query_points // m
        geo_equal, matches_equal = {}, {}
        for dt, one in (("float64", r64), ("float32", r32)):
            geo_equal[dt] = all(torch.equal(
                g[dt]["geo"], one["geo"][g["data_rank"] * b:(g["data_rank"] + 1) * b, :,
                                         g["model_rank"] * per:(g["model_rank"] + 1) * per])
                for g in got)
            matches_equal[dt] = all(torch.equal(
                g[dt]["matches"], r64["matches"][g["data_rank"] * b:(g["data_rank"] + 1) * b])
                for g in got)
        table = cfg.tpu_max_fg_points * cfg.n_query_points
        moved = {dt: max(activation_bytes(g[dt]["traffic"]) for g in got)
                 for dt in ("float64", "float32")}
        digests = {dt: [g[dt]["digest"][:16] for g in got] for dt in ("float64", "float32")}
        res["layouts"][name] = {
            "world": n_data * m, "rank_devices": [g["device"] for g in got],
            "loss": g64["loss"], "f64_loss_rel_err": loss_err,
            "num_gt": [r64["num_gt"], g64["num_gt"]],
            "f64_worst": {k: list(v) for k, v in worst.items()},
            "geo_bit_equal": geo_equal, "matches_equal_to_f64": matches_equal,
            "f32_by_module": by_module, "f32_modules_over": over,
            "largest_activation_bytes": moved,
            "table_bytes": {"float64": 8 * table, "float32": 4 * table},
            "traffic_f32_rank0": got[0]["float32"]["traffic"],
            "rank_digests_after_2_steps": digests,
            "launches_f32": [g["float32"]["launches"] for g in got]}
        if (loss_err > SMALL_REF_TOL64 or max(v[1] for v in worst.values()) > SMALL_REF_TOL64
                or g64["num_gt"] != r64["num_gt"] or not geo_equal["float64"]
                or not matches_equal["float64"]):
            failures.append(f"{name}: the float64 step differs from the one-process step")
        if over:
            failures.append(f"{name}: float32 further from float64 in {over}")
        if any(len(set(v)) != 1 for v in digests.values()):
            failures.append(f"{name}: the ranks' models differ after two steps")
        if moved["float64"] >= 8 * table or moved["float32"] >= 4 * table:
            failures.append(f"{name}: a collective moved a table-sized activation: {moved}")
        if any(g["float32"]["launches"][k] <= 0 for g in got for k in ("knn_select", "fps")):
            failures.append(f"{name}: a rank launched no K1 or K2")
    res["seconds"] = time.time() - t0
    emit(res)
    if failures:
        fail(f"mp_reference: {failures}")
    return res


def mp_train_rank(torch, spec, mesh) -> dict:
    """MP_TRAIN_STEPS full-phase Engine.train_steps at the published widths
    on this rank's scenes and queries: s a step, peak memory, the second
    step's stage ms, capacity counters, K1/K2 launches, the collectives'
    largest tensors and a digest of the model; then K1 and K2 held against
    their plain versions on an eval forward of the same scenes."""
    from geoformer_tpu_torch.cli.train import state_digest
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.parallel.mesh import TRAFFIC

    # dropout draws from the process's generator: alike within a model
    # group (the ranks of one data index run the same backbone)
    torch.manual_seed(1000 + mesh.data_rank)
    engine = Engine(spec["cfg"], state_dict=spec["sd"], mesh=mesh)
    engine.init_state()
    gen = torch.Generator(device=engine.device).manual_seed(0)
    epoch = spec["cfg"].prepare_epochs + 1
    k12_launches(reset=True)
    TRAFFIC.reset()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, counters = [], [], {}
    for i in range(MP_TRAIN_STEPS):
        if i == MP_TRAIN_STEPS - 1:
            engine.model.stage_ms = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, ld, _ = engine.train_step(spec["batch"], epoch, gen)
        losses.append({k: float(v) for k, v in ld.items()})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        for k, v in engine.last_voxel_stats.items():
            if k in CAPACITY_KEYS:
                counters[k] = max(counters.get(k, 0), int(v.sum()))
    res = {"launches": k12_launches(), "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "digest": state_digest(engine.model), "traffic": dict(TRAFFIC.largest),
           "traffic_bytes": dict(TRAFFIC.bytes)}
    # K1 and K2 on this rank's tables, in an eval forward at the same shapes
    res["kernels_equal_plain"] = held_against_plain(torch, lambda: engine.eval_batch(spec["batch"]))
    return {**res, "s_per_step": step_s, "losses": losses, "stage_ms": engine.model.stage_ms,
            "capacity_counters": counters,
            "state": {k: v.detach().cpu() for k, v in engine.model.state_dict().items()}}


def geodesic_ms(torch, engine, batch, splits=(1, MP), reps: int = 5) -> dict:
    """Host-clock ms of a training-mode radius graph + geodesic solve on
    ``batch`` at the seeds of one rank of a model axis of each of
    ``splits`` (a mesh with no process group: no collective), the splits
    alternated, ``reps`` times each after one warm-up round."""
    from geoformer_tpu_torch.parallel.mesh import Mesh, set_mesh

    with torch.no_grad():
        tb = engine.to_device(batch)
        feats, _, preds, _ = engine.model.forward_backbone(tb)
        fg_idx, fg_valid = engine.model.foreground_pack(preds, tb["point_mask"])
        gather = lambda t: torch.gather(t, 1, fg_idx[..., None].expand(-1, -1, t.shape[-1]))
        fg_locs = gather(tb["points"])
        _, _, inds, valid = engine.model.forward_aggregator(fg_locs, gather(feats), fg_valid)
        res = {m: {"ms": []} for m in splits}
        for i in range(reps + 1):
            for m in splits:
                with set_mesh(Mesh(0, m, engine.device, model_parallel=m)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    geo = engine.model.forward_geodesic(fg_locs, fg_valid, inds, valid,
                                                        train=True)[0]
                    torch.cuda.synchronize()
                if i:
                    res[m]["ms"].append((time.perf_counter() - t) * 1e3)
                res[m]["table_shape"] = list(geo.shape)
    for r in res.values():
        r["median_ms"] = sorted(r["ms"])[len(r["ms"]) // 2]
    return {"Q" if m == 1 else f"Q/{m}": r for m, r in res.items()}


def mp_train(torch, cfg_mod, Engine, synthetic_batch, here) -> dict:
    """``mp_train``: MP_TRAIN_STEPS full-phase steps of Engine.train_step at
    config/geoformer_scannet.yaml's widths (bf16 sparse convs and remat as
    published) on MP_TRAIN_LAYOUT data x model gloo ranks, a global batch of
    MP_TRAIN_BATCH synthetic 250,000-point scans, seeded weights with the
    foreground class biased on. Per rank: s a step, peak memory, stage ms,
    capacity counters (0), K1/K2 launches (> 0), the largest activation a
    collective moved (below one scene's [F, Q] table) and the model's digest
    (equal on every rank). Then, in this process without collectives, one
    data index's radius graph + geodesic solve at Q and at Q/MP seeds, and
    one one-process step on its scenes (s, peak memory)."""
    from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
    from geoformer_tpu_torch.weights import random_state_dict

    t0 = time.time()
    cfg = cfg_mod.load_config(os.path.join(here, "config", "geoformer_scannet.yaml"),
                              batch_size=MP_TRAIN_BATCH)
    sd = random_state_dict(GeoFormer(ModelConfig.from_cfg(cfg)), 0)
    sd["semantic.Dense_2.bias"][4] += FG_BIAS
    batch = synthetic_batch(cfg, MP_TRAIN_BATCH, seed=21)
    n_data, m = MP_TRAIN_LAYOUT
    torch.cuda.empty_cache()
    work, ranks = mp_ranks(torch, here, "mp_train", MP_TRAIN_LAYOUT,
                           {"cfg": cfg, "sd": sd, "batch": batch})
    wait_all([ranks])
    got = mp_results(torch, work, n_data * m)
    # one data index's scenes in this process: the geodesic solve at Q and
    # at Q/MP seeds, and one step at Q
    rows = {k: v[:MP_TRAIN_BATCH // n_data] for k, v in batch.items()}
    engine = Engine(cfg.replace(batch_size=MP_TRAIN_BATCH // n_data), state_dict=sd)
    geo = geodesic_ms(torch, engine, rows)
    engine.init_state()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=engine.device).manual_seed(0)
    one_s = []
    for _ in range(MP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.train_step(rows, cfg.prepare_epochs + 1, gen)
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t)
    one_mem = torch.cuda.max_memory_allocated() / 1e9
    del engine
    torch.cuda.empty_cache()
    fg, q = cfg.tpu_max_fg_points, cfg.n_query_points
    res = {"phase": "mp_train", "layout": f"{n_data}x{m}", "backend": "gloo",
           "global_batch": MP_TRAIN_BATCH, "config": "config/geoformer_scannet.yaml",
           "ranks": [{k: g[k] for k in ("rank", "data_rank", "model_rank", "device",
                                        "s_per_step", "max_memory_gb", "capacity_counters",
                                        "launches", "kernels_equal_plain", "stage_ms")}
                     | {"geodesic_ms": g["stage_ms"].get("geodesic"),
                        "largest_activation_bytes": activation_bytes(g["traffic"]),
                        "loss": g["losses"][0]["loss"], "digest": g["digest"][:16]}
                     for g in got],
           "traffic_rank0": got[0]["traffic"], "table_bytes": 4 * fg * q,
           "traffic_bytes_rank0_two_steps": got[0]["traffic_bytes"],
           "one_process_same_scenes": {"s_per_step": one_s, "max_memory_gb": one_mem,
                                       "geodesic_alone": geo},
           "seconds": time.time() - t0}
    emit(res)
    if len({g["digest"] for g in got}) != 1:
        apart = {r: [k for k, v in g["state"].items() if not torch.equal(v, got[0]["state"][k])]
                 for r, g in enumerate(got)}
        fail(f"mp_train: the ranks' models differ after the steps: {apart}")
    if any(g["losses"] != got[0]["losses"] for g in got):
        fail("mp_train: the ranks report other global losses")
    if any(any(v for v in g["capacity_counters"].values()) for g in got):
        fail("mp_train: a capacity counter is not 0")
    if any(g["launches"][k] <= 0 for g in got for k in ("knn_select", "fps")):
        fail("mp_train: a rank launched no K1 or K2")
    if not all(v for g in got for v in g["kernels_equal_plain"].values()):
        fail("mp_train: K1 or K2 differs from its plain version on a rank's calls")
    if any(activation_bytes(g["traffic"]) >= 4 * fg * q for g in got):
        fail("mp_train: a collective moved a table-sized activation")
    if not all(math.isfinite(v) for g in got for v in g["losses"][0].values()):
        fail("mp_train: a loss is not finite")
    return {"res": res, "rank_launches": [g["launches"] for g in got]}


class StageCapture:
    """Scene 0's output of each forward stage, read off the model while the
    block runs (on the CPU): semantic scores, fg indices and validity,
    context indices and validity, the kNN ids of the radius graph, the
    geodesic table (this rank's query columns), the last decoder layer
    (this rank's query rows)."""

    STAGES = ("forward_backbone", "foreground_pack", "forward_aggregator", "forward_geodesic",
              "run_decoder")

    def __init__(self, model):
        self.model, self.out = model, {}

    def __enter__(self):
        import geoformer_tpu_torch.models.geoformer as gf

        out = self.out
        keep = {"forward_backbone": lambda r: {"semantic_scores": r[1][0]},
                "foreground_pack": lambda r: {"fg_idx": r[0][0], "fg_valid": r[1][0]},
                "forward_aggregator": lambda r: {"context_inds": r[2][0],
                                                 "context_valid": r[3][0]},
                "forward_geodesic": lambda r: {"geo": r[0][0]},
                "run_decoder": lambda r: {"decoder": r[0][-1, 0]}}

        def wrap(fn, pick):
            def run(*a, **kw):
                r = fn(*a, **kw)
                out.update({k: v.detach().cpu() for k, v in pick(r).items()})
                return r
            return run

        for name in self.STAGES:
            setattr(self.model, name, wrap(getattr(self.model, name), keep[name]))
        self.knn = gf.radius_knn
        gf.radius_knn = wrap(self.knn, lambda r: {"knn_ids": r[1][0]})
        return out

    def __exit__(self, *exc):
        import geoformer_tpu_torch.models.geoformer as gf

        for name in self.STAGES:
            delattr(self.model, name)
        gf.radius_knn = self.knn


def eval_capture(torch, engine, batch) -> dict:
    """engine.eval_batch with scene 0's stages captured (StageCapture), its
    mask and class logits, and its proposals and NMS where this rank
    returns them."""
    with StageCapture(engine.model) as cap:
        out = engine.eval_batch(batch)
    cap["mask_logits"] = out["mask_logits"][-1, 0].cpu()
    cap["cls_logits"] = out["cls_logits"][-1, 0].cpu()
    if "proposals" in out:
        cap["proposals"] = {k: v[0].cpu() for k, v in out["proposals"].items()}
        cap["nms_keep"] = out["nms"]["keep"][0].cpu()
    return cap


def mp_eval_rank(torch, spec, mesh) -> dict:
    """Engine.eval_batch on the global batch under the data x model mesh,
    counted (K1/K2 launches, peak memory) and timed, then once more with
    scene 0's stages captured."""
    from geoformer_tpu_torch.engine import Engine

    engine = Engine(spec["cfg"], state_dict=spec["sd"], mesh=mesh)
    k12_launches(reset=True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = engine.eval_batch(spec["batch"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    res = {"launches": k12_launches(), "ms_per_scene": ms / len(spec["batch"]["points"]),
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "capacity_counters": {k: int(v.sum()) for k, v in out["voxel_stats"].items()
                                 if k in CAPACITY_KEYS}}
    del out
    cap = {}
    res["kernels_equal_plain"] = held_against_plain(
        torch, lambda: cap.update(eval_capture(torch, engine, spec["batch"])))
    return dict(res, capture=cap)


def stage_diffs(torch, a: dict, b: dict) -> dict:
    """Stage by stage: integer stages equal (bool), float stages' max abs
    difference, the proposals' keep/classes equal and mask entries apart."""
    out = {}
    for k in ("fg_idx", "fg_valid", "context_inds", "context_valid", "knn_ids"):
        out[k] = bool(torch.equal(a[k], b[k]))
    out["geo_unreached_equal"] = bool(torch.equal(a["geo"] < 0, b["geo"] < 0))
    for k in ("semantic_scores", "geo", "decoder", "cls_logits", "mask_logits"):
        out[k] = float((a[k].double() - b[k].double()).abs().max())
    pa, pb = a.get("proposals"), b.get("proposals")
    if pa is not None and pb is not None:
        out["proposals"] = {"keep": bool(torch.equal(pa["keep"], pb["keep"])),
                            "classes": bool(torch.equal(pa["classes"], pb["classes"])),
                            "scores": float((pa["scores"] - pb["scores"]).abs().max()),
                            "mask_entries_apart": int((pa["masks"] != pb["masks"]).sum()),
                            "nms_keep": bool(torch.equal(a["nms_keep"], b["nms_keep"]))}
    return out


def gemm_rows_probe(torch) -> dict:
    """Whether a float32 matrix product's rows depend on how many rows are
    multiplied with them on this card: x[:n] @ w against (x @ w)[:n] for the
    decoder's and the sparse conv's widths, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for n, k, c in ((128, 256, 256), (256, 256, 256), (65536, 16, 16), (131072, 32, 32)):
        x = torch.randn(2 * n, k, device="cuda", generator=g)
        w = torch.randn(k, c, device="cuda", generator=g)
        res[f"{n}x{k}x{c}"] = bool(torch.equal((x[:n] @ w), (x @ w)[:n]))
    return res


def mp_eval(torch, here, smoke) -> dict:
    """``mp_eval``: Engine.eval_batch on the two 250,000-point val scenes of
    the smoke's dataset (config/test_geoformer_scannet.yaml, its seeded
    checkpoint with the class head's class 4 raised by FG_BIAS so that
    proposals exist) at 1xMP gloo ranks, counted and timed per rank, against
    one process at B = 2 (the ranks' batch) and at B = 1 (scene 0 alone):
    scene 0 compared stage by stage (StageCapture) between B = 1 and B = 2
    and between one process and the ranks (Q against Q/MP queries a rank).
    The integer stages must be equal and the geodesic table's -1 pattern
    too; the ranks' float stages and proposal scores no further from one
    process at B = 2 than MP_EVAL_RATIO x the distance of B = 1 from B = 2
    (or MP_EVAL_TOL), their proposals' keep, classes and NMS equal, and
    their proposal masks apart in no more entries than MP_EVAL_RATIO x
    those of B = 1 and B = 2 (or MP_EVAL_MASK_ENTRIES): entries whose
    sigmoid sits at the 0.5 threshold."""
    from geoformer_tpu_torch.cli.test import stack_group
    from geoformer_tpu_torch.data.scannet import InstDataset
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.weights import load_jax_checkpoint

    t0 = time.time()
    cfg = smoke["cfgs"]["test"].replace(test_batch_size=2)
    sd = load_jax_checkpoint(smoke["paths"]["test"]["ckpt"])
    sd["detr_sem_head.Dense_2.bias"][4] += FG_BIAS
    scenes = [b for _, b in InstDataset(cfg, "val").test_batches()]
    batch = stack_group(scenes, 2)
    layout = (1, MP)
    torch.cuda.empty_cache()
    work, ranks = mp_ranks(torch, here, "mp_eval", layout,
                           {"cfg": cfg, "sd": sd, "batch": batch})
    try:  # the one-process forwards run while the ranks start
        engine = Engine(cfg, state_dict=sd)
        one = {"b1": eval_capture(torch, engine, scenes[0]),
               "b2": eval_capture(torch, engine, batch)}
        del engine
        ranks.wait()
    finally:
        ranks.stop()
    got = mp_results(torch, work, MP)
    caps = [g["capture"] for g in got]
    mp_cap = dict(caps[0], geo=torch.cat([c["geo"] for c in caps], dim=1),
                  decoder=torch.cat([c["decoder"] for c in caps], dim=0))
    ranks_agree = all(torch.equal(c[k], caps[0][k]) for c in caps
                      for k in ("mask_logits", "cls_logits", "fg_idx", "context_inds"))
    diffs = {"b1_vs_b2": stage_diffs(torch, one["b1"], one["b2"]),
             "b2_vs_ranks": stage_diffs(torch, one["b2"], mp_cap),
             "b1_vs_ranks": stage_diffs(torch, one["b1"], mp_cap)}
    floats = ("semantic_scores", "geo", "decoder", "cls_logits", "mask_logits")
    bound = {k: max(MP_EVAL_TOL, MP_EVAL_RATIO * diffs["b1_vs_b2"][k]) for k in floats}
    ints = ("fg_idx", "fg_valid", "context_inds", "context_valid", "knn_ids",
            "geo_unreached_equal")
    res = {"phase": "mp_eval", "layout": f"1x{MP}", "backend": "gloo",
           "config": "config/test_geoformer_scannet.yaml", "scenes": 2,
           "points": cfg.tpu_max_points, "queries": cfg.n_query_points,
           "ranks": [{k: g[k] for k in ("rank", "device", "ms_per_scene", "max_memory_gb",
                                        "launches", "kernels_equal_plain",
                                        "capacity_counters")} for g in got],
           "proposals_kept": {k: int(c["proposals"]["keep"].sum()) for k, c in
                              (("b1", one["b1"]), ("b2", one["b2"]), ("ranks", mp_cap))},
           "ranks_agree": ranks_agree, "diffs": diffs, "float_bound": bound,
           "gemm_rows_bit_equal": gemm_rows_probe(torch),
           "tol": MP_EVAL_TOL, "ratio": MP_EVAL_RATIO, "mask_entries": MP_EVAL_MASK_ENTRIES,
           "seconds": time.time() - t0}
    emit(res)
    d = diffs["b2_vs_ranks"]
    bad = [k for k in ints if not d[k]] + [k for k in floats if d[k] > bound[k]]
    p1, p2 = diffs["b1_vs_b2"]["proposals"], d["proposals"]
    if not (p2["keep"] and p2["classes"] and p2["nms_keep"]) or p2["scores"] > max(
            MP_EVAL_TOL, MP_EVAL_RATIO * p1["scores"]) or p2["mask_entries_apart"] > max(
            MP_EVAL_MASK_ENTRIES, MP_EVAL_RATIO * p1["mask_entries_apart"]):
        bad.append("proposals")
    if bad or not ranks_agree:
        fail(f"mp_eval: the ranks differ from one process in {bad or 'their gathered logits'}")
    if "proposals" in caps[1] or res["proposals_kept"]["b2"] <= 0:
        fail("mp_eval: expected proposals on model index 0 only, and some kept")
    if any(g["launches"][k] <= 0 for g in got for k in ("knn_select", "fps")):
        fail("mp_eval: a rank launched no K1 or K2")
    if not all(v for g in got for v in g["kernels_equal_plain"].values()):
        fail("mp_eval: K1 or K2 differs from its plain version on a rank's calls")
    if any(v for g in got for v in g["capacity_counters"].values()):
        fail("mp_eval: a capacity counter is not 0")
    return {"res": res, "rank_launches": [g["launches"] for g in got]}


# ---------------- the throughput entry points ----------------

# cli.bench's scales (bench.py's SCALES) and forwards a run (the first and
# 8 timed); train_bench's runs: the defaults (B = 1, full phase, 250,000
# points), --prepare, --fs, and 1 x 2 mesh ranks on the one card. Two timed
# steps a run (three took the phases to 148 s on an H100, of which each
# run's start and first step, ~20 s, are fixed)
BENCH_RUN_SCALES = ("prod", "full")
BENCH_FORWARDS = 9
TRAIN_BENCH_RUNS = (("train_bench", ["--steps", "2"]),
                    ("train_bench_prepare", ["--prepare", "--steps", "2"]),
                    ("train_bench_fs", ["--fs", "--steps", "2"]),
                    ("train_bench_mesh", ["--mesh", "2", "--steps", "1"]))
TOOL_TIMEOUT_S = 600


def run_tool(here, module: str, argv: list) -> tuple:
    """``python3 -m module *argv`` from the repository root, in a session of
    its own (a timeout stops it and every rank it started) -> (its last
    stdout line as JSON, the ``launches`` objects among its stdout and
    stderr lines, a ``rank<r>: `` prefix taken off, seconds). A non-zero
    exit fails the run."""
    t = time.time()
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=here,
                            env=dict(os.environ, PYTHONPATH=here), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TOOL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{module} {argv} outlived {TOOL_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"{module} {argv} exited {proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    launches = []
    for line in out.splitlines() + err.splitlines():
        body = re.sub(r"^rank\d+: ", "", line)
        if body.startswith("{") and '"launches"' in body:
            launches.append(json.loads(body))
    return json.loads(out.strip().splitlines()[-1]), launches, time.time() - t


def check_card_keys(torch, name: str, line: dict) -> None:
    if line["device"] != torch.cuda.get_device_name(0) or not line["power_limit_w"]:
        fail(f"{name}: device {line['device']!r}, power limit {line['power_limit_w']!r}")


def bench_eval(torch, here) -> dict:
    """cli.bench at each of BENCH_RUN_SCALES, B = 1, as a subprocess: a rate
    above 0, no hard capacity counter above 0 (the soft window counter is
    printed), a foreground, the card's name and power limit, and K1's and
    K2's launches over the run BENCH_FORWARDS x those of its first forward
    -> {scale: the run's launches}."""
    from geoformer_tpu_torch.cli.bench import SOFT_COUNTER

    by_scale = {}
    for scale in BENCH_RUN_SCALES:
        line, counts, seconds = run_tool(here, "geoformer_tpu_torch.cli.bench",
                                         ["--scale", scale])
        emit({"phase": "bench_eval", "scale": scale, "seconds": seconds, "result": line,
              "launch_lines": counts})
        hard = {k: v for k, v in line["degradation_counters"].items() if k != SOFT_COUNTER}
        if not (line["metric"] == "scene_inference" and line["scale"] == scale
                and line["batch_size"] == 1 and line["value"] > 0):
            fail(f"bench {scale}: {line}")
        if line["dropped_points"] != 0 or any(hard.values()):
            fail(f"bench {scale}: points dropped {line['degradation_counters']}")
        if line["fg_points"] <= 0:
            fail(f"bench {scale}: no foreground point")
        check_card_keys(torch, f"bench {scale}", line)
        if len(counts) != 1 or counts[0]["forwards"] != BENCH_FORWARDS:
            fail(f"bench {scale}: launch lines {counts}")
        total, first = counts[0]["launches"], counts[0]["first_call_launches"]
        for name in ("knn_select", "fps"):
            if first[name] <= 0 or total[name] != BENCH_FORWARDS * first[name]:
                fail(f"bench {scale}: {name} launched {total[name]} times in "
                     f"{BENCH_FORWARDS} forwards, {first[name]} in the first")
        by_scale[scale] = total
    return by_scale


def bench_full_kernels(torch, Engine, synthetic_batch, held: dict, launches: dict) -> list:
    """One eval forward at cli.bench's ``full`` scale (its config, weights,
    batch and generator), outside the counted runs, capturing K1's and K2's
    inputs; each shape that no earlier phase held gets a ``kernel`` line
    (K1 or K2 against its plain version, timed), with the launches the
    ``full`` run made -> those rows. ``held``: {kernel name: shapes held}."""
    from geoformer_tpu_torch.cli.bench import bench_config
    from geoformer_tpu_torch.kernels.fps import fps, fps_plain
    from geoformer_tpu_torch.kernels.knn_select import (
        select_min_k_cand,
        select_min_k_cand_plain,
    )

    cfg = bench_config("full")
    engine = Engine(cfg, seed=0)
    batch = engine.to_device(synthetic_batch(cfg, 1, seed=0))
    logs = select_min_k_cand.capture, fps.capture = CallLog(keep=True), CallLog(keep=True)
    try:
        with torch.no_grad():
            engine.model(batch, train=False,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    finally:
        select_min_k_cand.capture = fps.capture = None
    del engine, batch
    rows = []
    for key, (d2, cand, k) in logs[0].first.items():
        if list(key) in held["knn_select"]:
            continue
        n, w = d2.shape
        rows.append(kernel_row(
            torch, name="knn_select", source="geoformer_tpu_torch/csrc/knn_select.cu",
            replaces="geoformer_tpu/ops/knn_select_pallas.py:34",
            launches=launches["knn_select"],
            kernel=lambda: select_min_k_cand(d2, cand, k),
            plain=lambda: select_min_k_cand_plain(d2, cand, k),
            library=lambda: torch.topk(d2, k, dim=1, largest=False),
            bytes_=n * w * 4 + n * k * 4 + n * k * 8, ops=n * w * k, shape=[n, w, k],
            reps=20, plain_reps=3, path="bench_full",
            exact_share=exact_share(torch, select_min_k_cand, d2, cand, k)))
    for key, inputs in logs[1].first.items():
        if list(key) not in held["fps"]:
            rows.append(dict(fps_row(torch, fps, fps_plain, inputs, launches["fps"]),
                             path="bench_full"))
    logs[0].first.clear()
    logs[1].first.clear()
    torch.cuda.empty_cache()
    return rows


def train_bench(torch, here) -> dict:
    """tools/train_bench.py's counterpart as a subprocess, each run of
    TRAIN_BENCH_RUNS: a finite loss and p50 step, scenes/s, peak memory, the
    card's name and power limit, and in every full-phase run K1 and K2
    launched on every rank -> {path: launches} (the mesh run's a rank)."""
    by_path = {}
    for name, argv in TRAIN_BENCH_RUNS:
        line, counts, seconds = run_tool(here, "geoformer_tpu_torch.tools.train_bench", argv)
        emit({"phase": "train_bench", "run": name, "argv": argv, "seconds": seconds,
              "result": line, "launch_lines": counts})
        if not (line["metric"] == "train_step" and math.isfinite(line["loss"])
                and math.isfinite(line["p50_step_s"]) and line["p50_step_s"] > 0
                and line["scenes_per_sec"] > 0 and line["max_memory_allocated_bytes"]):
            fail(f"train_bench {name}: {line}")
        check_card_keys(torch, f"train_bench {name}", line)
        ranks = 2 if "--mesh" in argv else 1
        if sorted(c["rank"] for c in counts) != list(range(ranks)):
            fail(f"train_bench {name}: launch lines {counts}")
        for c in counts:
            if line["phase"] != "prepare" and min(c["launches"]["knn_select"],
                                                  c["launches"]["fps"]) <= 0:
                fail(f"train_bench {name}: rank {c['rank']} launched {c['launches']}")
            by_path[name if ranks == 1 else f"{name}_rank{c['rank']}"] = c["launches"]
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", type=int, default=2, help="full-size scenes to run (>= 2)")
    # the data-parallel phases start this script again as their ranks
    ap.add_argument("--rank-task", choices=("ddp_reference", "driver", "mp"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    started = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "geoformer_tpu_torch")):
        print("chip_smoke: geoformer_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    if args.rank_task:
        {"ddp_reference": ddp_reference_rank, "driver": driver_rank, "mp": mp_rank}[
            args.rank_task](torch, args.work)
        return 0

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
    from geoformer_tpu_torch.tools.k3_sources import fg_gather_inputs, sweep_slab, train_queries

    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    so = kernels.build()
    emit({"phase": "build", "library": os.path.relpath(so, here),
          "sources": [os.path.basename(p) for p in kernels.sources()],
          "seconds": time.time() - t0,
          # registers, shared memory and spills of each kernel (ptxas -v)
          "ptxas": [" ".join(line.split()) for line in kernels.build_log().splitlines()
                    if "Compiling entry" in line or "Used" in line or "spill" in line]})

    counters = {"knn_select": select_min_k_cand, "fps": fps, "row_gather": row_gather}
    small_reference(torch, cfg_mod, Engine, synthetic_batch)
    edges = kernel_edges(torch)

    # ---------------- main path: full-width forwards ----------------
    cfg = cfg_mod.scannet_eval_config()
    engine = Engine(cfg, seed=0)
    mc = engine.mc
    P, F, Q, C = cfg.tpu_max_points, mc.max_fg_points, mc.n_query_points, mc.classes
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    fps_log = fps.capture = CallLog()
    scene_ms = []
    for seed in range(max(args.scenes, 2)):
        batch = synthetic_batch(cfg, 1, seed=seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.eval_batch(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        scene_ms.append(ms)

        check_eval_out(torch, out, P, F, Q, C)
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
    # the real-size inputs of the K3 phase: the forward's own foreground
    # gather (gather_rows(point_feats, fg_idx)) and one block's slab of the
    # geodesic fine sweep's gather on this scene's radius-kNN table, into a
    # table as wide as the training step's (one more forward)
    gather_x, gather_idx = fg_gather_inputs(engine, batch)
    sweep_x, sweep_idx = sweep_slab(engine, batch, train_queries())
    del out, engine
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
        reps=20, plain_reps=3, exact_share=exact_share(torch, select_min_k_cand, d2, cand, k))
    k1_shape = [n, w, k]
    del d2, cand, knn_inputs
    k2_shape = json.dumps([*fps_inputs[0][0].shape[:2], fps_inputs[0][2]])
    k2_row = fps_row(torch, fps, fps_plain, fps_inputs[0],
                     launches["fps_by_shape"].get(k2_shape, 0))
    if k2_row["launches"] != launches["fps"]:
        fail(f"fps: the main path launched {launches['fps_by_shape']}, held at {k2_shape}")
    del fps_inputs

    # ---------------- the config-reachable off-path branches ----------------
    off = offpath(torch, cfg_mod, Engine, synthetic_batch, counters)

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
    by_path = {"eval_batch": launches, "gather_probe": {"row_gather": probe_launches},
               **off["by_path"]}
    for name, main_fn in (("test", cli_test.main), ("test_fs", cli_test_fs.main)):
        by_path[f"driver_{name}"] = run_driver(
            torch, name, main_fn, data["paths"][name], counters)["launches"]

    # the library ops, the native elastic and cli.test with its two flags
    by_path["library_cli_test"] = library(torch, cli_test.main, data, counters, by_path, here)

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
    k1_row["exact_share_few_shot"] = exact_share(torch, select_min_k_cand, d2, cand, k)
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

    # ---------------- K3 at the probe's shape, the forward's fg gather, the sweep's slab ----------------
    px, pidx = (torch.from_numpy(a).cuda() for a in gather_probe.probe_inputs())
    k3_row = row_gather_row(torch, row_gather, row_gather_plain, px, pidx, probe_launches)
    # the forward and the sweep gather with PyTorch's indexing, so these
    # shapes' launches are what the three counted model paths read off K3's
    # counter
    model_launches = sum(by_path[p]["row_gather"]
                         for p in ("eval_batch", "driver_test", "driver_test_fs"))
    k3_large = row_gather_row(torch, row_gather, row_gather_plain, gather_x, gather_idx,
                              model_launches)
    k3_sweep = row_gather_row(torch, row_gather, row_gather_plain, sweep_x, sweep_idx,
                              model_launches)
    del gather_x, gather_idx, sweep_x, sweep_idx

    # the training paths: cli.train, the chain through cli.test, cli.train_fs
    trained = train_paths(torch, cfg_mod, Engine, here, TRAIN_BATCH, counters, data)
    train_small_reference(torch, cfg_mod, Engine, synthetic_batch)
    by_path.update(trained["by_path"])

    # data parallelism: ranks of this script on the one card
    ddp_ref = ddp_reference(torch, cfg_mod, Engine, synthetic_batch, here)
    ddp = ddp_train(torch, cfg_mod, Engine, here, counters, data, trained["data"])
    ddp_eval = ddp_eval_and_nccl(torch, cfg_mod, here, data, trained["data"], ddp)
    for r, g in enumerate(ddp["ranks"]):
        by_path[f"ddp_train_rank{r}"] = g["launches"]
    by_path["ddp_chain_test"] = ddp["chain"]["launches"]
    for r, launches in enumerate(ddp_eval["rank_launches"]):
        by_path[f"ddp_eval_rank{r}"] = launches

    # model parallelism: data x model ranks of this script on the one card
    mp = {f"mp_reference_{name}": {"rank_launches": got["launches_f32"]} for name, got in
          mp_reference(torch, here, ddp_ref)["layouts"].items()}
    mp.update(mp_train=mp_train(torch, cfg_mod, Engine, synthetic_batch, here),
              mp_eval=mp_eval(torch, here, data))
    for phase, got in mp.items():
        for r, launches in enumerate(got["rank_launches"]):
            by_path[f"{phase}_rank{r}"] = launches
    k1_row["other_shapes"] = [trained["k1"], off["k1"]]
    # K2 at two scenes, [2, 50000] x 2,048, with the launches every path
    # made at that shape (the ddp_train, mp_train and mp_eval ranks)
    pts, msk, ns = trained["fps_two_scenes"]
    two = json.dumps([*pts.shape[:2], ns])
    k2_two = fps_row(torch, fps, fps_plain, trained["fps_two_scenes"],
                     sum(c.get("fps_by_shape", {}).get(two, 0) for c in by_path.values()))
    if k2_two["launches"] <= 0:
        fail(f"fps: no path launched K2 at {two}")
    fs_rows += trained["k2"] + [k2_two]
    k2_row["other_shapes"] = fs_rows
    # the floor of K2's design beside its operations bound: the chain of
    # dependent picks, timed with no distance to update
    k2_row["chain_floor"] = edges["fps_chain"]
    k3_row["other_shapes"] = [k3_large, k3_sweep]
    # the throughput entry points (cli.bench, tools.train_bench), each run as
    # a user runs it; then K1 and K2 at any shape the bench's full scale
    # gives them that no phase above held
    torch.cuda.empty_cache()
    t0 = time.time()
    benched = bench_eval(torch, here)
    for scale, got in benched.items():
        by_path[f"bench_{scale}"] = got
    held = {"knn_select": [k1_shape] + [r["shape"] for r in k1_row["other_shapes"]],
            "fps": [k2_row["shape"]] + [r["shape"] for r in k2_row["other_shapes"]]}
    for row in bench_full_kernels(torch, Engine, synthetic_batch, held, benched["full"]):
        {"knn_select": k1_row, "fps": k2_row}[row["name"]]["other_shapes"].append(row)
    by_path.update(train_bench(torch, here))
    emit({"phase": "throughput_tools_done", "seconds": time.time() - t0})
    rows = [k1_row, k2_row, k3_row]
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c.get(row["name"])}
    k2_row["launches_by_path_and_shape"] = {p: c["fps_by_shape"] for p, c in by_path.items()
                                            if c.get("fps_by_shape")}
    emit({"phase": "done", "seconds": time.time() - started})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
