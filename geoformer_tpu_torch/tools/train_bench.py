"""Training-step throughput at a given scale, on one card or a mesh
(counterpart of the JAX package's tools/train_bench.py).

    python3 -m geoformer_tpu_torch.tools.train_bench [--batch_size 1] [--steps 5]
        [--prepare] [--fs] [--mesh N] [--remat 1] [--f32] [--accum K] [--device cpu]
        [--points 250000 --voxels 262144 --fg 131072 --subsample 30000 --depth 7
         --contexts 2048 --queries 128 --spatial 1024]

Times ``Engine.train_step`` (forward in training mode, criterion, matcher,
backward, optimizer update) on synthetic batches (``synthetic_batch``,
seeds 1..steps; built before each step's clock starts), each step closed by
the loss's ``float()``, which waits for the step's device work. The
defaults are the shipped production training scale per scene
(config/geoformer_scannet.yaml: 250,000-point scenes, a 30,000-point train
subsample, 2,048 contexts, 128 queries, bf16 levels and remat) at B = 1,
with seeded random weights. ``--prepare`` times the semantic-only phase,
``--fs`` the episodic few-shot step (GeoFormerFS and its criterion, with a
support scene whose mask is the 20 % of points nearest its centroid).
``--f32`` keeps the levels in float32 (``tpu_compute_dtype``), ``--remat 0``
keeps every activation (``tpu_remat``), ``--accum K`` averages K micro-steps
a update (``grad_accum_steps``).

It prints the JAX tool's text lines (the first step, each step, the p50
step and scenes/s), then in place of XLA's compiled memory analysis the
run's peak device memory (``torch.cuda.max_memory_allocated`` and
``max_memory_reserved``), and last one JSON line of the same numbers
(``metric`` "train_step", ``p50_step_s``, ``scenes_per_sec``, ``phase``,
``batch_size``, the peak bytes, ``device`` and ``power_limit_w``). The
kernels' launch counts over every step go to stderr as one JSON line.

``--mesh N`` runs N ranks (processes started as torchrun starts them,
``parallel/launch.py``) on a mesh of the JAX tool's layout: a model axis of
2 when N is even, else 1, and N / model data indices (the global batch is
split over them). Ranks that share a card use gloo, ranks with a card each
NCCL. Each rank prints its own step times and peak memory, relayed with a
``rank<r>:`` prefix, and rank 0's JSON line ends the output.

The JAX tool's ``--brick_occupancy`` and ``--brick_fold`` are not taken:
the port has no dense bricks (its rulebook sparse conv computes the exact
27-offset conv, ops/sparse_conv.py).

Runs on the card unless ``--device`` names another device; without a card
and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from geoformer_tpu_torch import default_device, kernels
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.parallel import dist
from geoformer_tpu_torch.parallel.mesh import make_mesh
from geoformer_tpu_torch.synthetic import synthetic_batch
from geoformer_tpu_torch.tools.profiling import card

RANK_TIMEOUT_S = 3600  # a mesh run whose ranks outlive this is stopped


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--points", type=int, default=250000)
    ap.add_argument("--voxels", type=int, default=262144)
    ap.add_argument("--fg", type=int, default=131072)
    ap.add_argument("--subsample", type=int, default=30000)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--contexts", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--spatial", type=int, default=1024)
    ap.add_argument("--prepare", action="store_true",
                    help="semantic-only phase (epoch <= prepare_epochs)")
    ap.add_argument("--fs", action="store_true",
                    help="episodic few-shot train step (GeoFormerFS + FSInstSetCriterion)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks of a (data[,model]) mesh (0 = one process, no mesh)")
    ap.add_argument("--remat", type=int, default=1,
                    help="recompute residual blocks in the backward (shipped prod default)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 level residency (shipped prod default is bf16)")
    ap.add_argument("--accum", type=int, default=1,
                    help="grad_accum_steps: micro-steps averaged per optimizer update")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (no silent CPU fallback)")
    return ap.parse_args(argv)


def build_config(args):
    """The JAX tool's config through the port's loader."""
    return load_config(
        None,
        batch_size=args.batch_size,
        n_decode_point=args.contexts,
        n_query_points=args.queries,
        n_downsampling=50000,
        tpu_max_points=args.points,
        tpu_max_voxels=args.voxels,
        tpu_max_fg_points=args.fg,
        tpu_train_subsample=args.subsample,
        tpu_max_instances=64,
        tpu_knn_neighbors=64,
        tpu_spatial_shape=args.spatial,
        tpu_unet_depth=args.depth,
        tpu_ball_nsample=64,
        tpu_remat=bool(args.remat),
        tpu_compute_dtype="float32" if args.f32 else "bfloat16",
        prepare_epochs=120 if args.prepare else 0,
        grad_accum_steps=args.accum,
    )


def make_support(cfg, batch_size: int, seed: int) -> dict:
    """An episodic support scene: the same synthetic generator plus a
    support mask over the 20 % of points nearest the scene's centroid (the
    reference's support is a masked crop of a scene holding the class)."""
    sup = dict(synthetic_batch(cfg, batch_size, seed=seed + 10_000))
    pts = sup["points"]
    r2 = ((pts - pts.mean(axis=1, keepdims=True)) ** 2).sum(-1)
    sup["support_masks"] = r2 <= np.quantile(r2, 0.2, axis=1, keepdims=True)
    return sup


def layout(n: int) -> tuple[int, int]:
    """(data, model) ranks of a mesh of n: the model axis is 2 when n is
    even, else 1."""
    mp = 2 if n % 2 == 0 and n > 1 else 1
    return n // mp, mp


def run(args, mesh=None) -> dict:
    """The timed steps in this process (one rank of ``mesh``, or alone)."""
    cfg = build_config(args)
    device = default_device(args.device) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank
    say = (lambda s: print(s, flush=True)) if mesh is None else (
        lambda s: print(f"rank{rank}: {s}", flush=True))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    torch.manual_seed(0 if mesh is None else mesh.data_rank)  # dropout: alike in a model group
    engine = Engine(cfg, device=device, few_shot=args.fs, mesh=mesh)
    phase = "fs-episodic" if args.fs else ("prepare" if args.prepare else "full")
    say(f"device={card(device)['device']} B={args.batch_size} points={args.points} "
        f"subsample={args.subsample} phase={phase}")
    epoch = 1 if args.prepare else cfg.prepare_epochs + 1
    generator = torch.Generator(device=device).manual_seed(0)

    def step(seed: int) -> tuple[float, float]:
        batch = synthetic_batch(cfg, args.batch_size, seed=seed)
        support = make_support(cfg, args.batch_size, seed) if args.fs else None
        t0 = time.perf_counter()
        loss, _, _ = engine.train_step(batch, epoch, generator, support=support)
        loss = float(loss)  # waits for the step's device work
        return time.perf_counter() - t0, loss

    kernels.reset_launches()
    first_s, loss = step(0)
    say(f"first step: {first_s:.1f}s loss={loss:.4f}")
    times = []
    for i in range(args.steps):
        dt, loss = step(i + 1)
        times.append(dt)
        say(f"step {i + 1}: {dt * 1000:.1f}ms loss={loss:.4f}")
    launches = kernels.launches()
    p50 = float(np.median(times))
    sps = args.batch_size / p50
    say(f"p50 step: {p50 * 1000:.1f}ms  scenes/s: {sps:.2f}")
    if args.accum > 1:
        say(f"accum={args.accum}: effective batch {args.batch_size * args.accum}, optimizer "
            f"update every {args.accum} micro-steps ({p50 * args.accum * 1000:.1f}ms p50 per "
            f"update)")
    peak = reserved = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.max_memory_reserved(device)
        say(f"peak device memory: allocated={peak / 1e9:.2f}GB reserved={reserved / 1e9:.2f}GB")
    print(json.dumps({"rank": rank, "launches": launches, "steps": args.steps + 1}),
          file=sys.stderr, flush=True)
    result = {
        "metric": "train_step",
        "p50_step_s": p50,
        "scenes_per_sec": sps,
        "first_step_s": first_s,
        "steps": args.steps,
        "phase": phase,
        "batch_size": args.batch_size,
        "accum": args.accum,
        "points": args.points,
        "mesh": None if mesh is None else f"data{mesh.data_world}xmodel{mesh.model_world}",
        "loss": loss,
        "max_memory_allocated_bytes": peak,
        "max_memory_reserved_bytes": reserved,
        **card(device),
    }
    if rank == 0:
        print(json.dumps(result), flush=True)
    return result


def run_rank(args) -> dict:
    """One rank of a ``--mesh`` run, under the process group of its
    environment."""
    world = int(os.environ["WORLD_SIZE"])
    if world != args.mesh:
        raise ValueError(f"--mesh {args.mesh} but a world of {world}")
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if on_cpu:  # ranks on one host's cores: a share each, not all of them each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    shared = on_cpu or world > torch.cuda.device_count()
    with dist.process_group("gloo" if shared else "nccl", device=args.device):
        return run(args, make_mesh(model_parallel=layout(world)[1], device=args.device))


def launch(args, argv) -> None:
    """Start ``--mesh`` ranks of this tool, wait for them, and relay their
    output: every line prefixed by its rank, rank 0's result line last."""
    from geoformer_tpu_torch.parallel.launch import Ranks

    data, mp = layout(args.mesh)
    print(f"mesh: data{data} x model{mp}", flush=True)
    repo = os.path.dirname(os.path.dirname(kernels.CSRC))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as logs:
        ranks = Ranks([sys.executable, "-m", "geoformer_tpu_torch.tools.train_bench", *argv],
                      args.mesh, RANK_TIMEOUT_S, log_dir=logs, env=env)
        ranks.wait()
        result = None
        for r, path in enumerate(ranks.logs):
            with open(path) as f:
                for line in f.read().splitlines():
                    if r == 0 and line.startswith('{"metric": "train_step"'):
                        result = line
                    else:
                        print(line if line.startswith(f"rank{r}:") else f"rank{r}: {line}",
                              flush=True)
    if result is None:
        raise RuntimeError("rank 0 printed no result line")
    print(result, flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh and "RANK" in os.environ:
        return run_rank(args)
    default_device(args.device)  # raises without a card, before any work
    if args.mesh:
        return launch(args, argv)
    return run(args)


if __name__ == "__main__":
    main()
