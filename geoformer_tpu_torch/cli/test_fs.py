"""Few-shot evaluation driver (counterpart of the JAX package's test_fs.py).

    python3 -m geoformer_tpu_torch.cli.test_fs --config CONFIG.yaml \\
        --pretrain CHECKPOINT.ckpt [--output_path exp] [--exp_name NAME] [--device cpu]

Protocol: for each of run_num support sets, precompute the mean support
embedding per class (k_shot instances); per query scene, encode once, then
per active class and run decode against the cached encoding -> per-run
matrix NMS + ScanNet AP -> mean and std over runs. Runs on the card unless
``--device`` names another device; without a card and without ``--device``
it raises.

Under torchrun (one process per GPU) each group of ``test_batch_size``
scenes is encoded and decoded G/N scenes a rank; the support embeddings are
computed on every rank alike (the same seed, the same order), and rank 0
gathers the host predictions in scene order and scores every run.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from geoformer_tpu_torch import default_device
from geoformer_tpu_torch.cli.test import (
    capacity_warning,
    group_split,
    pred_digest,
    stack_group,
    to_numpy,
)
from geoformer_tpu_torch.config import config_from_args
from geoformer_tpu_torch.data.episodic import FSInstDataset
from geoformer_tpu_torch.data.scannet import BENCHMARK_SEMANTIC_LABELS
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.evaluation.gt import make_gt_ids
from geoformer_tpu_torch.evaluation.predictions import nn_projection, scene_alignment
from geoformer_tpu_torch.evaluation.scannet_eval import (
    ScanNetEval,
    average_over_runs,
    print_results,
)
from geoformer_tpu_torch.parallel.dist import process_group
from geoformer_tpu_torch.parallel.mesh import gather_objects, make_mesh
from geoformer_tpu_torch.utils.logger import create_logger
from geoformer_tpu_torch.weights import load_jax_checkpoint


class StageClock:
    """Wall ms of the driver's device stages by name, each closed by a
    device synchronize so that the time is the stage's own."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = {}

    def run(self, name, fn, *args):
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        self.ms.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return out


def load_set_support(engine, dataset, logger, clock=None):
    """Mean support embedding per (run, class): a list over the first
    run_num support sets of {class: [2m] numpy}."""
    cfg = engine.cfg
    clock = clock or StageClock(engine.device)
    out = []
    for run_i, sset in enumerate(dataset.load_support_sets()[: cfg.run_num]):
        per_class = {}
        for cls, tuples in sset.items():
            embs = [clock.run("process_support", engine.process_support,
                              dataset.support_batch(scene_name, inst_id))[0].cpu().numpy()
                    for scene_name, inst_id in tuples[: cfg.k_shot]]
            per_class[cls] = np.mean(embs, axis=0)
        out.append(per_class)
        logger.info(f"support set {run_i}: {len(per_class)} classes")
    return out


def main(argv=None) -> dict:
    """Run the evaluation; returns the run-averaged AP, one record per scene,
    the per-stage wall ms and the number of scenes that ran over a capacity
    (AP and records on rank 0 only; stage times are each rank's own)."""
    cfg = config_from_args(argv)
    with process_group(cfg.dist_backend, cfg.device):
        return _main(cfg)


def _main(cfg) -> dict:
    device = default_device(cfg.device)
    mesh = make_mesh(device=device)
    primary = mesh.rank == 0
    ckpt_path = cfg.pretrain or cfg.resume
    if ckpt_path is None:
        raise ValueError("a checkpoint is required: --pretrain or --resume")
    exp_path = os.path.join(cfg.output_path, cfg.exp_name)
    logger = create_logger(exp_path if primary else None, primary=primary)
    engine = Engine(cfg, device=device, state_dict=load_jax_checkpoint(ckpt_path), few_shot=True,
                    mesh=mesh)
    dataset = FSInstDataset(cfg, cfg.split)
    clock = StageClock(device)

    if cfg.fix_support:
        # frozen 10-set support pickles
        support_embeddings = load_set_support(engine, dataset, logger, clock)
        combs = None
    else:
        # per-scene frozen supports from test_combinations; the same support
        # for every run
        support_embeddings = None
        combs = dataset.load_test_combinations()

    evaluators = [ScanNetEval(cfg.cvfold) for _ in range(cfg.run_num)]
    bench = np.asarray(BENCHMARK_SEMANTIC_LABELS)
    # `test_batch_size` scenes encode per forward (G/N on each rank); each
    # scene then decodes from its slice of the batched cache
    group_size = max(1, int(cfg.test_batch_size))
    per_rank = group_split(group_size, mesh.world)
    records = []

    def slice_scene(tree, j):
        return {k: (slice_scene(v, j) if isinstance(v, dict) else v[j:j + 1])
                for k, v in tree.items()}

    def process_scene(scene_name, active, host_batch, cache, t0):
        """-> the scene's predictions per run, its capacity warning and its
        record."""
        raw = np.load(dataset._scene_path(scene_name))
        raw_xyz = raw[:, :3]
        warning = capacity_warning(scene_name, to_numpy(cache["voxel_stats"]))
        # masks are scored at the raw scene's full N, never against a
        # truncated or subsampled gt
        n_points, n_raw, sel = scene_alignment(host_batch)
        nn = nn_projection(raw_xyz, sel) if n_raw != n_points else None

        per_run_preds = [[] for _ in range(cfg.run_num)]
        for cls in active:
            if support_embeddings is None:
                # one frozen support per scene, identical across runs:
                # decode once and share the result
                sup_scene, sup_inst = combs[scene_name][cls]
                embs = clock.run("process_support", engine.process_support,
                                 dataset.support_batch(sup_scene, int(sup_inst)))
            else:
                embs = torch.as_tensor(np.stack(
                    [support_embeddings[r][cls] for r in range(cfg.run_num)]))
            # the decode is independent per run: one call per support embedding
            props = [to_numpy({k: v[0] for k, v in clock.run(
                "decode_with_support", engine.decode_with_support, cache, emb[None]).items()
                if k in ("masks", "scores", "keep")}) for emb in embs]
            for run_i in range(cfg.run_num):
                p = props[run_i if len(props) > 1 else 0]
                for q in np.nonzero(p["keep"])[0]:
                    mask = p["masks"][q, :n_points]
                    if nn is not None:
                        mask = mask[nn]
                    per_run_preds[run_i].append({
                        "label_id": bench[cls], "conf": float(p["scores"][q]),
                        "mask": mask.astype(np.int32)})

        pred_infos = [{
            "label_id": np.asarray([p["label_id"] for p in preds], np.int64),
            "conf": np.asarray([p["conf"] for p in preds], np.float64),
            "mask": [p["mask"] for p in preds],
        } for preds in per_run_preds]
        record = {"scene": scene_name, "classes": len(active),
                  "fg_points": int(cache["fg_valid"].sum()),
                  "proposals_per_run": [len(p) for p in per_run_preds],
                  "seconds": time.time() - t0,
                  "pred_digest": [pred_digest(p) for p in pred_infos]}
        return pred_infos, warning, record

    def process_group(group):
        t0 = time.time()
        stacked = stack_group([hb for _, _, hb in group], group_size)
        cache = clock.run("encode_scene", engine.encode_scene, stacked)
        scenes = []
        for j in range(per_rank):
            g = mesh.rank * per_rank + j
            if g >= len(group):
                break
            scene_name, active, host_batch = group[g]
            scenes.append((scene_name,) + process_scene(scene_name, active, host_batch,
                                                         slice_scene(cache, j), t0))
        gathered = gather_objects(scenes, mesh)
        if not primary:
            return
        for scene_name, pred_infos, warning, record in (s for r in gathered for s in r):
            raw = np.load(dataset._scene_path(scene_name))
            gt_ids = make_gt_ids(raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32))
            for run_i, pred_info in enumerate(pred_infos):
                evaluators[run_i].assign_instances_for_scan(scene_name, pred_info, gt_ids)
            if warning:
                logger.warning(warning)
            logger.info(f"{scene_name}: {record['classes']} classes x {cfg.run_num} runs, "
                        f"{record['seconds']:.2f}s")
            records.append(dict(record, degraded=warning is not None))

    group = []
    for scene_name, active, host_batch in dataset.test_batches():
        group.append((scene_name, active, host_batch))
        if len(group) == group_size:
            process_group(group)
            group = []
    if group:
        process_group(group)

    if not primary:
        return {"avgs": None, "scenes": [], "stage_ms": clock.ms, "n_degraded": 0}
    avgs = average_over_runs([ev.compute_averages() for ev in evaluators])
    print_results(avgs, logger)
    return {"avgs": avgs, "scenes": records, "stage_ms": clock.ms,
            "n_degraded": sum(r["degraded"] for r in records)}


if __name__ == "__main__":
    main()
