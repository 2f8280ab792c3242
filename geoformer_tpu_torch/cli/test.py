"""Fully-supervised evaluation driver (counterpart of the JAX package's
test.py).

    python3 -m geoformer_tpu_torch.cli.test --config CONFIG.yaml \\
        --pretrain CHECKPOINT.ckpt [--output_path exp] [--exp_name NAME] [--device cpu]

Per scene: eval forward + matrix NMS (``Engine.eval_batch``) -> class id ->
benchmark label -> masks projected to raw resolution -> ScanNet AP against
ground truth derived from the scene labels. Runs on the card unless
``--device`` names another device; without a card and without ``--device``
it raises. The checkpoint is a msgpack file of the JAX package
(``weights.load_jax_checkpoint``), written by a run of any world size.

Data parallelism, one process per GPU (``torchrun --nproc_per_node=N -m
geoformer_tpu_torch.cli.test ...``; ``--dist_backend gloo`` for two ranks
on one card): each group of ``test_batch_size`` scenes (a multiple of N)
is split over the ranks, each rank runs the forward and builds the host
predictions of its own scenes, and rank 0 gathers them (in scene order),
scores AP, logs and writes the ``save_instance`` and ``save_semantic``
output. Every rank reads every scene, so the padding draws are those of a
single process.

``save_semantic: True`` in the config writes each scene's
semantic and instance PLY files and its boxes OBJ into the experiment's
``result/`` (utils/visualize.py, as test.py does); ``--profile_dir DIR``
writes a torch.profiler Chrome trace of the eval loop to
``DIR/trace_rank<r>.json``.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from geoformer_tpu_torch import default_device
from geoformer_tpu_torch.config import config_from_args
from geoformer_tpu_torch.data.scannet import BENCHMARK_SEMANTIC_LABELS, FOLD, InstDataset
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.evaluation.gt import make_gt_ids
from geoformer_tpu_torch.evaluation.predictions import labels_to_raw, masks_to_raw
from geoformer_tpu_torch.evaluation.scannet_eval import ScanNetEval, print_results
from geoformer_tpu_torch.parallel.dist import process_group
from geoformer_tpu_torch.parallel.mesh import gather_objects, make_mesh, shard_batch
from geoformer_tpu_torch.utils.logger import create_logger
from geoformer_tpu_torch.utils.tracking import profile_trace
from geoformer_tpu_torch.utils.visualize import export_scene_predictions
from geoformer_tpu_torch.weights import load_jax_checkpoint

CAPACITY_COUNTERS = ("n_overflow_points", "n_oor_points", "saturated",
                     "n_radius_cell_overflow", "n_radius_window_overflow")


def proposals_to_pred_info(cfg, proposals, keep_nms, batch, raw_xyz, idx=0):
    """Host pred_info of scene ``idx`` of a batched eval: the proposals the
    matrix NMS kept (``keep_nms`` [B,Q], from ``Engine.eval_batch``), their
    masks projected to raw resolution, their UNDECAYED scores (as test.py
    takes them) and their benchmark label ids. All inputs numpy."""
    keep_np = np.asarray(keep_nms[idx])
    fold = np.asarray(FOLD[cfg.cvfold])
    bench = np.asarray(BENCHMARK_SEMANTIC_LABELS)
    masks_np = masks_to_raw(np.asarray(proposals["masks"][idx])[keep_np], batch, raw_xyz,
                            scene_index=idx)
    cls_np = np.asarray(proposals["classes"][idx])[keep_np]
    return {
        "label_id": bench[fold[np.clip(cls_np - 4, 0, len(fold) - 1)]],
        "conf": np.asarray(proposals["scores"][idx])[keep_np],
        "mask": masks_np.astype(np.int32),
    }


def save_benchmark_predictions(out_dir, scene_name, pred_info):
    """ScanNet benchmark submission format: <scene>.txt listing
    `predicted_masks/<scene>_NNN.txt label_id conf` + one 0/1 mask file per
    proposal."""
    mask_dir = os.path.join(out_dir, "predicted_masks")
    os.makedirs(mask_dir, exist_ok=True)
    lines = []
    for i in range(len(pred_info["conf"])):
        rel = f"predicted_masks/{scene_name}_{i:03d}.txt"
        np.savetxt(os.path.join(out_dir, rel), pred_info["mask"][i].astype(np.int32), fmt="%d")
        lines.append(f"{rel} {int(pred_info['label_id'][i])} {pred_info['conf'][i]:.4f}")
    with open(os.path.join(out_dir, f"{scene_name}.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def capacity_warning(scene_name, vs, j=0):
    """A warning text when scene ``j`` of ``vs`` (numpy voxel_stats) ran
    over a static capacity, else None."""
    if not any(int(vs[k][j]) for k in CAPACITY_COUNTERS):
        return None
    return (
        f"{scene_name}: voxel capacity degraded — "
        f"{int(vs['n_overflow_points'][j])} points over voxel capacity, "
        f"{int(vs['n_oor_points'][j])} outside the spatial grid, "
        f"saturated={bool(vs['saturated'][j])} "
        f"({int(vs['n_voxels'][j])}/{int(vs['capacity'][j])} voxels), "
        f"{int(vs['n_radius_cell_overflow'][j])} fg points dropped from "
        f"the geodesic graph (radius-cell capacity), "
        f"{int(vs['n_radius_window_overflow'][j])} with an overflowed "
        f"kNN candidate window (non-nearest edges); "
        f"raise TPU.tpu_max_voxels / tpu_spatial_shape / "
        f"tpu_knn_window / lower tpu_radius_cell_div")


def stack_group(batches, group_size):
    """``group_size`` padded batches of one scene each -> one [G, P, ...]
    batch; a short last group repeats its last scene (those lanes are
    never post-processed)."""
    if group_size == 1:
        return batches[0]
    batches = batches + [batches[-1]] * (group_size - len(batches))
    return {k: np.concatenate([np.asarray(b[k]) for b in batches], axis=0) for k in batches[0]}


def to_numpy(tree):
    return {k: v.cpu().numpy() for k, v in tree.items()}


def label_digest(labels: np.ndarray) -> str:
    """sha256 of per-point labels as int64."""
    return hashlib.sha256(np.ascontiguousarray(labels, dtype=np.int64).tobytes()).hexdigest()


def pred_digest(pred_info: dict) -> str:
    """sha256 of a scene's host predictions (label ids, confidences, masks),
    to tell exactly equal predictions apart from others cheaply."""
    h = hashlib.sha256()
    for k in ("label_id", "conf", "mask"):
        v = pred_info[k]
        for a in (v if isinstance(v, list) else [v]):
            a = np.ascontiguousarray(a)
            h.update(f"{k}{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def group_split(group_size: int, world: int) -> int:
    """Scenes a rank runs of each group; raises unless the ranks share the
    group evenly."""
    if group_size % world:
        raise ValueError(f"test_batch_size {group_size} cannot be split over {world} ranks")
    return group_size // world


def main(argv=None) -> dict:
    """Run the evaluation; returns the AP averages, one record per scene and
    the number of scenes that ran over a capacity (on rank 0; the other
    ranks return no AP and no records)."""
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
    engine = Engine(cfg, device=device, state_dict=load_jax_checkpoint(ckpt_path), mesh=mesh)
    dataset = InstDataset(cfg, cfg.split)
    logger.info(f"eval scenes: {len(dataset)} on {device}, {mesh.world} rank(s)")
    save_dir = (os.path.join(exp_path, "result")
                if (cfg.save_instance or cfg.save_semantic) else None)
    evaluator = ScanNetEval(cfg.cvfold)

    # Scenes are evaluated `test_batch_size` per forward over a [G, P, ...]
    # batch, G/N of them on each rank; the final partial group is padded by
    # repeating the last scene (padded lanes are never post-processed).
    group_size = max(1, int(cfg.test_batch_size))
    per_rank = group_split(group_size, mesh.world)
    n_scenes = len(dataset)
    records = []

    def process_group(group):
        t0 = time.time()
        stacked = stack_group([b for _, _, b in group], group_size)
        out = engine.eval_batch(stacked)
        mine = shard_batch(stacked, mesh)
        proposals = to_numpy(out["proposals"])
        keep_nms = out["nms"]["keep"].cpu().numpy()
        vs = to_numpy(out["voxel_stats"])
        fg_points = out["fg_valid"].sum(dim=1).tolist()
        sem_all = out["semantic_scores"].float().cpu().numpy() if cfg.save_semantic else None
        dt = (time.time() - t0) / len(group)
        scenes = []
        for j in range(per_rank):
            g = mesh.rank * per_rank + j
            if g >= len(group):
                break
            i, scene_name, batch = group[g]
            raw = np.load(dataset.file_names[i])
            pred_info = proposals_to_pred_info(cfg, proposals, keep_nms, mine, raw[:, :3],
                                               idx=j)
            n_points = int(batch["n_points"][0])  # device-resolution count
            record = {"scene": scene_name, "n_points": n_points, "fg_points": fg_points[j],
                      "proposals": len(pred_info["conf"]), "seconds": dt,
                      "pred_digest": pred_digest(pred_info)}
            sem = None
            if sem_all is not None:  # per raw point, the argmax of the scores
                sem = labels_to_raw(sem_all[j], mine, raw[:, :3], scene_index=j).argmax(-1)
                record["semantic_digest"] = label_digest(sem)
            scenes.append((i, scene_name, pred_info, sem, capacity_warning(scene_name, vs, j),
                           record))
        gathered = gather_objects(scenes, mesh)
        if not primary:
            return
        for i, scene_name, pred_info, sem, warning, record in (s for r in gathered for s in r):
            raw = np.load(dataset.file_names[i])
            # gt at full raw resolution, never truncated: the masks above are
            # projected to the same raw N
            gt_ids = make_gt_ids(raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32))
            evaluator.assign_instances_for_scan(scene_name, pred_info, gt_ids)
            if warning:
                logger.warning(warning)
            if cfg.save_instance:
                save_benchmark_predictions(save_dir, scene_name, pred_info)
            if sem is not None:
                export_scene_predictions(save_dir, scene_name, raw[:, :3], sem,
                                         pred_info["mask"].astype(bool))
            logger.info(f"[{i + 1}/{n_scenes}] {scene_name}: {record['n_points']} pts, "
                        f"{record['proposals']} proposals, {record['seconds']:.2f}s")
            records.append(dict(record, degraded=warning is not None))

    with profile_trace(cfg.profile_dir, name=f"trace_rank{mesh.rank}"):
        group = []
        for i, (scene_name, batch) in enumerate(dataset.test_batches()):
            group.append((i, scene_name, batch))
            if len(group) == group_size:
                process_group(group)
                group = []
        if group:
            process_group(group)

    if not primary:
        return {"avgs": None, "scenes": [], "n_degraded": 0}
    avgs = evaluator.compute_averages()
    print_results(avgs, logger)
    return {"avgs": avgs, "scenes": records,
            "n_degraded": sum(r["degraded"] for r in records)}


if __name__ == "__main__":
    main()
