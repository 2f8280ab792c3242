"""Fully-supervised training driver (counterpart of the JAX package's
train.py); cli/train_fs.py runs the episodic few-shot training through the
same loop.

    python3 -m geoformer_tpu_torch.cli.train --config CONFIG.yaml \\
        [--pretrain CKPT] [--resume CKPT] [--output_path exp] [--exp_name NAME] [--device cpu]

Two phases: up to ``prepare_epochs`` the semantic CE alone, then the full
Hungarian-matched set loss; the learning rate is set per epoch
(``Engine.learning_rate``). Each epoch ends with an ``epoch N done: {...}``
line of mean losses and writes ``checkpoint_last.ckpt`` (and
``checkpoint_epoch_N.ckpt`` every ``save_freq`` epochs) under
output_path/exp_name: the JAX package's msgpack training payload, which
either package resumes. A run resumes from ``--resume`` or from the
experiment's last checkpoint, at the epoch after it; ``--pretrain`` loads
weights by path suffix, skipping shape mismatches. Runs on the card unless
``--device`` names another device; without a card and without ``--device``
it raises.

Data parallelism, one process per GPU:

    torchrun --nproc_per_node=N -m geoformer_tpu_torch.cli.train --config CONFIG.yaml ...

``batch_size`` stays the global batch: each rank loads batch_size / N
scenes a step and the step's statistics, losses and gradient are the
global batch's (engine.py). Rank 0 alone logs and writes the checkpoints,
between two barriers; every rank resumes from the same file, and a
checkpoint of any world size loads in any other (it is the JAX package's
msgpack payload). ``--dist_backend gloo`` runs two ranks on one card
(NCCL refuses two ranks on one GPU). With more than one rank, rank r seeds
torch's generator (dropout) with ``manual_seed + r``; a single process
keeps torch's default seed, as before.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from geoformer_tpu_torch import default_device
from geoformer_tpu_torch.config import config_from_args
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.parallel.dist import (
    barrier,
    get_world_size,
    is_primary,
    local_seed,
    process_group,
)
from geoformer_tpu_torch.parallel.mesh import make_mesh
from geoformer_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    find_last_checkpoint,
    load_checkpoint,
    load_pretrain,
    restore_train_state,
    save_checkpoint,
    state_payload,
)
from geoformer_tpu_torch.utils.logger import create_logger
from geoformer_tpu_torch.utils.meters import AverageMeter, DictAverageMeter
from geoformer_tpu_torch.utils.prefetch import prefetch
from geoformer_tpu_torch.utils.tracking import ScalarWriter, device_memory_stats


def train_one_epoch(engine, dataset, epoch, logger, rng_seed, writer=None, records=None):
    """One epoch of training steps; appends one record per step to
    ``records`` (its phase, wall seconds, loss dict, and capacity
    counters)."""
    cfg = engine.cfg
    few_shot = engine.few_shot
    iter_meter, data_meter = AverageMeter(), AverageMeter()
    loss_meter = DictAverageMeter()
    # the same seed on every rank: the subsample draws are the global batch's
    generator = torch.Generator(device=engine.device).manual_seed(rng_seed + epoch)
    n_batches = max(len(dataset) // cfg.batch_size, 1)
    batches = prefetch(dataset.train_batches(cfg.batch_size, seed=rng_seed + epoch),
                       depth=max(int(cfg.num_workers), 0))
    lr = engine.learning_rate(epoch)
    end = time.time()
    for it, item in enumerate(batches):
        data_meter.update(time.time() - end)
        t0 = time.time()
        if few_shot:
            support, batch, _ = item
            loss, loss_dict, lr = engine.train_step(batch, epoch, generator, support=support,
                                                    sharded=True)
        else:
            loss, loss_dict, lr = engine.train_step(item, epoch, generator, sharded=True)
        loss = float(loss)  # waits for the step's device work
        losses = {k: float(v) for k, v in loss_dict.items()}
        loss_meter.update(losses)
        iter_meter.update(time.time() - end)
        if records is not None:
            records.append({
                "epoch": epoch, "iter": it,
                "phase": "prepare" if (not few_shot and epoch <= cfg.prepare_epochs) else "full",
                "seconds": time.time() - t0, "lr": lr, "losses": losses,
                "voxel_stats": {k: v.tolist() for k, v in engine.last_voxel_stats.items()}})
        end = time.time()
        if it % 10 == 0:
            mem = device_memory_stats(engine.device).get("peak_bytes_in_use", 0)
            logger.info(
                f"epoch {epoch}/{cfg.epochs} iter {it + 1}/{n_batches} "
                f"lr {lr:.6f} loss {loss:.4f} "
                f"data {data_meter.avg:.3f}s iter {iter_meter.avg:.3f}s "
                f"mem {mem / 2**30:.2f}GiB")
    avgs = loss_meter.averages()
    logger.info(f"epoch {epoch} done: " + str({k: round(v, 4) for k, v in avgs.items()}))
    if writer is not None:
        prefix = "train_fs/" if few_shot else "train/"
        writer.add_scalars(avgs, epoch, prefix=prefix)
        writer.add_scalar(f"{prefix}lr", lr, epoch)
    return avgs


def run(argv=None, few_shot: bool = False) -> dict:
    """The training loop of either driver. Returns the epochs' mean losses,
    one record per step, the last checkpoint's path and a digest of the
    trained model (``state_digest``)."""
    cfg = config_from_args(argv)
    with process_group(cfg.dist_backend, cfg.device):
        return _run(cfg, few_shot)


def _run(cfg, few_shot: bool) -> dict:
    device = default_device(cfg.device)
    mesh = make_mesh(device=device)
    primary = is_primary()
    exp_path = os.path.join(cfg.output_path, cfg.exp_name)
    logger = create_logger(exp_path if primary else None, primary=primary)
    writer = ScalarWriter(exp_path) if primary else None
    logger.info(f"config: {cfg.config}")
    np.random.seed(local_seed(cfg.manual_seed))
    if get_world_size() > 1:
        torch.manual_seed(local_seed(cfg.manual_seed))

    engine = Engine(cfg, device=device, seed=cfg.manual_seed, few_shot=few_shot, mesh=mesh)
    if few_shot:
        from geoformer_tpu_torch.data.episodic import FSInstDataset

        dataset = FSInstDataset(cfg, "train")
    else:
        from geoformer_tpu_torch.data.scannet import InstDataset

        dataset = InstDataset(cfg, "train")
    logger.info(f"training scenes: {len(dataset)} on {device}, rank {mesh.rank} of {mesh.world}")
    state = engine.init_state()

    start_epoch = cfg.start_epoch
    if cfg.pretrain:
        load_pretrain(engine.model, load_checkpoint(cfg.pretrain), logger)
        logger.info(f"loaded pretrain {cfg.pretrain}")
    resume = cfg.resume or find_last_checkpoint(exp_path)
    if resume and os.path.exists(resume):
        loaded = load_checkpoint(resume)
        restore_train_state(state, loaded)
        start_epoch = int(loaded.get("epoch", 0)) + 1
        logger.info(f"resumed {resume} at epoch {start_epoch}")

    epochs, records, last = {}, [], None
    for epoch in range(start_epoch, cfg.epochs + 1):
        epochs[epoch] = train_one_epoch(engine, dataset, epoch, logger, cfg.manual_seed, writer,
                                        records)
        barrier()
        last = checkpoint_path(exp_path)
        if primary:  # single checkpoint writer across processes
            payload = state_payload(state, epoch)
            if epoch % cfg.save_freq == 0:
                save_checkpoint(checkpoint_path(exp_path, epoch), payload)
            save_checkpoint(last, payload)
        barrier()  # no rank goes on before the file is whole
    if writer is not None:
        writer.close()
    return {"epochs": epochs, "steps": records, "checkpoint": last,
            "param_digest": state_digest(engine.model)}


def state_digest(model) -> str:
    """sha256 of the model's parameters and buffers, in their order: equal
    on every rank of a data-parallel run."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    return run(argv, few_shot=False)


if __name__ == "__main__":
    main()
