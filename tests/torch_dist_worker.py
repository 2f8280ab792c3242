"""One rank of the port's data-parallel CPU tests.

    python tests/torch_dist_worker.py TASKS.pt OUT_DIR

``SpawnedRanks`` (below) starts it as the ranks of a world through
geoformer_tpu_torch.parallel.launch, with torchrun's environment. Each rank
runs on the CPU with one thread, forms a ``gloo`` process group, runs every
task of TASKS.pt (a dict name -> spec, saved with torch.save) in order and
saves its results as OUT_DIR/rank{r}.pt. Tasks:

* ``bn``: a MaskedBatchNorm in training mode on this rank's rows of a
  global input, under the data mesh: output, input gradient, parameter
  gradients (summed over the ranks) and running statistics;
* ``train``: ``Engine.train_step`` on the global batch with the injected
  subsample draws below and no dropout: loss, loss terms, the gradients the
  update applies (after the ranks' reduction), the model's state after it,
  this rank's geodesic table, the matches and the collectives' bytes;
* ``eval``: ``Engine.eval_batch`` on the global batch: its outputs;
* ``fs_eval``: the few-shot engine's ``process_support``, ``encode_scene``
  and ``decode_with_support`` on an episode: the decode's outputs;
* ``cli``: a driver's ``main`` on a command line (``cli.test``): its summary.

A task's ``model_parallel`` (1 by default) is the M of the ("data",
"model") mesh it runs under: ``make_mesh(model_parallel=M)``.

It imports torch and the port only: spawning a rank costs its interpreter
and torch, not a JAX import.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTATION = 7  # the injected rotation offset (mod the scene's valid count)


def draw_table(p: int, capacity: int) -> np.ndarray:
    return np.random.default_rng(capacity).random(p).astype(np.float32)


def port_pack(mask, capacity, generator):
    """The port's random_pack_by_mask with fixed draws: a rotation offset when
    the capacity covers the array, else one table of uniform scores for
    every scene (so a scene packs alike on any rank)."""
    import geoformer_tpu_torch.models.geoformer as gf

    b, p = mask.shape
    if capacity >= p:
        draws = ROTATION % mask.sum(dim=1).clamp(min=1)
    else:
        draws = torch.from_numpy(draw_table(p, capacity)).expand(b, p)
    return gf.pack_from_draws(mask, capacity, draws)


def no_dropout(model) -> None:
    from geoformer_tpu_torch.models.unet import BottleneckTransformer

    for mod in model.modules():
        if isinstance(mod, BottleneckTransformer):
            mod.dropout = 0.0


def bn_task(spec, mesh) -> dict:
    from geoformer_tpu_torch.models.blocks import MaskedBatchNorm
    from geoformer_tpu_torch.parallel.mesh import all_reduce_sum, set_mesh, shard_batch

    rows = shard_batch({k: spec[k] for k in ("x", "mask", "cot")}, mesh)
    bn = MaskedBatchNorm(spec["x"].shape[-1]).to(spec["x"].dtype)
    bn.load_state_dict(spec["state"])
    bn.train()
    x = rows["x"].clone().requires_grad_(True)
    with set_mesh(mesh):
        y = bn(x, rows["mask"])
        (y * rows["cot"]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "scale_grad": all_reduce_sum(bn.scale.grad, mesh),
            "bias_grad": all_reduce_sum(bn.bias.grad, mesh),
            "mean": bn.mean.clone(), "var": bn.var.clone()}


def read_step(engine, batch, epoch, support=None) -> dict:
    """One ``Engine.train_step`` with the injected draws and no dropout,
    read: loss, loss terms, the gradients the update applies (after the
    ranks' reduction), the model's state after the step, the geodesic
    table of this rank's queries, the matches and the bytes of each
    collective call site (``mesh.TRAFFIC``)."""
    import geoformer_tpu_torch.models.geoformer as gf
    from geoformer_tpu_torch.parallel.mesh import TRAFFIC

    real_pack, gf.random_pack_by_mask = gf.random_pack_by_mask, port_pack
    no_dropout(engine.model)
    state = engine.init_state()
    seen = {}
    step, geodesic, assign = (state.optimizer.step, engine.model.forward_geodesic,
                              engine.criterion._assign)

    def reading(*a, **kw):
        seen.update({k: p.grad.clone() for k, p in state.params.items()})
        return step(*a, **kw)

    def solving(*a, **kw):
        out = geodesic(*a, **kw)
        seen["geo"] = out[0].clone()
        return out

    def matching(*a, **kw):
        seen["matches"] = assign(*a, **kw)
        return seen["matches"]

    state.optimizer.step, engine.model.forward_geodesic = reading, solving
    engine.criterion._assign = matching
    TRAFFIC.reset()
    try:
        loss, ld, _ = engine.train_step(batch, epoch, torch.Generator(), support=support)
    finally:
        gf.random_pack_by_mask = real_pack
    return {"loss": float(loss), "loss_dict": {k: float(v) for k, v in ld.items()},
            "grads": {k: v for k, v in seen.items() if k not in ("geo", "matches")},
            "geo": seen.get("geo"), "matches": seen.get("matches"),
            "traffic": dict(TRAFFIC.largest),
            "state": {k: v.clone() for k, v in engine.model.state_dict().items()}}


def train_task(spec, mesh) -> dict:
    from geoformer_tpu_torch.config import load_config
    from geoformer_tpu_torch.engine import Engine

    cfg = load_config(None, **spec["cfg"])
    engine = Engine(cfg, device="cpu", state_dict=spec["sd"], few_shot=spec["few_shot"],
                    mesh=mesh)
    return read_step(engine, spec["batch"], spec["epoch"], spec.get("support"))


def eval_task(spec, mesh) -> dict:
    from geoformer_tpu_torch.config import load_config
    from geoformer_tpu_torch.engine import Engine

    engine = Engine(load_config(None, **spec["cfg"]), device="cpu", state_dict=spec["sd"],
                    mesh=mesh, few_shot=spec["task"] == "fs_eval")
    if spec["task"] == "eval":
        return engine.eval_batch(spec["batch"])
    emb = engine.process_support(spec["support"])
    return engine.decode_with_support(engine.encode_scene(spec["batch"]), emb)


def cli_task(spec, mesh) -> dict:
    import importlib

    return importlib.import_module(spec["module"]).main(spec["argv"])


TASKS = {"bn": bn_task, "train": train_task, "eval": eval_task, "fs_eval": eval_task,
         "cli": cli_task}


class SpawnedRanks:
    """``tasks`` running on ``world`` spawned ranks, started at once (the
    caller may work meanwhile); ``results`` waits -> each rank's results, by
    rank. A rank that fails or hangs fails ``results`` within ``timeout_s``
    of the start."""

    def __init__(self, tasks: dict, world: int, work_dir: str, timeout_s: float = 180.0):
        from geoformer_tpu_torch.parallel.launch import Ranks

        os.makedirs(work_dir, exist_ok=True)
        spec = os.path.join(work_dir, "tasks.pt")
        torch.save(tasks, spec)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.world, self.work_dir = world, work_dir
        self.ranks = Ranks([sys.executable, os.path.abspath(__file__), spec, work_dir], world,
                           timeout_s, log_dir=work_dir, env=env, cwd=REPO)

    def results(self) -> list:
        self.ranks.wait()
        return [torch.load(os.path.join(self.work_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def main(argv) -> None:
    torch.set_num_threads(1)
    from geoformer_tpu_torch.parallel.dist import process_group
    from geoformer_tpu_torch.parallel.mesh import make_mesh

    tasks = torch.load(argv[0], weights_only=False)
    with process_group("gloo", device="cpu"):
        out = {name: TASKS[spec["task"]](
            spec, make_mesh(model_parallel=spec.get("model_parallel", 1), device="cpu"))
            for name, spec in tasks.items()}
        torch.save(out, os.path.join(argv[1], f"rank{torch.distributed.get_rank()}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
