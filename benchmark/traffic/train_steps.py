"""Training steps back to back: ``Engine.train_step`` at the configuration's
batch on batches made from the seed, built once and resident on the
device, cycled in a fixed order; each step is closed by a host read of its
loss and the capacity counters (the loss's ``float()``).

Mix parameters: ``phase`` ("prepare": the semantic loss alone at epoch 1,
the phase the plain reference covers), ``batches`` (distinct batches), ``checked_steps`` (the first steps, which
set-up drives through the window's own call on distinct batches and the
check follows), ``profile_steps``, ``limits``.

The check replays the checked steps with the plain reference from the same
weights, batches and dropout seed, and compares the first step's loss, the
first step's gradient (the program's as its optimizer holds it: Adam's
first moment after one step over 1 - beta1) by the median leaf's gap of
norms, and the parameters' change after the checked steps by the worst
leaf's; the later steps' losses and the first gradient's worst leaf are
reported beside them (``notes``), not compared (PERF.md gives the readings)"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark import common, scenes, trace, work
from benchmark.reference import training

SECTION = "train"


def setup(run) -> None:
    mix, cfg = run.mix, run.config[SECTION]
    if cfg["fix_module"] or cfg["grad_accum_steps"] != 1 or mix["phase"] != "prepare":
        raise ValueError("the training kind checks the prepare phase of an unfrozen model, "
                         "one update a step")
    run.engine, run.weights = common.engine(run, SECTION)
    g = common.rng(run, 1)
    b = cfg["batch_size"]
    # each batch: the same B rooms, in its own order, sampled anew
    run.batches = [common.to_device(scenes.stack(scenes.scans(cfg, g, b)), run.device)
                   for _ in range(mix["batches"])]
    run.epoch = 1
    seeds = common.rng(run, 3).integers(0, 2 ** 62, size=2)
    run.gen_seed, run.dropout_seed = int(seeds[0]), int(seeds[1])
    run.generator = torch.Generator(device=run.device).manual_seed(run.gen_seed)
    torch.manual_seed(run.dropout_seed)
    run.losses, run.steps = [], 0
    for i in range(mix["checked_steps"]):
        run.losses.append(float(_step(run)[0]))
        if i == 0:
            opt = run.engine.state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            # no first moment: no gradient reached the optimizer
            run.grads1 = {k: opt.state[p]["exp_avg"].detach() / (1 - beta1)
                          if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                          for k, p in run.engine.state.params.items()}
    run.params_after = {k: p.detach().clone() for k, p in run.engine.state.params.items()}


def _step(run):
    batch = run.batches[run.steps % len(run.batches)]
    run.steps += 1
    loss, _, _ = run.engine.train_step(batch, run.epoch, run.generator)
    read = torch.cat([loss.detach().double().view(1),
                      common.hard_counts(run.engine.last_voxel_stats).double()]).cpu()
    return read


def window(run, seconds: float) -> None:
    b = run.config[SECTION]["batch_size"]
    common.sync(run.device)
    start = time.perf_counter()
    deadline, end, n = start + seconds, start, 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        run.attempted += 1
        try:
            read = _step(run)
        except Exception as e:  # a step that raises has failed; the loop goes on
            run.fail(n, repr(e))
            n += 1
            continue
        end = time.perf_counter()
        run.latencies_s.append(end - t0)
        run.scenes += b
        if not bool(torch.isfinite(read[0])) or bool((read[1:] > 0).any()):
            run.fail(n, f"loss {read[0].item()}, capacity counters {read[1:].tolist()}")
        n += 1
    run.window_s = end - start


def traced(run) -> None:
    n = run.mix["profile_steps"]

    def steps():
        for _ in range(n):
            _step(run)

    run.profile = trace.capture(steps, lambda: _step(run), run.device)
    run.profile_scenes = n * run.config[SECTION]["batch_size"]


def release(run) -> None:
    cfg = run.config[SECTION]
    if run.trace and run.latencies_s:
        per_batch = [work.train_step_work(cfg, list(bt["coords"])) for bt in run.batches]
        first = len(run.losses)
        run.work = work.add(*(per_batch[(first + i) % len(per_batch)]
                              for i in range(len(run.latencies_s))))
    del run.engine
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _median(norms) -> float:
    """The median of the norms above 0: the leaves the phase's loss reaches
    (the prepare phase leaves every leaf past the semantic head at 0)."""
    live = [n for n in norms if n > 0]
    return statistics.median(live) if live else 0.0


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap of norms: |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's (leaves in ``keep``, all by default)."""
    names = [k for k in want if keep is None or k in keep]
    wn = {k: float(want[k].double().norm()) for k in names}
    med = _median(wn.values())
    return {k: abs(float(got[k].double().norm()) - wn[k]) / max(wn[k], med, 1e-30)
            for k in names}


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The widest of ``leaf_gaps``."""
    return max(leaf_gaps(got, want, keep).values())


def compare(run, losses, grads1, params_after) -> dict:
    g_norm = {k: float(g.double().norm()) for k, g in grads1.items()}
    med = _median(g_norm.values())
    # leaves whose gradient is nought to rounding move under Adam by
    # round-off alone: left out of the change
    moving = {k for k, n in g_norm.items() if n >= 1e-3 * med}
    p0 = {k: run.weights[k] for k in params_after}
    change = lambda p: {k: p[k].double() - p0[k].double() for k in p}  # noqa: E731
    grad = leaf_gaps(run.grads1, grads1)
    update = leaf_gaps(change(run.params_after), change(params_after), moving)
    worst = lambda d: sorted(d, key=d.get)[-3:]  # noqa: E731
    run.notes = {"losses": run.losses, "reference_losses": losses,
                 "widest_first_grad": {k: grad[k] for k in worst(grad)},
                 "widest_update": {k: update[k] for k in worst(update)},
                 "left_out_of_update": sorted(k for k in set(grads1) - moving if g_norm[k] > 0),
                 "unreached": sum(1 for n in g_norm.values() if n == 0)}
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(run.losses, losses)]
    # the worst leaf's first gradient is a batch-norm scale's cancelling sum,
    # which two summation orders of one computation move by 0.08-0.13
    # (PERF.md section 2): the median leaf's gap is compared
    reached = [grad[k] for k, n in g_norm.items() if n > 0]
    return {"loss": max(loss), "first_loss": loss[0], "first_grad": max(grad.values()),
            "first_grad_median": statistics.median(reached) if reached else 0.0,
            "update": max(update.values())}


def check(run) -> None:
    """Replay the checked steps with the plain reference (float32, TF32 off,
    the configuration's bf16 operands)."""
    ns = run.namespace(SECTION)
    narrow = torch.bfloat16 if ns.tpu_compute_dtype == "bfloat16" else None
    with training.precision(tf32=False):
        fed = [run.batches[i % len(run.batches)] for i in range(len(run.losses))]
        got = training.train_steps(ns, run.weights, fed, run.epoch, run.dropout_seed, narrow)
    gaps = compare(run, *got)
    run.notes["gaps"] = gaps
    run.compared = [(k, gaps[k], lim) for k, lim in run.mix["limits"].items()]
