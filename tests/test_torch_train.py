"""One supervised training step of the port vs the JAX package on the CPU.

tests/conftest.py:tiny_cfg with two U-Net levels and the rulebook sparse
conv (tpu_brick_occupancy=0), remat on in the port (a rematerialized block
computes what the plain one does, so the JAX program runs without it and
the BN statistics must still match: the recompute leaves them alone); the
same weights (seeded in the port,
carried over by weights.to_jax_variables), the same batch and the same
subsample draws: both packages' ``random_pack_by_mask`` are replaced, in
their model modules and for this module's fixtures only, by one that packs
from fixed draws (a rotation offset when the capacity covers the array, a
fixed table of uniform scores otherwise, so both of its paths run). Dropout
is 0: ``dec_dropout`` is 0, and the U-Net bottleneck transformer's fixed
0.1 is set to 0 on both sides (a subclass in the JAX module, the attribute in
the port).

The JAX reference is one program per config, compiled by ``jax.jit`` at
XLA's default optimisation level: the gradients of the full-phase loss and,
pulled back through
the same forward, of the semantic CE alone, which is the prepare phase's
loss (``semantic_only`` stops the forward after the semantic head, and
nothing after it reaches the CE), plus the BN statistics after the forward.
The port runs ``Engine.train_step``; its gradients are read as the step
applies them. The frozen-module config (the backbone frozen) runs its own
prepare-phase program, in tests/test_torch_train_fs.py with the other
frozen-module step. (Compiled with ``xla_backend_optimization_level=0``,
as the eval-forward tests compile theirs, the same program's gradient of the
set aggregator and of everything upstream of it differs from the default
build's, which the port and the un-jitted program agree with; see
CHANGES.md.)

Tolerances: the loss and every gradient leaf within 1e-4 x max(1, |ref|inf)
(f32 sums reassociated through the U-Net, the decoder and the mask head's
backward); BN running statistics within 1e-5; the number of matched
instances exactly equal.

The same steps on two ``gloo`` ranks, one scene a rank (the module spawns
its ranks once, tests/torch_dist_worker.py, with the same injected draws):
the global batch's loss, gradient and statistics are held against the same
JAX outputs at the same tolerances, and a step whose second rank holds no
gt instance against the one-process step on that batch; the ranks' models
must be bit-equal after the step.

The full-phase step on a ("data", "model") mesh (the JAX ``model`` axis:
each scene's 8 queries split over M = 2 model ranks) at 1x2 (two ranks,
one model group) and 2x2 (four ranks, one scene a model group), against
the same JAX outputs at the same tolerances; each rank's geodesic table
bit-equal to its columns of the one-process port's table (which
tests/test_torch_slice.py holds against JAX), the matches equal, the ranks
bit-equal, and no collective of the step moving an activation as large as
one scene's [F, Q] table (the gradient's all-reduce aside).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import geoformer_tpu.models.geoformer as jgf
import geoformer_tpu.models.geoformer_fs as jgf_fs
import geoformer_tpu.models.unet as junet
from geoformer_tpu.losses import InstSetCriterion as JaxInstSetCriterion
from geoformer_tpu.models.geoformer import GeoFormer as JaxGeoFormer
from geoformer_tpu.models.geoformer import ModelConfig as JaxModelConfig
import geoformer_tpu_torch.models.geoformer as gf
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.synthetic import room_points
from geoformer_tpu_torch.weights import from_jax_variables, random_state_dict, to_jax_variables
from torch_dist_worker import (
    ROTATION,
    SpawnedRanks,
    draw_table,
    no_dropout,
    port_pack,
    read_step,
)

TOL = 1e-4
STATS_TOL = 1e-5
WORLD = 2


def port_config(cfg, **kw):
    """A JAX-package config as the port's config (same keys and values)."""
    return load_config(None, **{k: v for k, v in vars(cfg.replace(**kw)).items() if k != "config"})


def jax_pack(mask, capacity, rng):
    """JAX random_pack_by_mask (one scene) with the injected draws."""
    p = mask.shape[0]
    if capacity >= p:
        n = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)
        pos = jnp.arange(p, dtype=jnp.int32)
        idx = jnp.where(pos < n, (pos + ROTATION % n) % n, pos)
        return idx, mask[idx]
    scores = jnp.where(mask, jnp.asarray(draw_table(p, capacity)), 2.0)
    idx = jnp.argsort(scores)[:capacity].astype(jnp.int32)
    return idx, mask[idx]


class _NoDropTransformer(junet.BottleneckTransformer):
    dropout: float = 0.0


def injected(monkeypatch):
    """Both packages' subsample draws injected and the JAX bottleneck
    transformer's dropout off, for the JAX trace and the port's run."""
    monkeypatch.setattr(jgf, "random_pack_by_mask", jax_pack)
    monkeypatch.setattr(jgf_fs, "random_pack_by_mask", jax_pack)
    monkeypatch.setattr(junet, "BottleneckTransformer", _NoDropTransformer)
    monkeypatch.setattr(gf, "random_pack_by_mask", port_pack)


def jit_default(f, *args):
    """f(*args) as one XLA program at the default optimisation level."""
    return jax.jit(f)(*args)


def train_batch(cfg, seed=0):
    """Two room scans shrunk to ~0.5 m (tests/test_torch_slice.py's batch)
    with semantic labels (some ignored) and instance ids (some -100)."""
    rng = np.random.default_rng(seed)
    p, b = cfg.tpu_max_points, cfg.batch_size
    pts = np.stack([room_points(rng, p) * 0.35 + 0.1 for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, -40:] = False
    labels = rng.integers(0, cfg.classes, (b, p)).astype(np.int32)
    labels[rng.random((b, p)) < 0.1] = -100
    inst = rng.integers(-1, 6, (b, p)).astype(np.int32)
    inst[inst < 0] = -100
    return {
        "points": pts,
        "feats": rng.normal(size=(b, p, 3)).astype(np.float32),
        "coords": np.floor(pts * cfg.scale).astype(np.int32),
        "point_mask": mask,
        "labels": labels,
        "instance_labels": inst,
        "pc_mins": pts.min(1),
        "pc_maxs": pts.max(1),
    }


def perturbed_weights(model, seed=1):
    """Seeded weights with non-trivial BN statistics and norm parameters,
    the background classes 0-3 biased down so that a foreground exists, and
    a controller wide enough that the dynamic masks are not empty."""
    rng = np.random.default_rng(seed)
    sd = random_state_dict(model, seed)
    for key, t in sd.items():
        name = key.rsplit(".", 1)[-1]
        if key == "controller_head.controller.weight":
            sd[key] = t * 100.0
        elif name in ("mean", "bias"):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, t.shape).astype(np.float32))
        elif name in ("var", "scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
    sd["semantic.Dense_2.bias"][:4] -= 0.5
    return sd


def port_step(engine, batch, epoch, support=None):
    """Engine.train_step, with the gradients it applies read off (None -> 0):
    -> (loss, loss_dict, grads by parameter name)."""
    state = engine.init_state()
    seen = {}
    apply = state.apply_gradients

    def reading(lr):
        seen.update({k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                     for k, p in state.params.items()})
        apply(lr)

    state.apply_gradients = reading
    no_dropout(engine.model)
    loss, ld, _ = engine.train_step(batch, epoch, torch.Generator(), support=support)
    return float(loss), {k: float(v) for k, v in ld.items()}, seen


def assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def assert_grads(grads, jax_grads, frozen=()):
    """Every JAX gradient leaf against the port's: a trainable one within
    TOL, a frozen one (no port gradient) must be 0 in JAX too."""
    want = from_jax_variables({"params": jax_grads})
    assert set(grads) | set(frozen) == set(want)
    for k, w in want.items():
        if k in grads:
            assert_close(grads[k].numpy(), w.numpy(), TOL, k)
        else:
            assert not np.any(w.numpy()), f"{k} is frozen, but its JAX gradient is not 0"


def assert_stats(model, jax_stats, only=None):
    """The BN running statistics of ``model`` (or of a state_dict)."""
    want = from_jax_variables({"batch_stats": jax_stats})
    got = model if isinstance(model, dict) else model.state_dict()
    for k, w in want.items():
        if only is None or k.split(".")[0] in only:
            assert_close(got[k].numpy(), w.numpy(), STATS_TOL, k)


@pytest.fixture(scope="module")
def supervised_inputs(tiny_cfg):
    """Config, batch and seeded weights (as a state_dict and as the JAX
    variable tree) of the supervised steps."""
    cfg = tiny_cfg.replace(tpu_unet_depth=2, tpu_brick_occupancy=0, dec_dropout=0.0,
                           prepare_epochs=1)
    pcfg = port_config(cfg, tpu_remat=True)
    model = gf.GeoFormer(gf.ModelConfig.from_cfg(pcfg))
    sd = perturbed_weights(model)
    model.load_state_dict(sd)
    return dict(cfg=cfg, pcfg=pcfg, nb=train_batch(cfg), sd=sd,
                variables=to_jax_variables(model))


@pytest.fixture(scope="module")
def two_ranks_started(supervised_inputs, tmp_path_factory):
    """The supervised steps on two ranks (one scene a rank), started before
    the JAX reference compiles: the full and the prepare phase on the test
    batch, and the full phase on it with the second scene's instances
    removed."""
    nb, pcfg, sd = (supervised_inputs[k] for k in ("nb", "pcfg", "sd"))
    no_gt = dict(nb, instance_labels=nb["instance_labels"].copy())
    no_gt["instance_labels"][1] = -100
    tasks = {"full": train_task(pcfg, sd, nb, 2), "prepare": train_task(pcfg, sd, nb, 1),
             "no_gt": train_task(pcfg, sd, no_gt, 2),
             "mp_1x2": train_task(pcfg, sd, nb, 2, model_parallel=2)}
    spawned = SpawnedRanks(tasks, WORLD, str(tmp_path_factory.mktemp("train_ranks")))
    mp_tasks = {"mp_2x2": train_task(pcfg, sd, nb, 2, model_parallel=2)}
    try:
        spawned4 = SpawnedRanks(mp_tasks, 4, str(tmp_path_factory.mktemp("train_ranks4")))
    except BaseException:
        spawned.ranks.stop()
        raise
    try:
        yield dict(spawned=spawned, tasks=tasks, spawned4=spawned4, mp_tasks=mp_tasks)
    finally:
        spawned.ranks.stop()
        spawned4.ranks.stop()


@pytest.fixture(scope="module")
def two_ranks(two_ranks_started):
    out = two_ranks_started["spawned"].results()
    out4 = two_ranks_started["spawned4"].results()
    tasks = two_ranks_started["tasks"]
    return dict({k: [r[k] for r in out] for k in tasks},
                **{k: [r[k] for r in out4] for k in two_ranks_started["mp_tasks"]},
                no_gt_batch=tasks["no_gt"]["batch"])


@pytest.fixture(scope="module")
def supervised(supervised_inputs, two_ranks_started):
    cfg, variables, nb = (supervised_inputs[k] for k in ("cfg", "variables", "nb"))
    jm = JaxGeoFormer(JaxModelConfig.from_cfg(cfg))
    crit = JaxInstSetCriterion(cfg)
    rngs = {"sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

    def step(params, stats, consts, batch):
        def f(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats, "constants": consts}, batch,
                                train=True, rngs=rngs, mutable=["batch_stats"])
            loss, ld = crit(out, batch, cfg.prepare_epochs + 1)
            return (loss, ld["sem_loss"]), (ld, mut["batch_stats"])

        (loss, _), pull, (ld, new_stats) = jax.vjp(f, params, has_aux=True)
        one, zero = jnp.float32(1.0), jnp.float32(0.0)
        return loss, ld, new_stats, pull((one, zero))[0], pull((zero, one))[0]

    with pytest.MonkeyPatch.context() as mp:
        injected(mp)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        ref = jax.tree_util.tree_map(np.asarray, jit_default(
            step, variables["params"], variables["batch_stats"], variables["constants"], jb))
    return dict(supervised_inputs, ref=ref)


@pytest.fixture
def port_packs(monkeypatch):
    monkeypatch.setattr(gf, "random_pack_by_mask", port_pack)


def test_full_phase_step(supervised, port_packs):
    """Full phase (epoch > prepare_epochs): loss, loss dict, every gradient
    and the BN statistics after the step (remat on in the port: the
    recomputed blocks leave the statistics as the forward set them)."""
    loss, grads_full, grads_sem = supervised["ref"][0], supervised["ref"][3], supervised["ref"][4]
    ld, stats = supervised["ref"][1], supervised["ref"][2]
    engine = Engine(supervised["pcfg"], device="cpu", state_dict=supervised["sd"])
    got_loss, got_ld, grads = port_step(engine, supervised["nb"], epoch=2)
    assert_close(got_loss, loss, TOL, "loss")
    assert set(got_ld) == set(ld) and got_ld["num_gt"] == float(ld["num_gt"]) > 0
    for k in ld:
        assert_close(got_ld[k], ld[k], TOL, k)
    assert_grads(grads, grads_full)
    assert_stats(engine.model, stats)


def test_prepare_phase_step(supervised, port_packs):
    """Prepare phase (epoch <= prepare_epochs): the semantic CE alone; its
    gradient reaches the backbone and the semantic head only, and only their
    BN statistics move."""
    ld, stats, grads_sem = supervised["ref"][1], supervised["ref"][2], supervised["ref"][4]
    engine = Engine(supervised["pcfg"], device="cpu", state_dict=supervised["sd"])
    got_loss, got_ld, grads = port_step(engine, supervised["nb"], epoch=1)
    assert set(got_ld) == {"sem_loss", "loss"}
    assert_close(got_loss, ld["sem_loss"], TOL, "sem_loss")
    assert_grads(grads, grads_sem)
    assert_stats(engine.model, stats, only=("backbone", "semantic"))
    before = supervised["sd"]
    for k, v in engine.model.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("mean", "var") and k.split(".")[0] not in ("backbone",
                                                                               "semantic"):
            assert torch.equal(v, before[k]), k


@pytest.mark.cuda
def test_card_step_matches_cpu():
    """chip_smoke.py's train_small_reference: one full-phase step at the
    published U-Net depth on the card and on the CPU, same weights, batch
    and draws, in float64 (within 1e-9) and in float32 (against the float64
    step, module by module no further than 8x the CPU's own error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from geoformer_tpu_torch import config as cfg_mod
    from geoformer_tpu_torch.synthetic import synthetic_batch

    res = chip_smoke.train_small_reference(torch, cfg_mod, Engine, synthetic_batch)
    assert all(res["kernels_equal_to_cpu_run"].values())


def train_task(pcfg, sd, batch, epoch, support=None, few_shot=False, model_parallel=1):
    """A ``train`` task of tests/torch_dist_worker.py."""
    return {"task": "train", "cfg": {k: v for k, v in pcfg.to_dict().items() if k != "config"},
            "sd": sd, "batch": batch, "epoch": epoch, "support": support, "few_shot": few_shot,
            "model_parallel": model_parallel}


def assert_ranks_equal(results):
    """Every rank applied the same gradient and holds the same model."""
    first = results[0]
    for r in results[1:]:
        assert r["loss_dict"] == first["loss_dict"]
        for k in first["grads"]:
            assert torch.equal(r["grads"][k], first["grads"][k]), k
        for k in first["state"]:
            assert torch.equal(r["state"][k], first["state"][k]), k


def test_two_rank_full_phase_step(supervised, two_ranks):
    """Full phase on two ranks against the JAX step on the whole batch."""
    loss, ld, stats, grads_full = (supervised["ref"][i] for i in range(4))
    got = two_ranks["full"]
    assert_ranks_equal(got)
    assert_close(got[0]["loss"], loss, TOL, "loss")
    assert set(got[0]["loss_dict"]) == set(ld)
    assert got[0]["loss_dict"]["num_gt"] == float(ld["num_gt"]) > 0
    for k in ld:
        assert_close(got[0]["loss_dict"][k], ld[k], TOL, k)
    assert_grads(got[0]["grads"], grads_full)
    assert_stats(got[0]["state"], stats)


def test_two_rank_prepare_phase_step(supervised, two_ranks):
    """Prepare phase on two ranks: the semantic CE over the global batch."""
    ld, stats, grads_sem = supervised["ref"][1], supervised["ref"][2], supervised["ref"][4]
    got = two_ranks["prepare"]
    assert_ranks_equal(got)
    assert set(got[0]["loss_dict"]) == {"sem_loss", "loss"}
    assert_close(got[0]["loss"], ld["sem_loss"], TOL, "sem_loss")
    assert_grads(got[0]["grads"], grads_sem)
    assert_stats(got[0]["state"], stats, only=("backbone", "semantic"))


def test_two_rank_step_with_a_rank_without_instances(supervised_inputs, two_ranks, port_packs):
    """A rank whose scene has no gt instance joins every collective of the
    step (no deadlock) and the step equals the one-process step."""
    engine = Engine(supervised_inputs["pcfg"], device="cpu", state_dict=supervised_inputs["sd"])
    loss, ld, grads = port_step(engine, two_ranks["no_gt_batch"], epoch=2)
    got = two_ranks["no_gt"]
    assert_ranks_equal(got)
    assert got[0]["loss_dict"]["num_gt"] == ld["num_gt"] > 0
    assert_close(got[0]["loss"], loss, TOL, "loss")
    for k in ld:
        assert_close(got[0]["loss_dict"][k], ld[k], TOL, k)
    assert set(got[0]["grads"]) == set(grads)
    for k, g in grads.items():
        assert_close(got[0]["grads"][k].numpy(), g.numpy(), TOL, k)
    want = engine.model.state_dict()
    for k, v in got[0]["state"].items():
        if k.rsplit(".", 1)[-1] in ("mean", "var"):
            assert_close(v.numpy(), want[k].numpy(), STATS_TOL, k)


@pytest.fixture(scope="module")
def one_process_read(supervised_inputs):
    """The one-process port's full-phase step, read as the ranks read theirs
    (its geodesic table and matches)."""
    engine = Engine(supervised_inputs["pcfg"], device="cpu", state_dict=supervised_inputs["sd"])
    return read_step(engine, supervised_inputs["nb"], 2)


def assert_model_parallel_step(got, one, cfg, model_parallel=2):
    """Ranks r = d * M + m of a ("data", "model") mesh: each holds query
    columns m of its data index's scenes in the geodesic table, bit-equal to
    the one-process table's; every rank ran the same match; no activation
    a collective moved is as large as one scene's [F, Q] float32 table."""
    q = cfg.n_query_points
    per, n_data = q // model_parallel, len(got) // model_parallel
    b = one["geo"].shape[0] // n_data
    for r, g in enumerate(got):
        d, m = divmod(r, model_parallel)
        want = one["geo"][d * b:(d + 1) * b, :, m * per:(m + 1) * per]
        assert torch.equal(g["geo"], want), f"rank {r}: geodesic table"
        assert torch.equal(g["matches"], one["matches"][d * b:(d + 1) * b]), f"rank {r}: matches"
        table = cfg.tpu_max_fg_points * q * 4
        moved = {k: v for k, v in g["traffic"].items() if k != "gradients"}
        assert {"decoder_qk", "decoder_v", "match_cost"} <= set(moved), moved
        assert not any(k.startswith("eval_") for k in moved), moved
        assert max(moved.values()) < table, (moved, table)


@pytest.mark.parametrize("layout", ["mp_1x2", "mp_2x2"])
def test_model_parallel_full_phase_step(supervised, two_ranks, one_process_read, layout):
    """The full phase on a data x model mesh against the JAX step on the
    whole batch: loss, loss dict, gradients and BN statistics at this
    file's tolerances; the geodesic table, matches and collectives as
    ``assert_model_parallel_step`` holds them."""
    loss, ld, stats, grads_full = (supervised["ref"][i] for i in range(4))
    got = two_ranks[layout]
    assert_ranks_equal(got)
    assert_close(got[0]["loss"], loss, TOL, "loss")
    assert set(got[0]["loss_dict"]) == set(ld)
    assert got[0]["loss_dict"]["num_gt"] == float(ld["num_gt"]) > 0
    for k in ld:
        assert_close(got[0]["loss_dict"][k], ld[k], TOL, k)
    assert_grads(got[0]["grads"], grads_full)
    assert_stats(got[0]["state"], stats)
    assert_model_parallel_step(got, one_process_read, supervised["cfg"])
