"""The port's data parallelism (parallel/dist.py, parallel/mesh.py, the
data-mesh paths of MaskedBatchNorm and the eval drivers) on the CPU.

The rank helpers are held against the JAX package's parallel/dist.py under
the same patched rank and world (as tests/test_dist.py patches them). The
collectives run in real ``gloo`` process groups: the module spawns its two
ranks once (tests/torch_dist_worker.py, one thread a rank, a timeout of its
own so that a deadlock fails instead of hanging the run), and they run
every task of this file:

* MaskedBatchNorm in training mode on each rank's half of a batch: output,
  input gradient, parameter gradients and running statistics equal the JAX
  MaskedBatchNorm on the whole batch within 1e-6 (float32 sums
  reassociated over two ranks);
* cli.test and cli.test_fs at test_batch_size 2 on a tiny synthetic
  dataset: every scene's predictions (their sha256 digest) and the AP
  table exactly equal the one-process run's.
"""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

import geoformer_tpu.parallel.dist as jdist
import geoformer_tpu_torch.parallel.dist as tdist
from geoformer_tpu.models.blocks import MaskedBatchNorm as JaxMaskedBatchNorm
from geoformer_tpu_torch import default_device
from geoformer_tpu_torch.cli import test as cli_test
from geoformer_tpu_torch.cli import test_fs as cli_test_fs
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.models.blocks import MaskedBatchNorm
from geoformer_tpu_torch.models.geoformer import draw_subsample
from geoformer_tpu_torch.parallel.mesh import Mesh, make_mesh, set_mesh, shard_batch
from geoformer_tpu_torch.weights import save_jax_checkpoint
from test_torch_eval_driver import _nontrivial_state_dict
from test_torch_fs import _nontrivial_state_dict as _nontrivial_fs_state_dict
from tools.make_synthetic_data import main as make_synthetic_data
from torch_dist_worker import SpawnedRanks

WORLD = 2
BN_TOL = 1e-6


def _patch_world(monkeypatch, rank, world):
    """Both packages' rank and world size (tests/test_dist.py's patch)."""
    for mod in (jdist, tdist):
        monkeypatch.setattr(mod, "get_rank", lambda: rank)
        monkeypatch.setattr(mod, "get_world_size", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_shards_and_seeds_equal_jax(monkeypatch, world):
    """shard_indices and local_seed of every rank equal the JAX package's."""
    for rank in range(world):
        _patch_world(monkeypatch, rank, world)
        for n, seed in ((103, 7), (10, 3), (2, 0)):
            np.testing.assert_array_equal(tdist.shard_indices(n, 4, seed),
                                          jdist.shard_indices(n, 4, seed))
        assert tdist.local_seed(100) == jdist.local_seed(100) == 100 + rank
        assert tdist.is_primary() == jdist.is_primary() == (rank == 0)


def test_shard_batch_slices_and_raises():
    batch = {"points": np.arange(24).reshape(6, 4), "mask": torch.arange(6)}
    assert shard_batch(batch, None) is batch
    for rank in range(3):
        got = shard_batch(batch, Mesh(rank, 3, torch.device("cpu")))
        np.testing.assert_array_equal(got["points"], batch["points"][2 * rank:2 * rank + 2])
        assert torch.equal(got["mask"], batch["mask"][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="cannot be split"):
        shard_batch(batch, Mesh(0, 4, torch.device("cpu")))


@pytest.mark.parametrize("capacity", [4, 16])
def test_draws_are_the_global_tables_rows(capacity):
    """Under a data mesh a rank's subsample draws are its rows of the draws
    one process makes for the global batch (both of draw_subsample's paths:
    scores when the capacity is below P, rotation offsets at or above it)."""
    mask = torch.ones(4, 8, dtype=torch.bool)
    mask[1, 5:] = False
    want = draw_subsample(mask, capacity, torch.Generator().manual_seed(3))
    for rank in range(WORLD):
        with set_mesh(Mesh(rank, WORLD, torch.device("cpu"))):
            rows = slice(2 * rank, 2 * rank + 2)
            got = draw_subsample(mask[rows], capacity, torch.Generator().manual_seed(3))
        assert torch.equal(got, want[rows])


def test_world_of_one_needs_no_group(monkeypatch):
    """Without torchrun's environment nothing is initialised, the mesh is a
    world of 1, and a model axis of 2 does not divide it (the JAX assert at
    geoformer_tpu/parallel/mesh.py:29)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed() is False and not tdist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.device) == (0, 1, None, torch.device("cpu"))
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cannot be split into model groups of 2"):
        make_mesh(model_parallel=2, device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        tdist.init_distributed()


@pytest.fixture(scope="module")
def eval_setup(tiny_cfg, tmp_path_factory):
    """A tiny synthetic dataset, one supervised and one few-shot checkpoint
    whose proposals survive, and the two drivers' configs at
    test_batch_size 2."""
    root = str(tmp_path_factory.mktemp("dist_data"))
    make_synthetic_data(root=root, n_scenes=8, n_points=800, seed=0)
    common = dict(data_root=root, tpu_brick_occupancy=0, tpu_unet_depth=2, cvfold=0,
                  split="val", TEST_SCORE_THRESH=0.0, TEST_NPOINT_THRESH=10,
                  TEST_NMS_THRESH=1e-4, output_path=os.path.join(root, "exp"),
                  test_batch_size=WORLD)
    values = {k: v for k, v in tiny_cfg.to_dict().items() if k != "config"}
    cfgs = {"test": load_config(None, **dict(values, **common)),
            "test_fs": load_config(None, **dict(values, **common, similarity_thresh=0.2,
                                                fix_support=True, run_num=2, k_shot=1,
                                                type_support="fullscene_fold"))}
    argv = {}
    for name, cfg in cfgs.items():
        few_shot = name == "test_fs"
        engine = Engine(cfg, device="cpu", few_shot=few_shot)
        make_sd = _nontrivial_fs_state_dict if few_shot else _nontrivial_state_dict
        engine.model.load_state_dict(make_sd(engine.model, seed=15))
        ckpt, config = (os.path.join(root, f"{name}{ext}") for ext in (".ckpt", ".yaml"))
        save_jax_checkpoint(ckpt, engine.model)
        with open(config, "w") as f:
            yaml.safe_dump({"ALL": {k: v for k, v in cfg.to_dict().items() if k != "config"}}, f)
        argv[name] = ["--config", config, "--pretrain", ckpt, "--device", "cpu"]
    return dict(root=root, argv=argv)


def test_loaders_share_the_global_batch(eval_setup, monkeypatch):
    """batch_size is the global batch: each of two ranks loads half of it a
    step, both yield the same number of steps, and an odd share raises."""
    from geoformer_tpu_torch.data.episodic import FSInstDataset
    from geoformer_tpu_torch.data.scannet import InstDataset

    cfg = load_config(eval_setup["argv"]["test_fs"][1])
    counts = {}
    for rank in range(WORLD):
        _patch_world(monkeypatch, rank, WORLD)
        sup = list(InstDataset(cfg, "train").train_batches(4, seed=1))
        fs = list(FSInstDataset(cfg, "train").train_batches(2, seed=1))
        assert all(b["points"].shape[0] == 2 for b in sup)
        assert all(s["points"].shape[0] == q["points"].shape[0] == 1 for s, q, _ in fs)
        counts[rank] = (len(sup), len(fs))
        with pytest.raises(ValueError, match="cannot be split"):
            next(InstDataset(cfg, "train").train_batches(3))
    assert counts[0] == counts[1] == (1, 2)


@pytest.fixture(scope="module")
def ranks(eval_setup, tmp_path_factory):
    """The module's two gloo ranks, spawned once: the batch norm's task and
    both eval drivers; the one-process driver runs go meanwhile."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (4, 50, 6)).astype(np.float32))
    mask = torch.from_numpy(rng.random((4, 50)) < 0.7)
    mask[3] = False  # a scene with no valid row: the rank still joins every collective
    cot = torch.from_numpy(rng.normal(size=(4, 50, 6)).astype(np.float32))
    bn = MaskedBatchNorm(6)
    state = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
             for k, v in bn.state_dict().items()}
    tasks = {"bn": {"task": "bn", "x": x, "mask": mask, "cot": cot, "state": state}}
    drivers = {"test": cli_test.main, "test_fs": cli_test_fs.main}
    for name in drivers:
        tasks[name] = {"task": "cli", "module": f"geoformer_tpu_torch.cli.{name}",
                       "argv": eval_setup["argv"][name] + ["--exp_name", f"{name}_world2"]}
    spawned = SpawnedRanks(tasks, WORLD, str(tmp_path_factory.mktemp("dist_ranks")))
    try:
        single = {name: main(eval_setup["argv"][name] + ["--exp_name", f"{name}_world1"])
                  for name, main in drivers.items()}
        yield dict(out=spawned.results(), single=single, bn_inputs=(x, mask, cot, state))
    finally:
        spawned.ranks.stop()


def test_masked_batch_norm_over_ranks_equals_jax(ranks):
    """The global batch's statistics, gradients and running statistics."""
    x, mask, cot, state = ranks["bn_inputs"]
    jbn = JaxMaskedBatchNorm(6)
    params = {k: jnp.asarray(state[k].numpy()) for k in ("scale", "bias")}
    stats = {k: jnp.asarray(state[k].numpy()) for k in ("mean", "var")}

    def f(p, xx):
        return jbn.apply({"params": p, "batch_stats": stats}, xx, jnp.asarray(mask.numpy()),
                         train=True, mutable=["batch_stats"])

    y, mut = f(params, jnp.asarray(x.numpy()))
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0], params, jnp.asarray(x.numpy()))
    p_grad, x_grad = pull(jnp.asarray(cot.numpy()))
    got = [r["bn"] for r in ranks["out"]]
    for k, want in (("y", y), ("x_grad", x_grad)):
        err = np.abs(np.concatenate([g[k].numpy() for g in got]) - np.asarray(want)).max()
        assert err <= BN_TOL * max(1.0, float(np.abs(np.asarray(want)).max())), k
    for g in got:
        for k, want in (("scale_grad", p_grad["scale"]), ("bias_grad", p_grad["bias"]),
                        ("mean", mut["batch_stats"]["mean"]), ("var", mut["batch_stats"]["var"])):
            want = np.asarray(want)
            assert np.abs(g[k].numpy() - want).max() <= BN_TOL * max(1.0, np.abs(want).max()), k
    assert all(torch.equal(got[0][k], got[1][k]) for k in ("mean", "var", "scale_grad"))


@pytest.mark.parametrize("driver", ["test", "test_fs"])
def test_eval_over_two_ranks_equals_one(ranks, driver):
    """Per-scene predictions and the AP table of a 2-rank run equal the
    one-process run's exactly; rank 1 returns no AP and no records."""
    single = ranks["single"][driver]
    got, other = ranks["out"][0][driver], ranks["out"][1][driver]
    assert other["avgs"] is None and other["scenes"] == []
    keys = ("scene", "pred_digest", "fg_points")
    assert [[r[k] for k in keys] for r in got["scenes"]] == [
        [r[k] for k in keys] for r in single["scenes"]]
    assert len(single["scenes"]) == 4
    np.testing.assert_equal(got["avgs"], single["avgs"])
    if driver == "test":
        assert sum(r["proposals"] for r in single["scenes"]) > 0
