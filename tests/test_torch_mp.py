"""The port's query-axis model parallelism (the JAX ``model`` mesh axis,
parallel/mesh.py) on the CPU, beside the repairs that came with it.

The layout and the helpers are held on their own: rank r of a ("data",
"model") mesh is data index r // M and model index r % M, as JAX's
``reshape(-1, M)`` lays devices out; a model rank's queries, batch rows and
subsample draws. The collectives run on two ``gloo`` ranks, spawned once
for the module (tests/torch_dist_worker.py), against one process on the
same weights and batch, both on one thread (the CPU's matrix products
round by their thread count):

* ``Engine.eval_batch`` at 1x2: the class and mask logits of every query
  and the proposals on model index 0 exactly equal one process's; model
  index 1 returns no proposals;
* the same at Q = 7, which M = 2 does not divide (every model rank runs
  all queries, as ``_shard_solve`` falls back to the replicated solve), and
  a full-phase training step there within 1e-5 x max(1, |ref|inf) of one
  process (float32 loss terms summed over the ranks);
* the few-shot engine's support, encode and decode at 1x2: the decode's
  proposals equal one process's;
* the fallback maxima: a scene with fewer foreground points (4) than
  queries has invalid query slots, whose rel-pos takes the largest maximum
  over the batch (JAX's ``jnp.max`` over the whole [B, Q], which spans the
  data axis under SPMD) and whose mask head takes the scene's maximum over
  all its queries. Their logits reach the proposals, which
  ``generate_proposal`` does not gate by query validity. On two data ranks
  (one scene each) and on 1x2 (the invalid slots all on model index 1) the
  eval outputs equal one process's exactly.
"""

import numpy as np
import pytest
import torch

from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig, draw_subsample
from geoformer_tpu_torch.models.geoformer_fs import GeoFormerFS
from geoformer_tpu_torch.parallel.mesh import (
    Mesh,
    query_slice,
    replica_weight,
    set_mesh,
    shard_batch,
)
from test_torch_eval_driver import _nontrivial_state_dict
from test_torch_fs import _nontrivial_state_dict as _nontrivial_fs_state_dict
from test_torch_train import STATS_TOL, TOL, assert_close, port_config, train_batch, train_task
from test_torch_train_fs import episode
from torch_dist_worker import SpawnedRanks, read_step

CPU = torch.device("cpu")


@pytest.mark.parametrize("world,model_parallel", [(2, 2), (4, 2), (6, 3)])
def test_layout_is_jax_reshape(world, model_parallel):
    """Data index r // M, model index r % M (np.reshape(-1, M)); a rank's
    batch rows and draws are its data index's, its queries its model
    index's share (all of them where M does not divide Q)."""
    grid = np.arange(world).reshape(-1, model_parallel)
    batch = {"x": np.arange(2 * grid.shape[0])}
    mask = torch.ones(2 * grid.shape[0], 8, dtype=torch.bool)
    want = draw_subsample(mask, 4, torch.Generator().manual_seed(3))
    for rank in range(world):
        mesh = Mesh(rank, world, CPU, model_parallel=model_parallel)
        d, m = np.argwhere(grid == rank)[0]
        assert (mesh.data_rank, mesh.model_rank) == (d, m)
        assert (mesh.data_world, mesh.model_world) == grid.shape
        np.testing.assert_array_equal(shard_batch(batch, mesh)["x"], [2 * d, 2 * d + 1])
        with set_mesh(mesh):
            assert torch.equal(draw_subsample(mask[2 * d:2 * d + 2], 4,
                                              torch.Generator().manual_seed(3)),
                               want[2 * d:2 * d + 2])
            per = 12 // model_parallel
            assert query_slice(12) == slice(m * per, (m + 1) * per)
            assert query_slice(12 * model_parallel + 1) == slice(0, 12 * model_parallel + 1)
            assert replica_weight() == (1.0 if m == 0 else 0.0)


def _eval_task(cfg, sd, batch, model_parallel):
    return {"task": "eval", "cfg": {k: v for k, v in cfg.to_dict().items() if k != "config"},
            "sd": sd, "batch": batch, "model_parallel": model_parallel}


@pytest.fixture(scope="module")
def setup(tiny_cfg, tmp_path_factory):
    """Configs, weights and batches of the module's cases, their rank tasks
    started at once, and the one-process runs meanwhile."""
    cfgs = {q: port_config(tiny_cfg, tpu_brick_occupancy=0, tpu_unet_depth=2, dec_dropout=0.0,
                           n_query_points=q, TEST_SCORE_THRESH=0.0, TEST_NPOINT_THRESH=1,
                           prepare_epochs=1) for q in (8, 7)}
    sds = {q: _nontrivial_state_dict(GeoFormer(ModelConfig.from_cfg(c)), seed=15)
           for q, c in cfgs.items()}
    batch = train_batch(tiny_cfg.replace(tpu_unet_depth=2))
    # scene 0 keeps the 6 points nearest its first, a patch the radius graph
    # connects, with 4 foreground points: fewer than the 8 queries
    near = np.argsort(((batch["points"][0] - batch["points"][0, 0]) ** 2).sum(1))[:6]
    sparse = dict(batch, point_mask=batch["point_mask"].copy())
    sparse["point_mask"][0] = False
    sparse["point_mask"][0, near] = True
    fs_cfg = port_config(tiny_cfg, tpu_brick_occupancy=0, tpu_unet_depth=2, dec_dropout=0.0,
                         similarity_thresh=0.0, TEST_SCORE_THRESH=0.0, TEST_NPOINT_THRESH=1)
    fs_sd = _nontrivial_fs_state_dict(GeoFormerFS(ModelConfig.from_cfg(fs_cfg)), seed=15)
    query, support = episode(tiny_cfg)
    fs_task = dict(_eval_task(fs_cfg, fs_sd, query, 2), task="fs_eval", support=support)
    tasks = {"eval_1x2": _eval_task(cfgs[8], sds[8], batch, 2),
             "eval_q7_1x2": _eval_task(cfgs[7], sds[7], batch, 2),
             "train_q7_1x2": train_task(cfgs[7], sds[7], batch, 2, model_parallel=2),
             "fs_eval_1x2": fs_task,
             "eval_fallback_2x1": _eval_task(cfgs[8], sds[8], sparse, 1),
             "eval_fallback_1x2": _eval_task(cfgs[8], sds[8], sparse, 2)}
    spawned = SpawnedRanks(tasks, 2, str(tmp_path_factory.mktemp("mp_ranks")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        single = {
            "eval_1x2": Engine(cfgs[8], device="cpu", state_dict=sds[8]).eval_batch(batch),
            "eval_q7_1x2": Engine(cfgs[7], device="cpu", state_dict=sds[7]).eval_batch(batch),
            "train_q7_1x2": read_step(Engine(cfgs[7], device="cpu", state_dict=sds[7]),
                                      batch, 2),
            "eval_fallback_2x1": Engine(cfgs[8], device="cpu",
                                        state_dict=sds[8]).eval_batch(sparse)}
        single["eval_fallback_1x2"] = single["eval_fallback_2x1"]
        fs = Engine(fs_cfg, device="cpu", state_dict=fs_sd, few_shot=True)
        single["fs_eval_1x2"] = fs.decode_with_support(fs.encode_scene(query),
                                                       fs.process_support(support))
        out = spawned.results()
    finally:
        torch.set_num_threads(threads)
        spawned.ranks.stop()
    return {"single": single, "ranks": {k: [r[k] for r in out] for k in tasks}}


def _assert_equal(got, want, what):
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k], f"{what}.{k}")
        else:
            assert torch.equal(got[k], want[k]), f"{what}.{k}"


@pytest.mark.parametrize("case", ["eval_1x2", "eval_q7_1x2", "eval_fallback_1x2"])
def test_model_parallel_eval_equals_one_process(setup, case):
    """1x2 eval forward (queries split; at Q = 7 replicated; with scene 0's
    invalid query slots all on model index 1, whose fallback maxima come
    from the other rank): every query's logits and the proposals and NMS
    exactly one process's, on model index 0 only."""
    want = setup["single"][case]
    first, second = setup["ranks"][case]
    keys = ("cls_logits", "mask_logits", "fg_idx", "fg_valid", "query_valid", "semantic_scores")
    for got in (first, second):
        _assert_equal(got, {k: want[k] for k in keys}, case)
    _assert_equal(first, {"proposals": want["proposals"], "nms": want["nms"]}, case)
    assert "proposals" not in second and "nms" not in second
    assert want["proposals"]["keep"].any(), "the case should keep proposals"


def test_model_parallel_step_with_indivisible_queries(setup):
    """Q = 7 on M = 2: every model rank runs all queries; the query terms
    count on model index 0, and the step equals one process's."""
    want = setup["single"]["train_q7_1x2"]
    got = setup["ranks"]["train_q7_1x2"]
    for g in got:
        assert g["loss_dict"] == got[0]["loss_dict"]
        assert g["geo"].shape == want["geo"].shape and torch.equal(g["geo"], want["geo"])
        assert torch.equal(g["matches"], want["matches"])
        assert_close(g["loss"], want["loss"], TOL, "loss")
        for k, v in want["loss_dict"].items():
            assert_close(g["loss_dict"][k], v, TOL, k)
        assert set(g["grads"]) == set(want["grads"])
        for k, v in want["grads"].items():
            assert torch.equal(g["grads"][k], got[0]["grads"][k]), k
            assert_close(g["grads"][k].numpy(), v.numpy(), TOL, k)
        for k, v in want["state"].items():
            assert torch.equal(g["state"][k], got[0]["state"][k]), k
            assert_close(g["state"][k].numpy(), v.numpy(), STATS_TOL, k)
    assert want["loss_dict"]["num_gt"] > 0


def test_model_parallel_few_shot_decode_equals_one_process(setup):
    """encode_scene and decode_with_support at 1x2 (the decode's own
    scenes, queries split): masks, scores, keep, similarity and mask logits
    exactly one process's on both model ranks."""
    want = setup["single"]["fs_eval_1x2"]
    for got in setup["ranks"]["fs_eval_1x2"]:
        _assert_equal(got, want, "fs_eval")
    assert want["keep"].any(), "the case should keep proposals"


def test_rel_pos_fallback_spans_the_data_axis(setup):
    """Two data ranks, one scene each; scene 0 has invalid query slots,
    whose rel-pos takes the batch's largest maximum: the ranks' logits of
    every query, proposals and NMS equal one process's on the whole batch."""
    want = setup["single"]["eval_fallback_2x1"]
    assert want["query_valid"][0].tolist() == [True] * 4 + [False] * 4
    assert want["query_valid"][1].all()
    for rank, got in enumerate(setup["ranks"]["eval_fallback_2x1"]):
        rows = slice(rank, rank + 1)
        for k in ("cls_logits", "mask_logits"):
            assert torch.equal(got[k], want[k][:, rows]), (rank, k)
        for k in ("masks", "scores", "keep"):
            assert torch.equal(got["proposals"][k], want["proposals"][k][rows]), (rank, k)
        assert torch.equal(got["nms"]["keep"], want["nms"]["keep"][rows])
