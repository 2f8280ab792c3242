"""Training steps with frozen modules, the port vs the JAX package on the
CPU: one few-shot step, and one supervised prepare step with the backbone
frozen (on tests/test_torch_train.py's inputs).

The published few-shot config's frozen modules (config/geoformer_fs_scannet.yaml
fix_module: the backbone, the semantic head, the set aggregator, the
positional embedding's projection and the decoder) on the tiny model of
tests/test_torch_train.py, with its injected subsample draws, no dropout,
the same weights and batches. The JAX reference is one program, compiled
once: the few-shot criterion's loss (dice, focal and the similarity loss),
its gradients and the BN statistics after the forward; the port runs
``Engine.train_step`` with the support batch.

The frozen backbone's step is a prepare-phase (``semantic_only``) program
of its own. The few-shot step also runs on two ``gloo`` ranks, one episode
a rank (tests/torch_dist_worker.py, spawned once), against the same JAX
outputs at the same tolerances, and on a 1x2 ("data", "model") mesh (the
episode's 8 queries split over two model ranks) against them too, with the
ranks' geodesic tables and matches equal to the one-process port's.
Tolerances: the loss, each loss term and every gradient leaf within
1e-4 x max(1, |ref|inf); a frozen module's JAX gradient exactly 0 (its port
parameters take none); BN running statistics within 1e-5, the frozen
modules' left exactly as they were.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.losses import FSInstSetCriterion as JaxFSInstSetCriterion
from geoformer_tpu.losses import InstSetCriterion as JaxInstSetCriterion
from geoformer_tpu.models.geoformer import GeoFormer as JaxGeoFormer
from geoformer_tpu.models.geoformer import ModelConfig as JaxModelConfig
from geoformer_tpu.models.geoformer_fs import GeoFormerFS as JaxGeoFormerFS
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.models.geoformer import ModelConfig
from geoformer_tpu_torch.models.geoformer_fs import GeoFormerFS
from geoformer_tpu_torch.weights import from_jax_variables, to_jax_variables
from test_torch_train import (
    assert_close,
    assert_grads,
    assert_stats,
    injected,
    jit_default,
    perturbed_weights,
    port_config,
    port_step,
    supervised_inputs,
    train_batch,
    TOL,
    WORLD,
    assert_model_parallel_step,
    assert_ranks_equal,
    train_task,
)
from torch_dist_worker import SpawnedRanks, read_step

FS_FROZEN = ["input_conv", "unet", "output_layer", "semantic", "semantic_linear",
             "set_aggregator", "pos_embedding", "query_projection", "decoder"]


def episode(cfg):
    """A query batch with binary labels (1 on the sampled class) and a
    support batch with its instance mask, as FSInstDataset builds them. One
    query instance takes most of the points, so that wide predicted masks
    overlap it at IoU >= 0.5 and the similarity loss has positives."""
    query = train_batch(cfg, seed=2)
    rng = np.random.default_rng(4)
    big = rng.random(query["instance_labels"].shape) < 0.7
    query["instance_labels"] = np.where(big, 0, query["instance_labels"]).astype(np.int32)
    query["labels"] = (query["instance_labels"] >= 0).astype(np.int32)
    support = train_batch(cfg, seed=3)
    support["support_masks"] = (support["instance_labels"] == 2).astype(np.int32)
    return query, support


@pytest.fixture(scope="module")
def few_shot(tiny_cfg, tmp_path_factory):
    """The JAX step's outputs, with the two-rank step started before its
    compile (``ranks``; ``ranks.results()`` waits for it)."""
    cfg = tiny_cfg.replace(tpu_unet_depth=2, tpu_brick_occupancy=0, dec_dropout=0.0,
                           prepare_epochs=0, fix_module=FS_FROZEN, negative_ratio=2)
    query, support = episode(cfg)
    pcfg = port_config(cfg)
    model = GeoFormerFS(ModelConfig.from_cfg(pcfg))
    sd = perturbed_weights(model)
    model.load_state_dict(sd)
    spawned = SpawnedRanks({"step": train_task(pcfg, sd, query, 1, support=support,
                                               few_shot=True),
                            "mp_step": train_task(pcfg, sd, query, 1, support=support,
                                                  few_shot=True, model_parallel=2)},
                           WORLD, str(tmp_path_factory.mktemp("fs_ranks")))
    variables = to_jax_variables(model)
    jm = JaxGeoFormerFS(JaxModelConfig.from_cfg(cfg))
    crit = JaxFSInstSetCriterion(cfg)
    rngs = {"sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

    def step(params, stats, consts, sup, batch):
        def f(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats, "constants": consts}, sup,
                                batch, train=True, rngs=rngs, mutable=["batch_stats"])
            loss, ld = crit(out, batch, 1)
            return loss, (ld, mut["batch_stats"])

        return jax.value_and_grad(f, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        injected(mp)
        as_jax = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
        ref = jax.tree_util.tree_map(np.asarray, jit_default(
            step, variables["params"], variables["batch_stats"], variables["constants"],
            as_jax(support), as_jax(query)))
    try:
        yield dict(cfg=cfg, pcfg=pcfg, query=query, support=support, sd=sd, ref=ref,
                   ranks=spawned)
    finally:
        spawned.ranks.stop()


@pytest.fixture(scope="module")
def one_process_step(few_shot):
    """The one-process port's few-shot step, read (tests/torch_dist_worker.py
    ``read_step``), and its engine after it."""
    engine = Engine(few_shot["pcfg"], device="cpu", state_dict=few_shot["sd"], few_shot=True)
    return engine, read_step(engine, few_shot["query"], 1, few_shot["support"])


def test_few_shot_step(few_shot, one_process_step):
    (loss, (ld, stats)), grads = few_shot["ref"]
    engine, read = one_process_step
    got_loss, got_ld, got = read["loss"], read["loss_dict"], read["grads"]
    assert_close(got_loss, loss, TOL, "loss")
    assert set(got_ld) == set(ld) == {"sim_loss", "dice_loss", "focal_loss", "num_gt", "loss"}
    assert got_ld["num_gt"] == float(ld["num_gt"]) > 0 and float(ld["sim_loss"]) > 0
    for k in ld:
        assert_close(got_ld[k], ld[k], TOL, k)
    trainable = {k.split(".")[0] for k in engine.state.params}
    assert trainable == {"mask_tower0", "mask_tower1", "mask_tower2", "mask_out",
                         "controller_head", "encoder_to_decoder_projection", "similarity_net"}
    frozen = [k for k in from_jax_variables({"params": grads}) if k not in engine.state.params]
    assert_grads(got, grads, frozen)
    assert_stats(engine.model, stats)
    for k, v in engine.model.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("mean", "var") and k.split(".")[0] not in trainable:
            assert torch.equal(v, few_shot["sd"][k]), k


@pytest.mark.parametrize("layout", ["step", "mp_step"])
def test_two_rank_few_shot_step(few_shot, one_process_step, layout):
    """The few-shot step on two ranks against the JAX step on the whole
    episode batch: on the data axis (query and support batches sharded),
    and on the model axis (1x2: the episode's queries split)."""
    (loss, (ld, stats)), grads = few_shot["ref"]
    got = [r[layout] for r in few_shot["ranks"].results()]
    assert_ranks_equal(got)
    assert_close(got[0]["loss"], loss, TOL, "loss")
    assert set(got[0]["loss_dict"]) == set(ld)
    assert got[0]["loss_dict"]["num_gt"] == float(ld["num_gt"]) > 0
    for k in ld:
        assert_close(got[0]["loss_dict"][k], ld[k], TOL, k)
    frozen = [k for k in from_jax_variables({"params": grads}) if k not in got[0]["grads"]]
    assert_grads(got[0]["grads"], grads, frozen)
    assert_stats(got[0]["state"], stats)
    if layout == "mp_step":
        assert_model_parallel_step(got, one_process_step[1], few_shot["cfg"])


def test_frozen_backbone_prepare_step(supervised_inputs):
    """fix_module freezes the backbone: it runs in eval mode (running
    statistics, left as they were), its output is detached, its parameters
    take no gradient and no optimizer state; the semantic head trains."""
    cfg = supervised_inputs["cfg"].replace(fix_module=["input_conv", "unet", "output_layer"])
    jm = JaxGeoFormer(JaxModelConfig.from_cfg(cfg))
    crit = JaxInstSetCriterion(cfg)
    v = supervised_inputs["variables"]

    def step(params, stats, consts, batch):
        def f(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats, "constants": consts}, batch,
                                train=True, semantic_only=True, mutable=["batch_stats"])
            loss, _ = crit(out, batch, 0)
            return loss, mut["batch_stats"]

        return jax.value_and_grad(f, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        injected(mp)
        (loss, stats), grads = jax.tree_util.tree_map(np.asarray, jit_default(
            step, v["params"], v["batch_stats"], v["constants"],
            {k: jnp.asarray(a) for k, a in supervised_inputs["nb"].items()}))
    engine = Engine(port_config(cfg), device="cpu", state_dict=supervised_inputs["sd"])
    got_loss, _, got = port_step(engine, supervised_inputs["nb"], epoch=1)
    assert "backbone" in engine.state.frozen
    assert all(not p.requires_grad for p in engine.model.backbone.parameters())
    assert not any(engine.state.optimizer.state[p] for p in engine.model.backbone.parameters())
    assert_close(got_loss, loss, TOL, "loss")
    frozen = [k for k in from_jax_variables({"params": grads}) if k.startswith("backbone.")]
    assert_grads(got, grads, frozen)
    assert_stats(engine.model, stats)
    for k, t in engine.model.backbone.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("mean", "var"):
            assert torch.equal(t, supervised_inputs["sd"][f"backbone.{k}"]), k
