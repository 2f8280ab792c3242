"""The port's few-shot model (GeoFormerFS) and driver vs the JAX package.

Both run on the CPU at tests/conftest.py:tiny_cfg over one synthetic dataset
(tools/make_synthetic_data.py: 800-point scenes, subsampled to the 512-point
capacity; 1- and 5-shot support sets) on one set of weights, made in the port
and carried to JAX by ``weights.to_jax_variables``.
The JAX stages are jitted once per module; each port stage gets the JAX
stage's inputs, so a stage is held on its own. Tolerances:

* support embedding, U-Net/head floats, similarity and mask logits: 1e-4
  (f32 sums reassociated through the U-Net, the aggregator and the decoder);
* the geodesic table: 1e-5, with the -1 (unreached) pattern exactly equal;
* every integer output (fg and context indices, validity, counters, NMS
  keep) exactly equal; proposal masks and keep exactly equal except where
  JAX's sigmoid lies within 1e-5 of the 0.2 mask threshold; scores 1e-5.
"""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from geoformer_tpu.data.episodic import FSInstDataset as JaxFSInstDataset
from geoformer_tpu.data.scannet import BENCHMARK_SEMANTIC_LABELS as JAX_BENCHMARK_LABELS
from geoformer_tpu.evaluation import scannet_eval as jax_scannet_eval
from geoformer_tpu.evaluation.gt import make_gt_ids as jax_make_gt_ids
from geoformer_tpu.evaluation.predictions import nn_projection as jax_nn_projection
from geoformer_tpu.evaluation.predictions import scene_alignment as jax_scene_alignment
from geoformer_tpu.models.geoformer import ModelConfig as JaxModelConfig
from geoformer_tpu.models.geoformer_fs import GeoFormerFS as JaxGeoFormerFS
from geoformer_tpu.models.geoformer_fs import generate_fs_proposal as jax_generate_fs_proposal
from geoformer_tpu.ops.nms import matrix_nms as jax_matrix_nms
from geoformer_tpu.utils.config import load_config as jax_load_config
from geoformer_tpu_torch.cli import test_fs as cli_test_fs
from geoformer_tpu_torch.config import load_config, scannet_fs_eval_config
from geoformer_tpu_torch.data.episodic import FSInstDataset
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.models.geoformer import ModelConfig
from geoformer_tpu_torch.models.geoformer_fs import generate_fs_proposal
from geoformer_tpu_torch.utils.logger import create_logger
from geoformer_tpu_torch.weights import (
    from_jax_variables,
    random_state_dict,
    save_jax_checkpoint,
    to_jax_variables,
)
from tools.make_synthetic_data import main as make_synthetic_data

CACHE_INT_KEYS = ("fg_idx", "fg_valid", "context_inds", "context_valid")
CACHE_EXACT_KEYS = ("fg_locs", "context_locs")  # gathered input coordinates
CACHE_FLOAT_KEYS = ("semantic_scores", "mask_feats", "context_feats")


def _nontrivial_state_dict(model, seed):
    """Seeded weights with non-trivial BN statistics, norm parameters and
    biases; the semantic head, the similarity net and the controller are
    widened so that similarities vary over queries and the dynamic masks are
    neither empty nor full."""
    rng = np.random.default_rng(seed)
    sd = random_state_dict(model, seed)
    for key, t in sd.items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight" and key.startswith(("semantic.", "similarity_net.")):
            sd[key] = t * 10.0
        elif key == "controller_head.controller.weight":
            sd[key] = t * 100.0
        elif name in ("mean", "bias"):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, t.shape).astype(np.float32))
        elif name in ("var", "scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
    return sd


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


def _near_threshold_full(mask_logits, fg_idx, p, thresh=0.2, tol=1e-5):
    """[B,Q,P] flags of points whose JAX mask probability is within ``tol``
    of the mask threshold (a reassociated sum may flip them)."""
    near = np.abs(1.0 / (1.0 + np.exp(-mask_logits.astype(np.float64))) - thresh) < tol
    full = np.zeros(near.shape[:2] + (p,), bool)
    for b in range(fg_idx.shape[0]):
        full[b][:, fg_idx[b]] = near[b]
    return full


@pytest.fixture(scope="module")
def setup(tiny_cfg, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fs_data"))
    make_synthetic_data(root=root, n_scenes=6, n_points=800, seed=3)
    jcfg = tiny_cfg.replace(
        data_root=root, tpu_brick_occupancy=0, cvfold=0, split="val", batch_size=1,
        similarity_thresh=0.2, fix_support=True, run_num=2, k_shot=1,
        type_support="fullscene_fold", TEST_SCORE_THRESH=0.0, TEST_NPOINT_THRESH=10,
        TEST_NMS_THRESH=1e-4, output_path=os.path.join(root, "exp"),
        tpu_geodesic_radius=0.25)  # the blobs' spacing: a graph with edges
    tcfg = load_config(None, **{k: v for k, v in jcfg.to_dict().items() if k != "config"})
    ds = FSInstDataset(tcfg, "val")
    scene_name, active, scene = next(ds.test_batches())
    sup_scene, sup_inst = ds.load_test_combinations()[scene_name][active[0]]
    support = ds.support_batch(sup_scene, int(sup_inst))
    small = {k: v.copy() for k, v in support.items()}  # a support mask of 5 points
    small["support_masks"][0, np.nonzero(support["support_masks"][0])[0][5:]] = 0

    engine = Engine(tcfg, device="cpu", few_shot=True)
    engine.model.load_state_dict(_nontrivial_state_dict(engine.model, seed=0))
    variables = to_jax_variables(engine.model)

    jm = JaxGeoFormerFS(JaxModelConfig.from_cfg(jcfg))
    rngs = {"sample": jax.random.PRNGKey(0)}

    def scene_stages(m, emb, scn):
        cache = m.encode_scene(scn, False)
        dec = m.decode_with_support(cache, emb, scn["pc_mins"], scn["pc_maxs"], False)
        props = jax_generate_fs_proposal(
            dec["mask_logits"][-1], jax.nn.sigmoid(dec["similarity"]), dec["fg_idx"],
            dec["fg_valid"], scn["point_mask"], logit_thresh=0.2,
            score_thresh=jcfg.TEST_SCORE_THRESH, npoint_thresh=jcfg.TEST_NPOINT_THRESH,
            sim_score_thresh=jcfg.similarity_thresh)
        return cache, dec, props

    # two programs, each traced and compiled once: the support embedding,
    # and the scene's encode, decode and proposals on an embedding
    embed = jax.jit(lambda v, s: jm.apply(v, s, rngs=rngs, method=JaxGeoFormerFS.process_support))
    run_scene = jax.jit(lambda v, e, q: jm.apply(v, e, q, rngs=rngs, method=scene_stages))

    def run_stages(sup, scn):
        emb = embed(variables, sup)
        return jax.tree_util.tree_map(np.array, (emb, *run_scene(variables, emb, scn)))

    jemb, jcache, jdec, jprops = run_stages(support, scene)
    return dict(jcfg=jcfg, tcfg=tcfg, ds=ds, scene=scene, support=support, small=small,
                engine=engine, variables=variables, jm=jm, jemb=jemb, jcache=jcache, jdec=jdec,
                jprops=jprops, embed=lambda b: np.asarray(embed(variables, b)),
                stages=run_stages)


def test_fs_weights_map_every_leaf_both_ways(setup):
    """The port's tree has exactly the leaves (paths and shapes) of a JAX
    init, the 6m-wide projection and the similarity net included, and maps
    back onto the port's state_dict one to one (strict load)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    shapes = jax.eval_shape(lambda: setup["jm"].init(
        {"params": k1, "sample": k2, "dropout": k3}, setup["support"], setup["scene"],
        train=False))
    want = {jax.tree_util.keystr(p): s.shape for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_leaves_with_path(setup["variables"])}
    assert got == want
    m = setup["tcfg"].m
    assert setup["variables"]["params"]["encoder_to_decoder_projection"]["Dense_0"][
        "kernel"].shape == (6 * m, 6 * m)
    assert set(setup["variables"]["params"]["similarity_net"]) == {
        "Dense_0", "Dense_1", "Dense_2", "MaskedBatchNorm_0", "MaskedBatchNorm_1"}
    sd = from_jax_variables(setup["variables"])
    model = setup["engine"].model
    assert set(sd) == set(model.state_dict()) and len(sd) == len(want)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    Engine(setup["tcfg"], device="cpu", few_shot=True, state_dict=sd)  # strict load


@pytest.mark.parametrize("which", ["support", "small"])
def test_process_support_embedding(setup, which):
    """The 2m support embedding, also from a mask of 5 points (fewer than
    the 32 FPS picks, which then repeat): 1e-4."""
    batch = setup[which]
    n_mask = (batch["support_masks"] > 0).sum()
    assert n_mask == 5 if which == "small" else n_mask > 32
    got = setup["engine"].process_support(batch).numpy()
    want = setup["jemb"] if which == "support" else setup["embed"](batch)
    assert got.shape == want.shape == (1, 2 * setup["tcfg"].m)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 1e-2


def test_encode_scene(setup):
    got, want = setup["engine"].encode_scene(setup["scene"]), setup["jcache"]
    for k in CACHE_INT_KEYS + CACHE_EXACT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, v in want["voxel_stats"].items():
        np.testing.assert_array_equal(got["voxel_stats"][k].numpy(), v, err_msg=k)
    for k in CACHE_FLOAT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=0, err_msg=k)
    geo = got["geo_dist"].numpy()
    np.testing.assert_array_equal(geo < 0, want["geo_dist"] < 0)
    np.testing.assert_allclose(geo, want["geo_dist"], atol=1e-5, rtol=0)
    assert want["fg_valid"].sum() > 50 and (want["geo_dist"] > 0).mean() > 0.05


def test_decode_with_support(setup):
    """The decode on the JAX cache and embedding: similarity and mask logits
    to 1e-4 (BN in eval leaves finite values at invalid query rows too)."""
    model, scene = setup["engine"].model, setup["scene"]
    with torch.no_grad():
        got = model.decode_with_support(
            _torch_tree(setup["jcache"]), torch.from_numpy(setup["jemb"]),
            torch.from_numpy(scene["pc_mins"]), torch.from_numpy(scene["pc_maxs"]))
    want = setup["jdec"]
    assert got["mask_logits"].shape == want["mask_logits"].shape
    np.testing.assert_allclose(got["similarity"].numpy(), want["similarity"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["mask_logits"].numpy(), want["mask_logits"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["query_valid"].numpy(), want["query_valid"])


def test_generate_fs_proposal(setup):
    jdec, want = setup["jdec"], setup["jprops"]
    sim = 1.0 / (1.0 + np.exp(-jdec["similarity"]))
    got = generate_fs_proposal(
        torch.from_numpy(jdec["mask_logits"][-1]), torch.sigmoid(torch.from_numpy(jdec["similarity"])),
        torch.from_numpy(jdec["fg_idx"]), torch.from_numpy(jdec["fg_valid"]),
        torch.from_numpy(setup["scene"]["point_mask"]), logit_thresh=0.2,
        score_thresh=setup["tcfg"].TEST_SCORE_THRESH, npoint_thresh=setup["tcfg"].TEST_NPOINT_THRESH,
        sim_score_thresh=setup["tcfg"].similarity_thresh)
    near = _near_threshold_full(jdec["mask_logits"][-1], jdec["fg_idx"], want["masks"].shape[-1])
    assert not ((got["masks"].numpy() != want["masks"]) & ~near).any()
    sure = ~near.any(axis=-1) & (np.abs(sim - setup["tcfg"].similarity_thresh) > 1e-5)
    np.testing.assert_array_equal(got["keep"].numpy()[sure], want["keep"][sure])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-5, rtol=0)
    assert want["keep"].sum() >= 2 and want["masks"].any() and not want["masks"].all()


def test_engine_stages_end_to_end(setup):
    """The slice as a whole: support embedding -> cached scene -> decode ->
    proposals -> one-category matrix NMS through the Engine, against the JAX
    stages followed by test_fs.py's NMS. Also the model's own eval forward."""
    engine, want = setup["engine"], setup["jprops"]
    emb = engine.process_support(setup["support"])
    got = engine.decode_with_support(engine.encode_scene(setup["scene"]), emb)
    jkeep, _ = jax_matrix_nms(
        jnp.asarray(want["masks"][0]), jnp.asarray(want["scores"][0]),
        jnp.zeros(want["scores"][0].shape, jnp.int32), jnp.asarray(want["keep"][0]), sigma=2.0,
        final_score_thresh=setup["tcfg"].TEST_NMS_THRESH)
    jdec = setup["jdec"]
    near = _near_threshold_full(jdec["mask_logits"][-1], jdec["fg_idx"], want["masks"].shape[-1])
    assert not near.any(), "pick weights whose mask probabilities clear the threshold"
    np.testing.assert_array_equal(got["masks"].numpy(), want["masks"])
    np.testing.assert_array_equal(got["keep"][0].numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-5, rtol=0)
    assert np.asarray(jkeep).sum() >= 1

    with torch.no_grad():
        out = engine.model(engine.to_device(setup["support"]), engine.to_device(setup["scene"]))
    np.testing.assert_array_equal(out["proposals"]["masks"].numpy(), want["masks"])
    np.testing.assert_allclose(out["proposals"]["scores"].numpy(), want["scores"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["similarity"].numpy(), jdec["similarity"], atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        engine.eval_batch(setup["scene"])  # the supervised engine's entry


def test_load_set_support_k5_mean_embedding(setup, monkeypatch):
    """config/tiny_cpu_test_k5.yaml's protocol: k_shot=5 consumes five
    supports per (run, class) and keeps the mean of their embeddings, equal
    to the mean of the JAX embeddings of the same five (1e-4)."""
    assert jax_load_config("config/tiny_cpu_test_k5.yaml").k_shot == 5
    tcfg = setup["tcfg"].replace(k_shot=5, run_num=1)
    engine = Engine(tcfg, device="cpu", few_shot=True,
                    state_dict=setup["engine"].model.state_dict())
    ds = FSInstDataset(tcfg, "val")
    jds = JaxFSInstDataset(setup["jcfg"].replace(k_shot=5, run_num=1), "val")
    calls = []
    orig = FSInstDataset.support_batch
    monkeypatch.setattr(FSInstDataset, "support_batch",
                        lambda self, scene, inst: calls.append((scene, inst)) or orig(self, scene, inst))
    embs = cli_test_fs.load_set_support(engine, ds, create_logger(None, name="k5_test"))
    sets = jds.load_support_sets()
    assert len(embs) == 1 and set(embs[0]) == set(sets[0])
    assert calls == [tuple(t) for tuples in sets[0].values() for t in tuples[:5]]
    assert len(calls) == 5 * len(sets[0])
    cls0 = next(iter(sets[0]))
    want = np.mean([setup["embed"](jds.support_batch(s, i))[0] for s, i in sets[0][cls0]], axis=0)
    np.testing.assert_allclose(embs[0][cls0], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fix_support", [True, False])
def test_driver_runs_both_support_modes(setup, fix_support):
    """cli.test_fs.main from the command line on the CPU, to an AP table:
    frozen support sets (an embedding per run) and per-scene supports (one
    decode shared by every run)."""
    tcfg = setup["tcfg"]
    ckpt = os.path.join(tcfg.data_root, "fs.ckpt")
    save_jax_checkpoint(ckpt, setup["engine"].model)
    config = os.path.join(tcfg.data_root, f"fs_{fix_support}.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": dict({k: v for k, v in tcfg.to_dict().items() if k != "config"},
                                    fix_support=fix_support)}, f)
    summary = cli_test_fs.main(["--config", config, "--pretrain", ckpt, "--output_path",
                                tcfg.output_path, "--exp_name", f"fs_{fix_support}",
                                "--device", "cpu"])
    n_scenes = len(list(setup["ds"].test_batches()))
    assert len(summary["scenes"]) == n_scenes == len(summary["stage_ms"]["encode_scene"])
    n_decodes = sum(r["classes"] for r in summary["scenes"])
    assert len(summary["stage_ms"]["decode_with_support"]) == n_decodes * (
        tcfg.run_num if fix_support else 1)
    assert all(len(r["proposals_per_run"]) == tcfg.run_num for r in summary["scenes"])
    assert sum(sum(r["proposals_per_run"]) for r in summary["scenes"]) > 0
    if not fix_support:
        assert all(len(set(r["proposals_per_run"])) == 1 for r in summary["scenes"])
    avgs = summary["avgs"]
    assert all(np.isfinite(avgs[k]) for k in ("all_ap", "all_ap_50%", "all_ap_25%", "all_ap_std"))
    with pytest.raises(NotImplementedError):
        next(iter(setup["ds"].train_batches(1)))


def test_driver_matches_jax_protocol(setup):
    """cli.test_fs.main (frozen support sets, run_num=2, k_shot=1) against
    test_fs.py's protocol on the JAX stages over every val scene: per (class,
    run) the JAX proposals, a one-category matrix NMS, the raw-resolution
    projection, one ScanNetEval per run and average_over_runs. Proposals per
    scene and run and the whole AP table are equal."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    ckpt = os.path.join(tcfg.data_root, "fs_protocol.ckpt")
    save_jax_checkpoint(ckpt, setup["engine"].model)
    config = os.path.join(tcfg.data_root, "fs_protocol.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": {k: v for k, v in tcfg.to_dict().items() if k != "config"}}, f)
    summary = cli_test_fs.main(["--config", config, "--pretrain", ckpt, "--output_path",
                                tcfg.output_path, "--exp_name", "fs_protocol",
                                "--device", "cpu"])

    jds = JaxFSInstDataset(jcfg, "val")
    sets = jds.load_support_sets()[: jcfg.run_num]
    evaluators = [jax_scannet_eval.ScanNetEval(jcfg.cvfold) for _ in range(jcfg.run_num)]
    bench = np.asarray(JAX_BENCHMARK_LABELS)
    want_counts = []
    for scene_name, active, host_batch in jds.test_batches():
        raw = np.load(jds._scene_path(scene_name))
        n_points, n_raw, sel = jax_scene_alignment(host_batch)
        nn = jax_nn_projection(raw[:, :3], sel) if n_raw != n_points else None
        gt_ids = jax_make_gt_ids(raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32))
        counts = []
        for run_i, ev in enumerate(evaluators):
            preds = []
            for cls in active:
                _, _, _, props = setup["stages"](jds.support_batch(*sets[run_i][cls][0]),
                                                 host_batch)
                masks, scores = props["masks"][0], props["scores"][0]
                keep, _ = jax_matrix_nms(
                    jnp.asarray(masks), jnp.asarray(scores), jnp.zeros(scores.shape, jnp.int32),
                    jnp.asarray(props["keep"][0]), sigma=2.0,
                    final_score_thresh=jcfg.TEST_NMS_THRESH)
                for q in np.nonzero(np.asarray(keep))[0]:
                    mask = masks[q, :n_points]
                    preds.append((bench[cls], float(scores[q]),
                                  (mask[nn] if nn is not None else mask).astype(np.int32)))
            ev.assign_instances_for_scan(scene_name, {
                "label_id": np.asarray([p[0] for p in preds], np.int64),
                "conf": np.asarray([p[1] for p in preds], np.float64),
                "mask": [p[2] for p in preds]}, gt_ids)
            counts.append(len(preds))
        want_counts.append((scene_name, counts))
    want = jax_scannet_eval.average_over_runs([ev.compute_averages() for ev in evaluators])
    assert [(r["scene"], r["proposals_per_run"]) for r in summary["scenes"]] == want_counts
    assert sum(sum(c) for _, c in want_counts) > 0
    np.testing.assert_equal(summary["avgs"], want)


def test_scannet_fs_eval_config_matches_yaml():
    """The Python-built few-shot config == the YAML through the JAX loader."""
    got = scannet_fs_eval_config().to_dict()
    want = jax_load_config("config/test_geoformer_fs_scannet.yaml").to_dict()
    got.pop("config"), want.pop("config")
    assert got == want
    assert (ModelConfig.from_cfg(scannet_fs_eval_config()).__dict__ == JaxModelConfig.from_cfg(
        jax_load_config("config/test_geoformer_fs_scannet.yaml")).__dict__)
