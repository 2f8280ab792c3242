"""The port's supervised eval driver (cli/test.py) and its host modules vs
the JAX package, on one synthetic dataset read by both.

tools/make_synthetic_data.py writes 8 scenes of 800 points; at
tests/conftest.py:tiny_cfg (512-point capacity) every scene is subsampled by
``pad_scene``'s seeded draw, so the padded batches exercise the RNG order and
the raw-resolution projection. Host code is numpy on both sides: batches, gt
ids, projected masks and AP averages are exactly equal. The forward's
proposals go through both packages' ``proposals_to_pred_info`` on the same
weights: label ids and masks exactly equal, confidences to 1e-5 (f32 sums
reassociated between XLA and PyTorch). The score and size thresholds are
lowered on both sides so that proposals survive the random weights.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from geoformer_tpu.data.episodic import FSInstDataset as JaxFSInstDataset
from geoformer_tpu.data.scannet import InstDataset as JaxInstDataset
from geoformer_tpu.engine import Engine as JaxEngine
from geoformer_tpu.evaluation import gt as jax_gt
from geoformer_tpu.evaluation import predictions as jax_predictions
from geoformer_tpu.evaluation import scannet_eval as jax_scannet_eval
from geoformer_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from geoformer_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from geoformer_tpu_torch.cli import test as cli_test
from geoformer_tpu_torch.config import config_from_args, load_config
from geoformer_tpu_torch.data.episodic import FSInstDataset
from geoformer_tpu_torch.data.scannet import InstDataset
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.evaluation import gt, predictions, scannet_eval
from geoformer_tpu_torch.weights import (
    from_jax_variables,
    load_jax_checkpoint,
    random_state_dict,
    save_jax_checkpoint,
    to_jax_variables,
)
from tools.make_synthetic_data import main as make_synthetic_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_test_driver():
    """The root test.py as a module (its name shadows the stdlib's ``test``)."""
    spec = importlib.util.spec_from_file_location("jax_test_driver", os.path.join(REPO, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nontrivial_state_dict(model, seed):
    """Seeded weights with non-trivial BN statistics, norm parameters and
    biases; the semantic head, the class head and the controller are widened
    so that classes vary over points and queries and the dynamic masks fill."""
    rng = np.random.default_rng(seed)
    sd = random_state_dict(model, seed)
    for key, t in sd.items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight" and key.startswith(("semantic.", "detr_sem_head.Dense_2.",
                                                "controller_head.controller.")):
            sd[key] = t * 10.0
        elif name in ("mean", "bias"):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, t.shape).astype(np.float32))
        elif name in ("var", "scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
    sd["semantic.Dense_2.bias"][:4] -= 1.0  # background classes down: a foreground exists
    return sd


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def cfgs(tiny_cfg, tmp_path_factory):
    """(JAX cfg, port cfg) with the same values over one synthetic dataset."""
    root = str(tmp_path_factory.mktemp("driver_data"))
    make_synthetic_data(root=root, n_scenes=8, n_points=800, seed=0)
    jcfg = tiny_cfg.replace(
        data_root=root, tpu_brick_occupancy=0, cvfold=0, split="val", TEST_SCORE_THRESH=0.0,
        TEST_NPOINT_THRESH=10, TEST_NMS_THRESH=1e-4, output_path=os.path.join(root, "exp"),
        # a two-level U-Net: the driver's protocol, not the model's depth, is
        # what this file holds (test_torch_slice.py holds the forward at
        # three levels), and the smaller graph traces and compiles faster
        tpu_unet_depth=2)
    values = {k: v for k, v in jcfg.to_dict().items() if k != "config"}
    return jcfg, load_config(None, **values)


@pytest.mark.parametrize("max_points", [512, 1024])
def test_inst_dataset_batches_bit_equal(cfgs, max_points):
    """InstDataset.test_batches: over capacity (seeded subsample) and under
    it (zero padding), every array of every scene equal, dtypes included."""
    jcfg, tcfg = (c.replace(tpu_max_points=max_points) for c in cfgs)
    want = list(JaxInstDataset(jcfg, "val").test_batches())
    got = list(InstDataset(tcfg, "val").test_batches())
    assert [n for n, _ in got] == [n for n, _ in want] and len(want) == 4
    for (_, g), (_, w) in zip(got, want):
        _assert_batches_equal(g, w)
        assert (w["n_raw"] > w["n_points"]).all() == (max_points == 512)


@pytest.mark.parametrize("fix_support", [True, False])
def test_fs_dataset_batches_bit_equal(cfgs, fix_support):
    """FSInstDataset.test_batches and support_batch (the full scene when
    fix_support, the instance's region crop otherwise)."""
    jcfg, tcfg = (c.replace(fix_support=fix_support) for c in cfgs)
    jds, tds = JaxFSInstDataset(jcfg, "val"), FSInstDataset(tcfg, "val")
    want, got = list(jds.test_batches()), list(tds.test_batches())
    assert [(n, a) for n, a, _ in got] == [(n, a) for n, a, _ in want] and want
    for (_, _, g), (_, _, w) in zip(got, want):
        _assert_batches_equal(g, w)
    assert tds.load_test_combinations() == jds.load_test_combinations()
    assert tds.load_support_sets() == jds.load_support_sets()
    for cls in (2, 3, 4):
        scene, inst = tds.class2instances[cls][0]
        w = jds.support_batch(scene, inst)
        _assert_batches_equal(tds.support_batch(scene, inst), w)
        assert w["support_masks"].sum() > 0
        assert (w["n_raw"][0] == 800) == fix_support


def test_gt_ids_and_raw_projection_equal(cfgs):
    jcfg, tcfg = cfgs
    ds = InstDataset(tcfg, "val")
    rng = np.random.default_rng(0)
    for i, (_, batch) in enumerate(ds.test_batches()):
        raw = np.load(ds.file_names[i])
        labels, inst = raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32)
        np.testing.assert_array_equal(gt.make_gt_ids(labels, inst),
                                      jax_gt.make_gt_ids(labels, inst))
        masks = rng.random((5, 512)) < 0.3
        got = predictions.masks_to_raw(masks, batch, raw[:, :3])
        assert got.shape == (5, 800)
        np.testing.assert_array_equal(got, jax_predictions.masks_to_raw(masks, batch, raw[:, :3]))
        scores = rng.normal(size=(512, 13)).astype(np.float32)
        np.testing.assert_array_equal(predictions.labels_to_raw(scores, batch, raw[:, :3]),
                                      jax_predictions.labels_to_raw(scores, batch, raw[:, :3]))


def _handmade_predictions(gt_ids, rng, valid_ids):
    """Noisy copies of the gt instances (some mislabelled, some duplicated,
    one void blob), so that matches, duplicates and false positives occur."""
    label_id, conf, masks = [], [], []
    for inst_id in np.unique(gt_ids[gt_ids > 0]):
        for _ in range(rng.integers(1, 3)):
            mask = (gt_ids == inst_id) & (rng.random(gt_ids.shape) < rng.uniform(0.5, 1.0))
            mask |= rng.random(gt_ids.shape) < 0.05
            label = inst_id // 1000 if rng.random() < 0.8 else rng.choice(valid_ids)
            label_id.append(label), conf.append(rng.random()), masks.append(mask.astype(np.int32))
    label_id.append(valid_ids[0]), conf.append(0.5), masks.append((gt_ids == 0).astype(np.int32))
    return {"label_id": np.asarray(label_id), "conf": np.asarray(conf), "mask": np.stack(masks)}


@pytest.mark.parametrize("cvfold", [0, 1])
def test_scannet_eval_averages_equal(cfgs, cvfold):
    """ScanNetEval on hand-made predictions: AP table and averages equal
    (NaN where a class has no gt), and the mean and std over two runs."""
    ds = InstDataset(cfgs[1], "val")
    rng = np.random.default_rng(cvfold)
    runs = []
    for _ in range(2):
        ev, jev = scannet_eval.ScanNetEval(cvfold), jax_scannet_eval.ScanNetEval(cvfold)
        for path in ds.file_names:
            raw = np.load(path)
            gt_ids = gt.make_gt_ids(raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32))
            pred = _handmade_predictions(gt_ids, rng, ev.valid_class_ids)
            ev.assign_instances_for_scan(os.path.basename(path), pred, gt_ids)
            jev.assign_instances_for_scan(os.path.basename(path), pred, gt_ids)
        np.testing.assert_array_equal(ev.evaluate_matches(), jev.evaluate_matches())
        runs.append((ev.compute_averages(), jev.compute_averages()))
        np.testing.assert_equal(*runs[-1])
        assert 0.0 < runs[-1][0]["all_ap_25%"] < 1.0
    np.testing.assert_equal(scannet_eval.average_over_runs([r[0] for r in runs]),
                            jax_scannet_eval.average_over_runs([r[1] for r in runs]))


@pytest.fixture(scope="module")
def forward(cfgs):
    """One set of weights in both packages, the JAX eval forward per val
    scene with test.py's post-processing, and the port's driver run from the
    command line on a checkpoint file that the JAX package wrote."""
    jcfg, tcfg = cfgs
    engine = Engine(tcfg, device="cpu")
    engine.model.load_state_dict(_nontrivial_state_dict(engine.model, seed=15))
    variables = to_jax_variables(engine.model)
    ckpt = os.path.join(jcfg.data_root, "weights.ckpt")
    jax_save_checkpoint(ckpt, dict(variables, epoch=1))

    jdriver = _jax_test_driver()
    jengine = JaxEngine(jcfg, few_shot=False)
    jds = JaxInstDataset(jcfg, "val")
    jev = jax_scannet_eval.ScanNetEval(jcfg.cvfold)
    scenes = []
    for i, (name, batch) in enumerate(jds.test_batches()):
        out = jengine.eval_batch(variables, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))
        raw = np.load(jds.file_names[i])
        pred = jdriver.proposals_to_pred_info(jcfg, jax.device_get(out["proposals"]), batch,
                                              raw[:, :3])
        jev.assign_instances_for_scan(
            name, pred, jax_gt.make_gt_ids(raw[:, 6].astype(np.int32), raw[:, 7].astype(np.int32)))
        scenes.append((name, batch, raw, pred))

    config = os.path.join(jcfg.data_root, "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": dict({k: v for k, v in tcfg.to_dict().items() if k != "config"},
                                    save_instance=True)}, f)
    argv = ["--config", config, "--pretrain", ckpt, "--output_path", jcfg.output_path,
            "--exp_name", "port_test"]
    summary = cli_test.main(argv + ["--device", "cpu"])
    return dict(engine=engine, variables=variables, ckpt=ckpt, scenes=scenes,
                javgs=jev.compute_averages(), summary=summary, argv=argv)


def test_checkpoint_files_cross_both_packages(forward, tmp_path):
    """A checkpoint written by the JAX package loads strictly into the port;
    one written by the port restores in the JAX package with the same leaves."""
    model = forward["engine"].model
    sd = load_jax_checkpoint(forward["ckpt"])
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert from_jax_variables(forward["variables"]).keys() == sd.keys()
    path = str(tmp_path / "port.ckpt")
    save_jax_checkpoint(path, model, epoch=7)
    restored = jax_load_checkpoint(path)
    assert restored["epoch"] == 7
    want = jax.tree_util.tree_leaves_with_path(forward["variables"])
    got = jax.tree_util.tree_leaves_with_path({c: restored[c] for c in forward["variables"]})
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))


def test_proposals_to_pred_info_equal(cfgs, forward):
    """Port forward + NMS + proposals_to_pred_info vs test.py's on the same
    weights: label ids and raw-resolution masks exact, confidences 1e-5."""
    n_kept = 0
    for name, batch, raw, want in forward["scenes"]:
        out = forward["engine"].eval_batch(batch)
        got = cli_test.proposals_to_pred_info(
            cfgs[1], cli_test.to_numpy(out["proposals"]), out["nms"]["keep"].numpy(), batch,
            raw[:, :3])
        np.testing.assert_array_equal(got["label_id"], want["label_id"], err_msg=name)
        np.testing.assert_array_equal(got["mask"], want["mask"], err_msg=name)
        assert got["mask"].dtype == want["mask"].dtype and got["mask"].shape[1] == 800
        np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5, rtol=0)
        n_kept += len(want["conf"])
    assert n_kept >= 8, "the test weights should let proposals survive"


def test_driver_ap_equals_jax_and_writes_predictions(cfgs, forward):
    """cli.test.main from the command line: the AP averages of test.py's
    protocol on the same checkpoint, and save_instance files that read back
    as the predictions."""
    summary = forward["summary"]
    np.testing.assert_equal(summary["avgs"], forward["javgs"])
    assert [r["scene"] for r in summary["scenes"]] == [s[0] for s in forward["scenes"]]
    assert [r["proposals"] for r in summary["scenes"]] == [len(s[3]["conf"])
                                                           for s in forward["scenes"]]
    result = os.path.join(cfgs[1].output_path, "port_test", "result")
    for name, _, _, want in forward["scenes"]:
        got = gt.load_benchmark_predictions(os.path.join(result, f"{name}.txt"))
        np.testing.assert_array_equal(got["label_id"], want["label_id"])
        np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-4, rtol=0)  # 4 decimals
        np.testing.assert_array_equal(np.reshape(got["mask"], want["mask"].shape), want["mask"])


def test_driver_groups_scenes_like_single(cfgs, forward):
    """test_batch_size=3 over 4 scenes (the last group padded by repeating
    its scene) gives the same per-scene proposals and AP."""
    jcfg, tcfg = cfgs
    config = os.path.join(jcfg.data_root, "tiny_g3.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": dict({k: v for k, v in tcfg.to_dict().items() if k != "config"},
                                    test_batch_size=3)}, f)
    argv = ["--config", config, "--pretrain", forward["ckpt"], "--output_path",
            jcfg.output_path, "--exp_name", "port_test_g3", "--device", "cpu"]
    summary = cli_test.main(argv)
    single = forward["summary"]
    assert [(r["scene"], r["proposals"]) for r in summary["scenes"]] == [
        (r["scene"], r["proposals"]) for r in single["scenes"]]
    np.testing.assert_equal(summary["avgs"], single["avgs"])


def test_driver_options(forward):
    """The command line of test.py plus --device; what is not ported raises."""
    cfg = config_from_args(forward["argv"] + ["--resume", "x", "--threshold", "0.3",
                                              "--use_backbone", "--device", "cpu"])
    assert (cfg.pretrain, cfg.resume, cfg.device) == (forward["ckpt"], "x", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config_from_args(forward["argv"])  # no device named and no card
    assert cfg.exp_name == "port_test" and cfg.m == 4
    with pytest.raises(ValueError):
        cli_test.main(forward["argv"][:2] + ["--device", "cpu"])  # no checkpoint
    ds = InstDataset(cfg, "val")
    with pytest.raises(NotImplementedError):
        next(iter(ds.train_batches(1)))
    with pytest.raises(NotImplementedError):
        ds.build_scene(0, np.random.default_rng(0), True)
