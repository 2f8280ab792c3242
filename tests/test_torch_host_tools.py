"""The port's host-side modules vs the JAX package: the native host ops
(geoformer_tpu_torch/native.py, csrc/host_ops.cpp), the elastic
augmentation on them, the PLY/OBJ exports (utils/visualize.py), the
profiler trace and step timer (utils/tracking.py), the importer of upstream
PyTorch checkpoints (tools/convert_reference_checkpoint.py,
weights.from_reference_state_dict) and cli.test with ``save_semantic`` and
``--profile_dir``.

Everything here is exact:

* the port's native library against the JAX package's, its C++ built here
  by the JAX package's own build at the same flags (the binary committed
  beside that source was built on another CPU, with other vector code, and
  rounds the elastic displacement differently), and the port's numpy
  fallbacks against the JAX package's; the port's ``elastic`` against
  JAX's on the same seed, on either path;
* the export files against JAX's, byte for byte;
* the importer's state_dict against JAX's ``convert`` + ``from_jax_variables``
  leaf by leaf, on tests/test_converter.py's fake reference state_dict
  (supervised, and few-shot with the few-shot heads' keys), and the msgpack
  its ``main`` writes from a ``torch.save``d .pth, read back by both
  packages, loading strictly into the port's model.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import geoformer_tpu.native as jax_native
from geoformer_tpu.data.augment import elastic as jax_elastic
from geoformer_tpu.utils import tracking as jax_tracking
from geoformer_tpu.utils import visualize as jax_visualize
from geoformer_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from geoformer_tpu.utils.config import load_config as jax_load_config
from geoformer_tpu_torch import native
from geoformer_tpu_torch.cli import test as cli_test
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.data.augment import elastic
from geoformer_tpu_torch.data.scannet import InstDataset
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.evaluation.gt import load_benchmark_predictions
from geoformer_tpu_torch.evaluation.predictions import labels_to_raw
from geoformer_tpu_torch.synthetic import write_dataset
from geoformer_tpu_torch.tools import convert_reference_checkpoint as importer
from geoformer_tpu_torch.utils import tracking, visualize
from geoformer_tpu_torch.weights import (
    from_jax_variables,
    from_reference_state_dict,
    load_jax_checkpoint,
    read_msgpack,
    save_jax_checkpoint,
)
from tests.test_converter import _fake_reference_sd
from tools.convert_reference_checkpoint import convert as jax_convert

# ---------------- native host ops ----------------


@pytest.fixture
def jax_lib_built_here(tmp_path, monkeypatch):
    """The JAX package's native library, built from its source by its own
    build step (its g++ flags) into tmp_path."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(tmp_path / "_host_ops.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    assert jax_native.get_lib() is not None
    yield
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


@pytest.fixture
def numpy_paths(monkeypatch):
    """Both packages on their numpy/scipy fallbacks."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()


def _host_op_calls():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 16, size=(500, 3)).astype(np.int32)
    batch = rng.integers(0, 3, 500).astype(np.int32)
    noise = rng.standard_normal((3, 9, 7, 5)).astype(np.float32)
    pts = ((rng.random((400, 3)) - 0.5) * 30).astype(np.float32)  # some out of bounds
    return [("voxelize_idx", (coords,), {"spatial": 32}),
            ("voxelize_idx", (coords, batch), {"spatial": 32}),
            ("voxel_rulebook", (rng.integers(0, 40, 300).astype(np.int32), 40, 4), {}),
            ("elastic_blur", (noise,), {}),
            ("trilinear_gather", (noise, 3.0, pts), {})]


def _assert_same(got, want):
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_native_library_matches_jax_native(jax_lib_built_here):
    assert native.available()
    assert os.path.dirname(native.library_path()).endswith("build")
    for name, args, kw in _host_op_calls():
        _assert_same(getattr(native, name)(*args, **kw), getattr(jax_native, name)(*args, **kw))


def test_numpy_fallbacks_match_jax_fallbacks(numpy_paths):
    for name, args, kw in _host_op_calls():
        _assert_same(getattr(native, name)(*args, **kw), getattr(jax_native, name)(*args, **kw))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_elastic_matches_jax(path, request):
    """The augmentation's two elastic passes on a room-sized cloud, the same
    seed through both packages."""
    request.getfixturevalue("jax_lib_built_here" if path == "native" else "numpy_paths")
    assert native.available() == (path == "native")
    x = np.random.default_rng(2).random((3000, 3)) * 150
    outs = []
    for fn in (elastic, jax_elastic):
        rng = np.random.default_rng(3)
        y = fn(x, 6, 40.0, rng)
        outs.append(fn(y, 20, 160.0, rng))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - x).max() > 1.0


# ---------------- visualization and tracking ----------------


def _export(mod, out_dir):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    sem = rng.integers(-1, 25, 300)
    masks = rng.random((5, 300)) > 0.7
    masks[2] = False  # an empty proposal: no box
    mod.export_scene_predictions(out_dir, "scene0000_00", xyz, sem, masks)
    mod.export_scene_predictions(out_dir, "scene0001_00", xyz, sem, None)
    mod.write_obj(os.path.join(out_dir, "cloud.obj"), xyz, mod.color_instances(sem))
    mod.visualize_pts_rgb(xyz, rng.uniform(-1, 1, (300, 3)), os.path.join(out_dir, "rgb.ply"))


def test_exports_byte_equal_to_jax(tmp_path):
    _export(visualize, str(tmp_path / "port"))
    _export(jax_visualize, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    np.testing.assert_array_equal(visualize.PALETTE, jax_visualize.PALETTE)


def test_step_timer_and_profile_trace(tmp_path):
    timers = [tracking.StepTimer(), jax_tracking.StepTimer()]
    for t in timers:
        for name in ("load", "step", "step"):
            with t.phase(name):
                pass
    assert [t.counts for t in timers] == [{"load": 1, "step": 2}] * 2
    assert timers[0].summary().startswith("load=") and " step=" in timers[0].summary()
    with tracking.profile_trace(str(tmp_path), name="trace_rank0"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with tracking.profile_trace(None):  # disabled: nothing written
        pass
    assert os.listdir(tmp_path) == ["trace_rank0.json"]


# ---------------- upstream checkpoint importer ----------------


def _fs_reference_sd(cfg):
    """The fake reference state_dict with the few-shot model's heads: the
    encoder projection at 3x the aggregator width, a similarity net, no
    supervised class head."""
    sd = {k: v for k, v in _fake_reference_sd(cfg).items() if not k.startswith(
        ("detr_sem_head.", "encoder_to_decoder_projection."))}
    rng = np.random.default_rng(1)
    agg, dec = 3 * 2 * cfg.m, cfg.dec_dim

    def w(key, *shape):
        sd[key] = rng.normal(size=shape).astype(np.float32)

    def bn(prefix, c):
        for n in ("weight", "bias", "running_mean"):
            w(f"{prefix}.{n}", c)
        sd[f"{prefix}.running_var"] = np.abs(rng.normal(size=c)).astype(np.float32) + 0.5

    w("encoder_to_decoder_projection.layers.0.weight", agg, agg, 1)
    bn("encoder_to_decoder_projection.layers.1", agg)
    w("encoder_to_decoder_projection.layers.3.weight", dec, agg, 1)
    bn("encoder_to_decoder_projection.layers.4", dec)
    for i, (cin, cout) in zip((0, 3, 6), ((agg, agg), (agg, agg), (agg, 1))):
        w(f"similarity_net.{i}.weight", cout, cin)
        w(f"similarity_net.{i}.bias", cout)
    bn("similarity_net.1", agg)
    bn("similarity_net.4", agg)
    return sd


@pytest.fixture(scope="module")
def cfgs(tiny_cfg):
    jcfg = tiny_cfg.replace(tpu_unet_depth=2)
    return jcfg, load_config(None, **{k: v for k, v in jcfg.to_dict().items() if k != "config"})


@pytest.mark.parametrize("case", [("xyz", False, False), ("zyx", True, False),
                                  ("xyz", False, True)])
def test_importer_matches_jax_convert(cfgs, case):
    kernel_order, mirror, few_shot = case
    jcfg, tcfg = cfgs
    sd = (_fs_reference_sd if few_shot else _fake_reference_sd)(jcfg)
    params, stats, consts = jax_convert(sd, jcfg, kernel_order, mirror, few_shot)
    want = from_jax_variables({"params": params, "batch_stats": stats, "constants": consts})
    got = from_reference_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
                                    kernel_order, mirror, few_shot)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = Engine(tcfg, device="cpu", few_shot=few_shot).model
    model.load_state_dict(got, strict=True)
    assert ("similarity_net.Dense_0.weight" in got) == few_shot


def test_importer_main_writes_what_both_packages_read(cfgs, tmp_path):
    """A torch.save'd .pth ({'state_dict', 'epoch'}) through the port's
    command line: the msgpack it writes reads back as JAX's convert tree,
    in the port (strict) and in the JAX package."""
    jcfg, tcfg = cfgs
    sd = _fake_reference_sd(jcfg)
    pth = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, pth)
    config = str(tmp_path / "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": {k: v for k, v in tcfg.to_dict().items() if k != "config"}}, f)
    out = importer.main(["--torch_ckpt", pth, "--config", config,
                         "--out", str(tmp_path / "converted.ckpt"), "--kernel_order", "zyx"])
    params, stats, consts = jax_convert(sd, jcfg, "zyx")
    want = {"params": params, "batch_stats": stats, "constants": consts, "epoch": 3}
    for tree in (read_msgpack(out), jax_load_checkpoint(out)):
        flat_got, flat_want = (dict(_leaves(t)) for t in (tree, want))
        assert list(flat_got) == list(flat_want)
        for k, v in flat_want.items():
            np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg=k)
            assert np.asarray(flat_got[k]).dtype == np.asarray(v).dtype, k
    Engine(tcfg, device="cpu").model.load_state_dict(load_jax_checkpoint(out), strict=True)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


# ---------------- cli.test: save_semantic, --profile_dir ----------------


def test_cli_test_save_semantic_and_profile_dir(cfgs, tmp_path):
    """cli.test on the tiny config with save_semantic: True, from its
    command line with --profile_dir: the result
    directory holds the PLY/OBJ exports of every val scene, byte for byte
    what the JAX package's writer makes of the run's semantic argmax (the
    port's forward on the same checkpoint) and its saved proposal masks; the
    profile directory holds the run's Chrome trace."""
    _, tcfg = cfgs
    root = str(tmp_path / "data")
    write_dataset(root, n_scenes=4, n_points=700, seed=0)
    cfg = tcfg.replace(data_root=root, split="val", TEST_SCORE_THRESH=0.0,
                       TEST_NPOINT_THRESH=10, TEST_NMS_THRESH=1e-4, save_instance=True,
                       save_semantic=True)
    engine = Engine(cfg, device="cpu", seed=5)
    with torch.no_grad():  # a foreground, so that proposals and boxes exist
        engine.model.semantic.Dense_2.bias[4] += 3.0
    ckpt = str(tmp_path / "w.ckpt")
    save_jax_checkpoint(ckpt, engine.model)
    config = str(tmp_path / "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ALL": {k: v for k, v in cfg.to_dict().items() if k != "config"}}, f)
    prof = str(tmp_path / "prof")
    summary = cli_test.main(["--config", config, "--pretrain", ckpt, "--output_path",
                             str(tmp_path / "exp"), "--exp_name", "sem", "--device", "cpu",
                             "--profile_dir", prof])
    result = tmp_path / "exp" / "sem" / "result"
    ds = InstDataset(cfg, "val")
    assert len(summary["scenes"]) == len(ds.file_names) == 2
    n_boxes = 0
    for i, (name, batch) in enumerate(ds.test_batches()):
        raw = np.load(ds.file_names[i])
        scores = engine.eval_batch(batch)["semantic_scores"].numpy()
        sem = labels_to_raw(scores[0], batch, raw[:, :3]).argmax(-1)
        assert summary["scenes"][i]["semantic_digest"] == cli_test.label_digest(sem)
        masks = np.asarray(load_benchmark_predictions(str(result / f"{name}.txt"))["mask"],
                           bool).reshape(-1, len(raw))
        want_dir = tmp_path / "jax_export"
        jax_visualize.export_scene_predictions(str(want_dir), name, raw[:, :3], sem, masks)
        for f in os.listdir(want_dir):
            if f.startswith(name):
                assert (result / f).read_bytes() == (want_dir / f).read_bytes(), f
        n_boxes += len(masks)
    assert n_boxes > 0
    with open(os.path.join(prof, "trace_rank0.json")) as f:
        assert len(json.load(f)["traceEvents"]) > 100
