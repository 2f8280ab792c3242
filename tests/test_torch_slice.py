"""The port's supervised eval forward vs the JAX GeoFormer, stage by stage.

Both packages run on the CPU at tests/conftest.py:tiny_cfg with the
rulebook sparse conv (tpu_brick_occupancy=0: bricks equal the rulebook path
only while no brick overflows), on the same weights: seeded in the port,
carried to JAX by weights.to_jax_variables and back by
weights.from_jax_variables. The JAX forward and its stages run once per
module (one jit); each stage of the port gets the JAX stage's inputs, so a
stage is held on its own. Tolerances:

* float outputs after the U-Net and the heads: 1e-4 (f32 sums reassociated
  through 3 U-Net levels and the decoder);
* the geodesic table: 1e-5, with the -1 (unreached) pattern exactly equal;
* every integer output (fg indices, context indices, kNN ids, counters,
  proposal classes/keep) exactly equal; proposal masks exactly equal except
  where JAX's sigmoid lies within 1e-5 of 0.5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.models.geoformer import GeoFormer as JaxGeoFormer
from geoformer_tpu.models.geoformer import ModelConfig as JaxModelConfig
from geoformer_tpu.ops.nms import matrix_nms as jax_matrix_nms
from geoformer_tpu.ops.radius_graph import radius_knn as jax_radius_knn
from geoformer_tpu.utils.config import load_config as jax_load_config
from geoformer_tpu_torch.config import load_config, scannet_eval_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
from geoformer_tpu_torch.ops.nms import matrix_nms
from geoformer_tpu_torch.ops.radius_graph import radius_knn
from geoformer_tpu_torch.synthetic import room_points
from geoformer_tpu_torch.weights import from_jax_variables, random_state_dict, to_jax_variables


def _batch(cfg, seed=0):
    """Two dense room scans shrunk to ~0.5 m (2 cm spacing at 512 points),
    so the radius graph and the geodesic field have real work."""
    rng = np.random.default_rng(seed)
    p, b = cfg.tpu_max_points, cfg.batch_size
    pts = np.stack([room_points(rng, p) * 0.35 + 0.1 for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, -40:] = False
    return {
        "points": pts,
        "feats": rng.normal(size=(b, p, 3)).astype(np.float32),
        "coords": np.floor(pts * cfg.scale).astype(np.int32),
        "point_mask": mask,
        "pc_mins": pts.min(1),
        "pc_maxs": pts.max(1),
    }


def _perturbed(model, seed=1):
    """Seeded weights with non-trivial BN statistics and norm parameters
    (random_state_dict leaves them 0/1), the background classes 0-3 of the
    semantic head biased down so that a foreground exists, and a controller
    wide enough that the dynamic masks are not empty."""
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


def _jit_exact(f, *args):
    """f(*args) compiled by XLA without backend optimisation: one program,
    with the rounding of op-by-op execution (no contracted multiply-adds)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(tpu_brick_occupancy=0)
    nb = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    model = GeoFormer(ModelConfig.from_cfg(cfg)).eval()
    model.load_state_dict(_perturbed(model))
    variables = to_jax_variables(model)
    sd = from_jax_variables(variables)
    model.load_state_dict(sd, strict=True)

    jm = JaxGeoFormer(JaxModelConfig.from_cfg(cfg))
    rngs = {"sample": jax.random.split(jax.random.PRNGKey(0), 3)[1]}

    def apply(method, *args):
        return jax.tree_util.tree_map(np.array, _jit_exact(
            lambda v, *a: jm.apply(v, *a, rngs=rngs, method=method), variables, *args))

    jout = apply(lambda m, b: m(b, train=False), jb)
    point_feats, _, _, jstats = apply(lambda m, b: m.forward_backbone(b, False), jb)
    fg_idx, fg_valid = jout["fg_idx"], jout["fg_valid"]
    fg_locs = np.take_along_axis(nb["points"], fg_idx[..., None], axis=1)
    fg_feats = np.take_along_axis(point_feats, fg_idx[..., None], axis=1)
    jagg = apply(lambda m, *a: m.forward_aggregator(*a, False), fg_locs, fg_feats, fg_valid)
    jgeo = apply(lambda m, *a: m.forward_geodesic(*a, False), fg_locs, fg_valid, jagg[2], jagg[3])
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["coords"] = tb["coords"].long()
    with torch.no_grad():
        tout = model(tb)
    return dict(cfg=cfg, nb=nb, jb=jb, jm=jm, tb=tb, variables=variables, sd=sd, model=model,
                jout=jout, jstats=jstats, fg_locs=fg_locs, fg_feats=fg_feats, jagg=jagg, jgeo=jgeo,
                tout=tout)


def test_weights_use_every_leaf_both_ways(setup):
    """The port's tree has exactly the leaves (paths and shapes) of a JAX
    init, every JAX leaf maps to one state_dict entry and every port
    parameter and buffer is set by one (strict load in the fixture), and
    the round trip through the JAX tree changes no value."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    shapes = jax.eval_shape(lambda: setup["jm"].init(
        {"params": k1, "sample": k2, "dropout": k3}, setup["jb"], train=False))
    want_tree = {jax.tree_util.keystr(p): s.shape
                 for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got_tree = {jax.tree_util.keystr(p): a.shape
                for p, a in jax.tree_util.tree_leaves_with_path(setup["variables"])}
    assert got_tree == want_tree
    assert len(setup["sd"]) == len(want_tree)
    assert set(setup["sd"]) == set(setup["model"].state_dict())
    want = _perturbed(GeoFormer(ModelConfig.from_cfg(setup["cfg"])))
    assert all(torch.equal(setup["sd"][k], v) for k, v in want.items())


def test_backbone_semantic_scores(setup):
    """The U-Net + semantic head (JAX semantic_only) agree to 1e-4."""
    got = setup["tout"]["semantic_scores"].numpy()
    want = setup["jout"]["semantic_scores"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_voxel_stats_equal(setup):
    tstats = setup["tout"]["voxel_stats"]
    for k, v in setup["jout"]["voxel_stats"].items():
        np.testing.assert_array_equal(_np(tstats[k]), v, err_msg=k)
    with torch.no_grad():
        _, _, _, stats = setup["model"].forward_backbone(setup["tb"])
    for k, v in setup["jstats"].items():
        np.testing.assert_array_equal(_np(stats[k]), v, err_msg=k)


def test_foreground_pack_equal(setup):
    np.testing.assert_array_equal(setup["tout"]["fg_idx"].numpy(), setup["jout"]["fg_idx"])
    np.testing.assert_array_equal(setup["tout"]["fg_valid"].numpy(), setup["jout"]["fg_valid"])
    assert setup["jout"]["fg_valid"].sum() > 0


def test_aggregator_context(setup):
    """FPS + ball group + SharedMLP on the JAX stage inputs: context indices
    and validity exactly equal, features to 1e-4."""
    with torch.no_grad():
        locs, feats, inds, valid = setup["model"].forward_aggregator(
            torch.from_numpy(setup["fg_locs"]), torch.from_numpy(setup["fg_feats"]),
            torch.from_numpy(setup["jout"]["fg_valid"].copy()))
    jlocs, jfeats, jinds, jvalid = setup["jagg"]
    np.testing.assert_array_equal(inds.numpy(), jinds)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(locs.numpy(), jlocs)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-4, rtol=0)


def test_radius_graph_at_model_settings(setup):
    """The kNN table the geodesic solve reads: d2 and ids exactly equal."""
    mc = setup["model"].mc
    k = min(mc.knn_neighbors, max(mc.geodesic_fine_k, mc.geodesic_k_sub))
    args = (mc.geodesic_radius, k)
    kw = dict(cell_cap=mc.radius_cell_cap, cell_div=mc.radius_cell_div,
              dense_grid=mc.knn_dense_grid, select=mc.knn_select)
    jd, ji, jdrop, _ = _jit_exact(lambda p, m: jax_radius_knn(p, m, *args, with_stats=True, **kw),
                                  jnp.asarray(setup["fg_locs"]),
                                  jnp.asarray(setup["jout"]["fg_valid"]))
    td, ti, tdrop, _ = radius_knn(torch.from_numpy(setup["fg_locs"]),
                                  torch.from_numpy(setup["jout"]["fg_valid"]), *args, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    assert (np.asarray(ji) < ji.shape[1]).any(), "the test graph needs edges"


def test_geodesic_table(setup):
    """Two-level geodesic on the JAX stage inputs: 1e-5, -1 pattern equal."""
    _, _, jinds, jvalid = setup["jagg"]
    with torch.no_grad():
        geo, ovf, wovf = setup["model"].forward_geodesic(
            torch.from_numpy(setup["fg_locs"]), torch.from_numpy(setup["jout"]["fg_valid"]),
            torch.from_numpy(jinds), torch.from_numpy(jvalid))
    jgeo, jovf, jwovf = setup["jgeo"]
    geo = geo.numpy()
    np.testing.assert_array_equal(geo < 0, jgeo < 0)
    np.testing.assert_allclose(geo, jgeo, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ovf.numpy(), jovf)
    np.testing.assert_array_equal(wovf.numpy(), jwovf)
    assert (jgeo > 0).mean() > 0.2, "the test field should reach many points"
    assert all(c >= 8 and f == setup["model"].mc.geodesic_fine_sweeps
               for c, f in setup["model"].geodesic_passes)


def test_heads_logits(setup):
    for key in ("cls_logits", "mask_logits"):
        got, want = setup["tout"][key].numpy(), setup["jout"][key]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_array_equal(setup["tout"]["query_valid"].numpy(),
                                  setup["jout"]["query_valid"])


def test_proposals(setup):
    got, want = setup["tout"]["proposals"], setup["jout"]["proposals"]
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-5, rtol=0)
    # masks: exact except where JAX's sigmoid sits within 1e-5 of 0.5
    ml = setup["jout"]["mask_logits"][-1]  # [B,Q,F]
    near = np.abs(1.0 / (1.0 + np.exp(-ml.astype(np.float64))) - 0.5) < 1e-5
    fg_idx = setup["jout"]["fg_idx"]
    near_full = np.zeros(want["masks"].shape, bool)
    for b in range(fg_idx.shape[0]):
        near_full[b][:, fg_idx[b]] = near[b]
    diff = got["masks"].numpy() != want["masks"]
    assert not (diff & ~near_full).any()
    assert want["masks"].any(), "the test should produce non-empty masks"


def test_matrix_nms(setup):
    props = setup["jout"]["proposals"]
    for b in range(props["scores"].shape[0]):
        args = (props["masks"][b], props["scores"][b], props["classes"][b], props["keep"][b])
        wk, ws = jax_matrix_nms(*map(jnp.asarray, args), sigma=2.0, final_score_thresh=0.05)
        tk, ts = matrix_nms(*map(torch.from_numpy, args), sigma=2.0, final_score_thresh=0.05)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws), atol=1e-6, rtol=0)


def test_engine_eval_batch_cpu(setup):
    """Engine on the CPU with the carried weights reproduces the forward and
    applies the per-scene NMS of test.py."""
    engine = Engine(setup["cfg"], device="cpu", state_dict=setup["sd"])
    out = engine.eval_batch(setup["nb"])
    np.testing.assert_array_equal(out["fg_idx"].numpy(), setup["jout"]["fg_idx"])
    np.testing.assert_allclose(out["mask_logits"].numpy(), setup["jout"]["mask_logits"],
                               atol=1e-4, rtol=0)
    props = setup["jout"]["proposals"]
    for b in range(props["scores"].shape[0]):
        wk, _ = jax_matrix_nms(jnp.asarray(props["masks"][b]), jnp.asarray(props["scores"][b]),
                               jnp.asarray(props["classes"][b]), jnp.asarray(props["keep"][b]),
                               sigma=2.0, final_score_thresh=setup["cfg"].TEST_NMS_THRESH)
        np.testing.assert_array_equal(out["nms"]["keep"][b].numpy(), np.asarray(wk))


def test_engine_without_device_needs_cuda(tiny_cfg):
    """With no device the Engine runs on the card; without one it raises."""
    if torch.cuda.is_available():
        assert Engine(tiny_cfg.replace(tpu_brick_occupancy=0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Engine(tiny_cfg)


def test_scannet_eval_config_matches_yaml():
    """chip_smoke.py's Python-built config == the YAML through the JAX
    loader, on every key (model, TPU and the rest)."""
    got = scannet_eval_config().to_dict()
    want = jax_load_config("config/test_geoformer_scannet.yaml").to_dict()
    got.pop("config"), want.pop("config")
    assert got == want
    assert (ModelConfig.from_cfg(scannet_eval_config()).__dict__
            == JaxModelConfig.from_cfg(jax_load_config("config/test_geoformer_scannet.yaml")).__dict__)


def test_config_defaults_match_jax():
    assert load_config().to_dict() == jax_load_config().to_dict()
    assert ModelConfig().__dict__ == JaxModelConfig().__dict__
