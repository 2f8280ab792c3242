"""The port's eval forward with the config-reachable off-path branches on, vs
the JAX GeoFormer.

One tiny configuration (tests/conftest.py:tiny_cfg) flips several keys at
once: the exact geodesic solver (``tpu_geodesic_hier: False``), the compact
submanifold conv (``tpu_subm_k: 9`` without bricks), the brute-force ball
query (``tpu_ball_cell_cap: 0``), the compare-count window lookup
(``tpu_knn_dense_grid: 0``) and the argmin-pass selection
(``tpu_knn_select: passes``). The weights are seeded in the port and carried
to JAX by weights.to_jax_variables; the JAX forward and its aggregator and
geodesic stages are each traced once. Tolerances are those of
tests/test_torch_slice.py: float outputs 1e-4, every integer output exact,
proposal masks exact except where JAX's sigmoid lies within 1e-5 of 0.5; the
geodesic table, on the same stage inputs, bit-equal (the exact solver is one
add and a min a step).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.models.geoformer import GeoFormer as JaxGeoFormer
from geoformer_tpu.models.geoformer import ModelConfig as JaxModelConfig
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
from geoformer_tpu_torch.parallel.mesh import Mesh, set_mesh
from geoformer_tpu_torch.weights import to_jax_variables
from test_torch_slice import _batch, _jit_exact, _perturbed

OFFPATH = dict(tpu_geodesic_hier=False, tpu_subm_k=9, tpu_brick_occupancy=0, tpu_ball_cell_cap=0,
               tpu_knn_dense_grid=0, tpu_knn_select="passes")


def _tb(nb):
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["coords"] = tb["coords"].long()
    return tb


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(**OFFPATH)
    nb = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    model = GeoFormer(ModelConfig.from_cfg(cfg)).eval()
    model.load_state_dict(_perturbed(model))
    variables = to_jax_variables(model)
    jm = JaxGeoFormer(JaxModelConfig.from_cfg(cfg))
    rngs = {"sample": jax.random.split(jax.random.PRNGKey(0), 3)[1]}

    def apply(method, *args):
        return jax.tree_util.tree_map(np.array, _jit_exact(
            lambda v, *a: jm.apply(v, *a, rngs=rngs, method=method), variables, *args))

    jout = apply(lambda m, b: m(b, train=False), jb)
    tb = _tb(nb)
    with torch.no_grad():
        tout = model(tb)
        point_feats, _, _, _ = model.forward_backbone(tb)
    # the stages on the same inputs: JAX's fg pack, the port's fg features
    fg_idx, fg_valid = jout["fg_idx"], jout["fg_valid"]
    fg_locs = np.take_along_axis(nb["points"], fg_idx[..., None], axis=1)
    fg_feats = np.take_along_axis(point_feats.numpy(), fg_idx[..., None], axis=1)
    jagg = apply(lambda m, *a: m.forward_aggregator(*a, False), fg_locs, fg_feats, fg_valid)
    jgeo = apply(lambda m, *a: m.forward_geodesic(*a, False), fg_locs, fg_valid, jagg[2], jagg[3])
    return dict(cfg=cfg, nb=nb, tb=tb, model=model, jout=jout, tout=tout, fg_locs=fg_locs,
                fg_feats=fg_feats, jagg=jagg, jgeo=jgeo)


def test_backbone_with_compact_conv(setup):
    """The U-Net over the compact slot tables (k = 9, which binds at this
    scene) and the semantic head agree to 1e-4, and the compact tables
    change the scores against the 27-slot conv."""
    want = setup["jout"]["semantic_scores"]
    np.testing.assert_allclose(setup["tout"]["semantic_scores"].numpy(), want, atol=1e-4, rtol=0)
    exact = GeoFormer(ModelConfig.from_cfg(setup["cfg"].replace(tpu_subm_k=27))).eval()
    exact.load_state_dict(setup["model"].state_dict())
    with torch.no_grad():
        scores = exact.forward_backbone(setup["tb"])[1].numpy()
    assert np.abs(scores - want).max() > 1e-3


def test_bricks_ignore_subm_k(setup):
    """With bricks on (tpu_brick_occupancy > 0) JAX ignores tpu_subm_k, and
    so does the port: no compact tables, the 27-slot conv's scores."""
    cfg = setup["cfg"]
    models = [GeoFormer(ModelConfig.from_cfg(cfg.replace(tpu_brick_occupancy=32, tpu_subm_k=k)))
              for k in (9, 27)]
    outs = []
    for m in models:
        m.load_state_dict(setup["model"].state_dict())
        with torch.no_grad():
            outs.append(m.eval().forward_backbone(setup["tb"])[1])
    assert torch.equal(outs[0], outs[1])


def test_counters_and_foreground_equal(setup):
    tout, jout = setup["tout"], setup["jout"]
    for k, v in jout["voxel_stats"].items():
        np.testing.assert_array_equal(tout["voxel_stats"][k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(tout["fg_idx"].numpy(), jout["fg_idx"])
    np.testing.assert_array_equal(tout["fg_valid"].numpy(), jout["fg_valid"])
    assert jout["fg_valid"].sum() > 0


def test_aggregator_with_brute_ball_query(setup):
    """FPS + the brute-force ball group: context indices and validity exact,
    features to 1e-4."""
    with torch.no_grad():
        locs, feats, inds, valid = setup["model"].forward_aggregator(
            torch.from_numpy(setup["fg_locs"]), torch.from_numpy(setup["fg_feats"]),
            torch.from_numpy(setup["jout"]["fg_valid"].copy()))
    jlocs, jfeats, jinds, jvalid = setup["jagg"]
    np.testing.assert_array_equal(inds.numpy(), jinds)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(locs.numpy(), jlocs)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-4, rtol=0)


def _geodesic(setup, mesh=None):
    _, _, jinds, jvalid = setup["jagg"]
    with set_mesh(mesh), torch.no_grad():
        return setup["model"].forward_geodesic(
            torch.from_numpy(setup["fg_locs"]), torch.from_numpy(setup["jout"]["fg_valid"]),
            torch.from_numpy(jinds), torch.from_numpy(jvalid))


def test_exact_geodesic_table(setup):
    """The exact solver on the full k = 8 graph (argmin passes, compare-count
    lookup): bit-equal to JAX's, counters equal, the sweeps run reported."""
    geo, ovf, wovf = _geodesic(setup)
    jgeo, jovf, jwovf = setup["jgeo"]
    np.testing.assert_array_equal(geo.numpy().view(np.int32), jgeo.view(np.int32))
    np.testing.assert_array_equal(ovf.numpy(), jovf)
    np.testing.assert_array_equal(wovf.numpy(), jwovf)
    assert (jgeo > 0).mean() > 0.2, "the test field should reach many points"
    passes = setup["model"].geodesic_passes
    assert len(passes) == 2 and all(4 <= s <= setup["cfg"].tpu_geodesic_steps_eval for s in passes)


@pytest.mark.parametrize("model_rank", [0, 1])
def test_exact_geodesic_on_the_model_axis(setup, model_rank):
    """On a model axis of 2 a rank solves its 4 of the 8 seed columns, with
    its own early exit: exactly those columns of the one-process table."""
    geo, _, _ = _geodesic(setup, Mesh(model_rank, 2, torch.device("cpu"), model_parallel=2))
    cols = slice(4 * model_rank, 4 * model_rank + 4)
    want = setup["jgeo"][0][:, :, cols]
    np.testing.assert_array_equal(geo.numpy().view(np.int32), want.view(np.int32))


def test_heads_and_proposals(setup):
    tout, jout = setup["tout"], setup["jout"]
    for key in ("cls_logits", "mask_logits"):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_array_equal(tout["query_valid"].numpy(), jout["query_valid"])
    got, want = tout["proposals"], jout["proposals"]
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-5, rtol=0)
    ml = jout["mask_logits"][-1]
    near = np.abs(1.0 / (1.0 + np.exp(-ml.astype(np.float64))) - 0.5) < 1e-5
    near_full = np.zeros(want["masks"].shape, bool)
    for b in range(jout["fg_idx"].shape[0]):
        near_full[b][:, jout["fg_idx"][b]] = near[b]
    assert not ((got["masks"].numpy() != want["masks"]) & ~near_full).any()
    assert want["masks"].any(), "the test should produce non-empty masks"
