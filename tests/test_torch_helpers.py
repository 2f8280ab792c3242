"""The port's copies of the JAX package's helpers that only tests and
library users call: ``data/episodic.sphere_crop_instance``,
``evaluation/gt.load_gt_ids``, ``losses/criterion.focal_loss_v1`` and
``compute_score_loss``, ``models/pos_embedding.PositionEmbeddingCoordsSine``
and ``models/blocks.MultiHeadAttention``.

Same seeded numpy inputs through both packages on the CPU. The crop and
the gt ids are exact; the losses and the sine embedding agree to rtol 1e-6 /
atol 1e-6; MultiHeadAttention (q, k and v of three different widths, and
without in-projections) on the flax module's initial weights carried over
by ``weights.from_jax_variables`` agrees to 1e-5, and
``weights.to_jax_variables`` gives the flax tree back leaf for leaf.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from geoformer_tpu.data.episodic import sphere_crop_instance as jax_sphere_crop
from geoformer_tpu.evaluation.gt import load_gt_ids as jax_load_gt_ids
from geoformer_tpu.losses import criterion as jax_criterion
from geoformer_tpu.models.blocks import MultiHeadAttention as JaxMultiHeadAttention
from geoformer_tpu.models.pos_embedding import PositionEmbeddingCoordsSine as JaxSine
from geoformer_tpu_torch.data.episodic import sphere_crop_instance
from geoformer_tpu_torch.evaluation.gt import load_gt_ids
from geoformer_tpu_torch.losses.criterion import compute_score_loss, focal_loss_v1
from geoformer_tpu_torch.models.blocks import MultiHeadAttention
from geoformer_tpu_torch.models.pos_embedding import PositionEmbeddingCoordsSine
from geoformer_tpu_torch.weights import from_jax_variables, to_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scale_factor", [2, 1, -2])
def test_sphere_crop_instance_exact(scale_factor):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3))
    inst = rng.integers(-1, 6, 500)
    for iid in (0, 3):
        np.testing.assert_array_equal(sphere_crop_instance(xyz, inst, iid, scale_factor),
                                      jax_sphere_crop(xyz, inst, iid, scale_factor))


def test_load_gt_ids_exact(tmp_path):
    ids = np.array([0, 3001, 3001, 5002, 0, 39010])
    path = str(tmp_path / "scene0000_00.txt")
    np.savetxt(path, ids, fmt="%d")
    got, want = load_gt_ids(path), jax_load_gt_ids(path)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ids)


def test_focal_and_score_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(4, 50)) * 3).astype(np.float32)
    labels = (rng.random((4, 50)) > 0.6).astype(np.float32)
    valid = rng.random((4, 50)) > 0.3
    for v in (None, valid):
        got = focal_loss_v1(_t(logits), _t(labels), valid=None if v is None else _t(v))
        want = jax_criterion.focal_loss_v1(jnp.asarray(logits), jnp.asarray(labels),
                                           valid=None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    scores = rng.normal(size=60).astype(np.float32) * 2
    ious = rng.random(60).astype(np.float32)
    sv = rng.random(60) > 0.2
    got = compute_score_loss(_t(scores), _t(ious), _t(sv))
    want = jax_criterion.compute_score_loss(jnp.asarray(scores), jnp.asarray(ious),
                                            jnp.asarray(sv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d_pos", [30, 32, 64])
def test_sine_embedding_matches_jax(d_pos):
    """30: no remainder channels; 32 and 64: 2 and 4 given to the leading
    coordinates."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-2, 3, (2, 40, 3)).astype(np.float32)
    mins, maxs = xyz.min(1), xyz.max(1)
    want = JaxSine(d_pos).apply({}, jnp.asarray(xyz), jnp.asarray(mins), jnp.asarray(maxs))
    got = PositionEmbeddingCoordsSine(d_pos)(_t(xyz), _t(mins), _t(maxs))
    assert got.shape == (2, 40, d_pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_in_proj", [True, False])
def test_multi_head_attention_matches_jax(use_in_proj):
    d_model, nhead = 16, 4
    dims = (12, 10, 6) if use_in_proj else (d_model,) * 3
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, n, d)).astype(np.float32)
               for n, d in zip((5, 7, 7), dims))
    mask = rng.random((2, 7)) > 0.3
    mask[:, 0] = True
    jmod = JaxMultiHeadAttention(d_model, nhead, kdim=dims[1], vdim=dims[2],
                                 use_in_proj=use_in_proj)
    args = tuple(jnp.asarray(a) for a in (q, k, v, mask))
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), *args, train=False))
    want = np.asarray(jmod.apply(variables, *args, train=False))

    mod = MultiHeadAttention(d_model, nhead, kdim=dims[1], vdim=dims[2], use_in_proj=use_in_proj,
                             qdim=dims[0]).eval()
    mod.load_state_dict(from_jax_variables(variables), strict=True)
    got = mod(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)

    back = to_jax_variables(mod)["params"]
    want_leaves = jax.tree_util.tree_leaves_with_path(variables["params"])
    got_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert sorted(jax.tree_util.keystr(p) for p, _ in got_leaves) == sorted(
        jax.tree_util.keystr(p) for p, _ in want_leaves)
    back_flat = {jax.tree_util.keystr(p): x for p, x in got_leaves}
    for p, x in want_leaves:
        np.testing.assert_array_equal(back_flat[jax.tree_util.keystr(p)], x)
