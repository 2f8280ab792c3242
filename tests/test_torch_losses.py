"""The port's training host pieces vs the JAX package, on the same numpy
inputs: matcher, losses, criteria, LR schedules, optimizer, training batches,
checkpoints, and the bf16 sparse convolution.

Tolerances:

* matcher: ``build_gt_instances`` and both assignments (scipy LSA and the
  device auction, on tie-free random costs and on the degenerate cases of
  tests/test_auction_matcher.py plus one that reaches the auction's round
  cap) exactly equal;
* ``dice_cost``, the CE / dice / focal / similarity losses and both criteria
  on the same outputs: <= 1e-5 relative (f32 sums reassociated);
* LR schedules: equal;
* optimizer (Adam, SGD with weight decay, a frozen module, 2-step
  accumulation) against optax on the same gradients: parameters and the
  optimizer state within 1e-6 absolute after one and two updates, the state
  tree laid out exactly as flax.serialization.to_state_dict lays out optax's;
* training batches on a synthetic dataset: integer fields exactly equal,
  float fields within 1e-5;
* checkpoints: a port payload resumed by the JAX package's
  restore_train_state and a JAX state_payload resumed by the port carry every
  weight, optimizer buffer and counter unchanged;
* bf16 subm_conv: f32 output on both sides, within 1e-3 relative; the
  f32 subm_conv's gradients (through take_rows) within 1e-5 relative.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoformer_tpu.data.episodic import FSInstDataset as JaxFSInstDataset
from geoformer_tpu.data.scannet import InstDataset as JaxInstDataset
from geoformer_tpu.losses import criterion as jcrit
from geoformer_tpu.losses import criterion_fs as jcrit_fs
from geoformer_tpu.losses import matcher as jmatch
from geoformer_tpu.ops.sparse_conv import subm_conv as jax_subm_conv
from geoformer_tpu.parallel.train_state import _set_lr, create_train_state, make_optimizer
from geoformer_tpu.utils import checkpoint as jckpt
from geoformer_tpu.utils import scheduler as jsched
from geoformer_tpu.utils.config import load_config as jax_load_config
from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.data.episodic import FSInstDataset
from geoformer_tpu_torch.data.scannet import InstDataset
from geoformer_tpu_torch.losses import criterion, criterion_fs, matcher
from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig
from geoformer_tpu_torch.ops.sparse_conv import subm_conv
from geoformer_tpu_torch.parallel.train_state import TrainState
from geoformer_tpu_torch.synthetic import write_dataset
from geoformer_tpu_torch.utils import checkpoint as ckpt
from geoformer_tpu_torch.utils import scheduler
from geoformer_tpu_torch.weights import (
    from_jax_variables,
    opt_state_to_jax,
    random_state_dict,
    to_jax_variables,
)

REL = 1e-5


def _jit_fast(f):
    """jax.jit of f, compiled on first call without XLA's backend
    optimisation (compile time is what these tests spend)."""
    compiled = {}

    def call(*args):
        key = jax.tree_util.tree_structure(args)
        if key not in compiled:
            compiled[key] = jax.jit(f).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)
    return call


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * scale


def _gt_inputs(seed=0, b=2, f=96, max_inst=8):
    rng = np.random.default_rng(seed)
    inst = rng.integers(-2, 6, (b, f)).astype(np.int32)
    inst[inst < 0] = -100
    sem = rng.integers(0, 13, (b, f)).astype(np.int32)
    valid = rng.random((b, f)) < 0.85
    return inst, sem, valid, max_inst


def test_build_gt_instances_equal():
    inst, sem, valid, n = _gt_inputs()
    want = [np.asarray(x) for x in jmatch.build_gt_instances(
        jnp.asarray(inst), jnp.asarray(sem), jnp.asarray(valid), n)]
    got = [x.numpy() for x in matcher.build_gt_instances(_t(inst), _t(sem), _t(valid), n)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def test_dice_cost_equal():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 12, 96)).astype(np.float32)
    inst, sem, valid, n = _gt_inputs()
    masks = np.asarray(jmatch.build_gt_instances(
        jnp.asarray(inst), jnp.asarray(sem), jnp.asarray(valid), n)[0])
    want = jax.vmap(jmatch.dice_cost)(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(valid))
    _close(matcher.dice_cost(_t(logits), _t(masks), _t(valid)).numpy(), want)


def _assign_cases():
    rng = np.random.default_rng(2)
    cost = rng.uniform(-1.0, 2.0, (3, 16, 8)).astype(np.float32)
    valid = rng.random((3, 8)) < 0.7
    valid[2] = True
    qvalid = np.ones((3, 16), bool)
    qvalid[1, 10:] = False
    cost = np.where(qvalid[:, :, None], cost, 1e6).astype(np.float32)
    cases = {"random": (cost, valid)}
    # tests/test_auction_matcher.py: all-tied costs, and no valid instance
    tied = np.zeros((1, 8, 4), np.float32)
    cases["ties"] = (tied, np.array([[True, True, False, False]]))
    cases["all_invalid"] = (tied, np.zeros((1, 4), bool))
    # more valid instances than queries: the auction runs to its round cap
    # and the greedy pass assigns what is left
    cases["cap"] = (rng.uniform(0, 1, (1, 2, 4)).astype(np.float32), np.ones((1, 4), bool))
    return cases


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid", "cap"])
def test_assignments_equal(case):
    cost, valid = _assign_cases()[case]
    jc, jv = jnp.asarray(cost), jnp.asarray(valid)
    want_auction = np.asarray(_jit_fast(jmatch.auction_assign)(jc, jv))
    got_auction = matcher.auction_assign(_t(cost), _t(valid)).numpy()
    assert np.array_equal(got_auction, want_auction)
    if case == "cap":
        assert matcher.auction_assign.rounds == matcher.AUCTION_ROUNDS
    if case != "cap":  # scipy's LSA needs at least as many queries as instances
        want = np.asarray(jmatch.hungarian_assign(jc, jv))
        assert np.array_equal(matcher.hungarian_assign(_t(cost), _t(valid)).numpy(), want)


def _outputs(seed, b=2, layers=2, q=12, f=96, c=13, fs=False):
    """Random model outputs and a batch for the criteria: fg_idx into a
    P = 2F point batch, last-layer logits wide enough for real matches."""
    rng = np.random.default_rng(seed)
    p = 2 * f
    fg_idx = np.stack([rng.permutation(p)[:f] for _ in range(b)]).astype(np.int64)
    inst = rng.integers(-1, 5, (b, p)).astype(np.int32)
    inst[inst < 0] = -100
    labels = rng.integers(0, c, (b, p)).astype(np.int32)
    labels[:, :7] = -100
    out = {
        "semantic_scores": rng.normal(0, 1, (b, p, c)).astype(np.float32),
        "fg_idx": fg_idx,
        "fg_valid": rng.random((b, f)) < 0.9,
        "query_valid": rng.random((b, q)) < 0.9,
        "mask_logits": rng.normal(0, 3, (layers, b, q, f)).astype(np.float32),
    }
    if fs:
        out["similarity"] = rng.normal(0, 2, (b, q)).astype(np.float32)
    else:
        out["cls_logits"] = rng.normal(0, 1, (layers, b, q, c)).astype(np.float32)
    batch = {"labels": labels, "instance_labels": inst, "point_mask": rng.random((b, p)) < 0.95}
    return out, batch


def test_losses_equal():
    out, batch = _outputs(3)
    jl = jnp.asarray
    sem, lab, pm = out["semantic_scores"], batch["labels"], batch["point_mask"]
    _close(criterion.softmax_cross_entropy_ignore(_t(sem), _t(lab), -100, _t(pm)),
           _jit_fast(lambda *a: jcrit.softmax_cross_entropy_ignore(*a, -100, pm))(sem, lab))
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (6, 50)).astype(np.float32)
    targets = (rng.random((6, 50)) < 0.4).astype(np.float32)
    pv = (rng.random(6) < 0.8).astype(np.float32)
    fv = rng.random(50) < 0.9
    args = (logits, targets, pv, fv, np.float32(pv.sum()))
    for port_fn, jax_fn in ((criterion.masked_dice_loss, jcrit.masked_dice_loss),
                            (criterion.masked_focal_loss, jcrit.masked_focal_loss)):
        _close(port_fn(*map(_t, args)), _jit_fast(jax_fn)(*map(jl, args)))
    fs_out, fs_batch = _outputs(5, fs=True)
    inst_fg = np.take_along_axis(fs_batch["instance_labels"], fs_out["fg_idx"], 1)
    sim_args = (fs_out["similarity"], fs_out["mask_logits"][-1], inst_fg, fs_out["fg_valid"],
                fs_out["query_valid"])
    _close(criterion_fs.similarity_loss(*map(_t, sim_args), 2, max_inst=8),
           _jit_fast(lambda *a: jcrit_fs.similarity_loss(*a, 2, max_inst=8))(*sim_args))


@pytest.mark.parametrize("few_shot", [False, True])
def test_criteria_equal(few_shot):
    """Both criteria on the same outputs, with each matcher: the loss, every
    entry of the loss dict, and the gradient of the loss w.r.t. the logits."""
    cfg = jax_load_config(None, tpu_max_instances=8, prepare_epochs=0)
    out, batch = _outputs(6, fs=few_shot)
    diff = ["mask_logits"] + (["similarity"] if few_shot else ["cls_logits", "semantic_scores"])
    for device_matcher in (True, False):
        cfg = cfg.replace(tpu_device_matcher=device_matcher)
        jc = (jcrit_fs.FSInstSetCriterion if few_shot else jcrit.InstSetCriterion)(cfg)
        pc = (criterion_fs.FSInstSetCriterion if few_shot else criterion.InstSetCriterion)(
            load_config(None, **{k: v for k, v in vars(cfg).items() if k != "config"}))

        def jloss(leaves):
            o = dict({k: jnp.asarray(v) for k, v in out.items()}, **leaves)
            return jc(o, {k: jnp.asarray(v) for k, v in batch.items()}, 1)

        (jl, jd), jg = _jit_fast(jax.value_and_grad(jloss, has_aux=True))(
            {k: jnp.asarray(out[k]) for k in diff})
        leaves = {k: _t(out[k]).requires_grad_(True) for k in diff}
        tl, td = pc(dict({k: _t(v) for k, v in out.items()}, **leaves),
                    {k: _t(v) for k, v in batch.items()}, 1)
        tl.backward()
        _close(tl.detach(), jl)
        assert set(td) == set(jd)
        for k in jd:
            _close(td[k].detach(), jd[k])
        for k in diff:
            _close(leaves[k].grad, jg[k])
        assert float(td["num_gt"]) > 0


def test_lr_schedules_equal():
    for e in range(0, 60):
        assert scheduler.adjust_learning_rate(5e-4, 1e-6, 1e-6, 3, 50, e) == \
            jsched.adjust_learning_rate(5e-4, 1e-6, 1e-6, 3, 50, e)
        assert scheduler.cosine_lr_after_step(1e-3, e, 20, 50) == \
            jsched.cosine_lr_after_step(1e-3, e, 20, 50)
        for name in ("step", "poly", "exp"):
            args = {"step": (1e-3, e, 7), "poly": (1e-3, e, 50), "exp": (1e-3, e)}[name]
            assert scheduler.get_scheduler(name)(*args) == jsched.get_scheduler(name)(*args)
        assert scheduler.multi_step_lr(1e-3, e, [10, 30]) == jsched.multi_step_lr(1e-3, e, [10, 30])


# ---------------- optimizer and checkpoints ----------------

OPTIMIZERS = {
    "adam": dict(optim="Adam"),
    "sgd_wd": dict(optim="SGD", lr=0.05, weight_decay=0.01),
    "frozen": dict(optim="Adam", fix_module=["unet", "semantic", "decoder"]),
    "accum2": dict(optim="Adam", grad_accum_steps=2),
}


@pytest.fixture(scope="module")
def tiny_model_cfg(tiny_cfg):
    # one U-Net level and one decoder layer: every kind of leaf (convs, BN,
    # Dense, DenseGeneral heads, LayerNorm) with the fewest of them, since
    # compiling optax's update over the tree is what these tests spend
    return tiny_cfg.replace(tpu_unet_depth=1, dec_nlayers=1, tpu_brick_occupancy=0)


_STEPS = {}  # optimizer kind -> (optax transformation, its jitted step)


def _state_pair(tiny_model_cfg, kind, seed=0):
    """The tiny GeoFormer's weights in a port TrainState and the same
    weights in a JAX TrainState of the JAX package's optimizer, with that
    optimizer's step (compiled once per kind)."""
    cfg = tiny_model_cfg.replace(**OPTIMIZERS[kind])
    pcfg = load_config(None, **{k: v for k, v in vars(cfg).items() if k != "config"})
    model = GeoFormer(ModelConfig.from_cfg(pcfg))
    model.load_state_dict(random_state_dict(model, seed))
    state = TrainState(pcfg, model)
    variables = to_jax_variables(model)
    if kind not in _STEPS:
        tx = make_optimizer(cfg, variables["params"])
        _STEPS[kind] = (tx, _jit_fast(lambda st, g, lr: _jax_step(st, tx, g, lr)))
    tx, step = _STEPS[kind]
    return state, create_train_state(variables, tx), step


def _grads(model, seed):
    """Seeded gradients for every parameter, as port tensors and as the JAX
    params tree."""
    rng = np.random.default_rng(seed)
    named = {k: torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
             for k, p in model.named_parameters()}
    tree = to_jax_variables(type("M", (), {
        "state_dict": lambda self: named, "named_modules": model.named_modules})())["params"]
    return named, tree


def _jax_step(jstate, tx, grads, lr):
    """One step of geoformer_tpu/engine.py's train step after the
    gradients: the injected learning rate, the optax update."""
    opt_state = _set_lr(jstate.opt_state, lr)
    updates, opt_state = tx.update(grads, opt_state, jstate.params)
    return jstate.replace(step=jstate.step + 1, opt_state=opt_state,
                          params=jax.tree.map(lambda p, u: p + u, jstate.params, updates))


def _tree_close(got, want, atol=1e-6):
    """Two state trees with the same keys, shapes and dtypes, values within
    atol."""
    g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(got)}
    w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.allclose(a, b, rtol=0, atol=atol), k


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_optimizer_matches_optax(tiny_model_cfg, kind):
    state, jstate, step = _state_pair(tiny_model_cfg, kind)
    if kind == "frozen":
        assert {"backbone", "semantic", "decoder"} <= state.frozen
        assert not any(k.split(".")[0] in state.frozen for k in state.params)
    micro = 2 * state.accum
    for i in range(micro):
        named, tree = _grads(state.model, 10 + i)
        lr = 1e-3 * (1 + i)
        for k, p in state.params.items():
            p.grad = named[k].clone()
        state.apply_gradients(lr)
        jstate = step(jstate, tree, lr)
        if (i + 1) % state.accum == 0:
            got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
            want = from_jax_variables(dict(to_jax_variables(state.model), params=jstate.params))
            for k, v in want.items():
                assert np.allclose(got[k], v.numpy(), rtol=0, atol=1e-6), k
    assert state.step == int(jstate.step) == micro
    _tree_close(opt_state_to_jax(state), flax.serialization.to_state_dict(jstate.opt_state))


@pytest.mark.parametrize("kind", ["adam", "sgd_wd", "frozen", "accum2"])
def test_checkpoints_cross_both_ways(tiny_model_cfg, kind, tmp_path):
    """A port training payload resumed by the JAX package, and a JAX one by
    the port, after updates that leave the moments non-zero (accum2 stops
    mid-window, so its accumulator is non-zero too)."""
    state, jstate, step = _state_pair(tiny_model_cfg, kind)
    for i in range(3):
        named, tree = _grads(state.model, 20 + i)
        for k, p in state.params.items():
            p.grad = named[k].clone()
        state.apply_gradients(1e-3)
        jstate = step(jstate, tree, 1e-3)

    # port -> JAX
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, ckpt.state_payload(state, epoch=7))
    loaded = jckpt.load_checkpoint(path)
    _, fresh, _ = _state_pair(tiny_model_cfg, kind, seed=1)
    resumed = jckpt.restore_train_state(fresh, loaded)
    assert int(resumed.step) == state.step and loaded["epoch"] == 7
    _tree_close(flax.serialization.to_state_dict(resumed.opt_state), opt_state_to_jax(state), 0)
    want = to_jax_variables(state.model)
    _tree_close(resumed.params, want["params"], 0)
    _tree_close(resumed.batch_stats, want["batch_stats"], 0)

    # JAX -> port
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jckpt.state_payload(jstate, epoch=5))
    other, _, _ = _state_pair(tiny_model_cfg, kind, seed=2)
    ckpt.restore_train_state(other, ckpt.load_checkpoint(path))
    assert other.step == int(jstate.step)
    _tree_close(opt_state_to_jax(other), flax.serialization.to_state_dict(jstate.opt_state), 0)
    _tree_close(to_jax_variables(other.model)["params"], jstate.params, 0)
    # the resumed port state takes the same next update as the JAX one
    named, tree = _grads(other.model, 30)
    for k, p in other.params.items():
        p.grad = named[k].clone()
    other.apply_gradients(2e-3)
    jstate = step(jstate, tree, 2e-3)
    _tree_close(opt_state_to_jax(other), flax.serialization.to_state_dict(jstate.opt_state))


# ---------------- training batches ----------------


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    write_dataset(root, n_scenes=8, n_points=1200, seed=3)
    return root


@pytest.mark.parametrize("few_shot", [False, True])
def test_train_batches_equal(train_data, few_shot):
    """Augmented, cropped and padded training batches (and the few-shot
    episodes' query and support batches) from one seed in both packages."""
    kw = dict(data_root=train_data, tpu_max_points=1024, max_npoint=1000, batch_size=2)
    jcfg = jax_load_config(os.path.join("config", "tiny_cpu_test.yaml"), **kw)
    pcfg = load_config(os.path.join("config", "tiny_cpu_test.yaml"), **kw)
    if few_shot:
        jb = list(JaxFSInstDataset(jcfg, "train").train_batches(2, seed=4))
        pb = list(FSInstDataset(pcfg, "train").train_batches(2, seed=4))
        assert [b[2] for b in pb] == [b[2] for b in jb]
        pairs = [(p[i], j[i]) for p, j in zip(pb, jb) for i in (0, 1)]
    else:
        jb = list(JaxInstDataset(jcfg, "train").train_batches(2, seed=4, epochs=2))
        pb = list(InstDataset(pcfg, "train").train_batches(2, seed=4, epochs=2))
        pairs = list(zip(pb, jb))
    assert len(pairs) >= 2
    for p, j in pairs:
        assert p.keys() == j.keys()
        for k in j:
            a, b = np.asarray(p[k]), np.asarray(j[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if np.issubdtype(b.dtype, np.floating):
                assert np.allclose(a, b, rtol=0, atol=1e-5), k
            else:
                assert np.array_equal(a, b), k


# ---------------- bf16 sparse convolution ----------------


def test_subm_conv_bf16_matches_jax():
    rng = np.random.default_rng(8)
    b, v, cin, cout = 2, 300, 16, 24
    feats = rng.normal(0, 1, (b, v, cin)).astype(np.float32)
    nbr = rng.integers(0, v + 1, (b, v, 27)).astype(np.int32)  # v = the zero row
    w = rng.normal(0, 0.2, (27, cin, cout)).astype(np.float32)
    want = np.asarray(_jit_fast(lambda f, n, ww: jax_subm_conv(f, n, ww, compute_dtype=jnp.bfloat16))(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w)))
    got = subm_conv(_t(feats), _t(nbr).long(), _t(w), torch.bfloat16)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close(got.numpy(), want, rel=1e-3)
    # and not the float32 product: the narrowing is in force on both sides
    f32 = subm_conv(_t(feats), _t(nbr).long(), _t(w)).numpy()
    assert np.abs(f32 - want).max() > 1e-4


def test_subm_conv_gradients_match_jax():
    """The sparse conv's backward through take_rows (an index_add_,
    nothing into the pad row) against JAX's gather transpose."""
    rng = np.random.default_rng(9)
    b, v, cin, cout = 2, 200, 8, 12
    feats = rng.normal(0, 1, (b, v, cin)).astype(np.float32)
    nbr = np.where(rng.random((b, v, 27)) < 0.6, v,
                   rng.integers(0, v, (b, v, 27))).astype(np.int32)  # mostly the pad row
    w = rng.normal(0, 0.2, (27, cin, cout)).astype(np.float32)
    probe = rng.normal(0, 1, (b, v, cout)).astype(np.float32)
    jg = _jit_fast(jax.grad(lambda f, ww: jnp.sum(jax_subm_conv(f, jnp.asarray(nbr), ww) * probe),
                            argnums=(0, 1)))(jnp.asarray(feats), jnp.asarray(w))
    tf, tw = _t(feats).requires_grad_(True), _t(w).requires_grad_(True)
    (subm_conv(tf, _t(nbr).long(), tw) * _t(probe)).sum().backward()
    _close(tf.grad.numpy(), jg[0])
    _close(tw.grad.numpy(), jg[1])
