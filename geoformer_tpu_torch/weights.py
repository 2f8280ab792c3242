"""Weights carried across from the JAX package (counterpart of the variable
handling in geoformer_tpu/utils/checkpoint.py).

The port's module names follow the JAX variable tree, so a JAX
``{"params", "batch_stats", "constants"}`` tree maps onto the port's
state_dict leaf by leaf:

* flax ``Dense`` kernel [in, out] -> ``nn.Linear`` weight [out, in];
* flax ``DenseGeneral`` head kernel [in, H, Dh] -> weight [H*Dh, in], its
  bias [H, Dh] -> [H*Dh];
* everything else (subm/down/up conv weights, BN scale/bias/mean/var,
  LayerNorm scale/bias, SimpleNorm alpha/bias, gauss_B) keeps its name and
  layout.

``to_jax_variables`` is the inverse, and ``save_jax_checkpoint`` writes the
msgpack file layout that ``load_jax_checkpoint`` and the JAX package's
``load_checkpoint`` both read, so a checkpoint moves between the two
packages either way. A training checkpoint adds ``opt_state`` (the optax
state tree as ``flax.serialization.to_state_dict`` lays it out for the JAX
package's optimizer, ``opt_state_to_jax``), ``step`` and ``epoch``; the JAX
package's ``restore_train_state`` resumes from it and the port from the
JAX one (``opt_state_from_jax``). ``from_reference_state_dict`` imports an
upstream PyTorch checkpoint's state_dict (tools/convert_reference_checkpoint.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats", "constants")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _from_tree(tree: dict, out: dict) -> dict:
    """Add the leaves of one JAX tree (a collection, or an optimizer moment
    shaped like the params) to ``out`` under their port names."""
    for path, leaf in _leaves(tree):
        a = np.array(leaf, dtype=np.float32)
        *parent, name = path
        if name == "kernel":
            a = a.reshape(a.shape[0], -1).T  # Dense / DenseGeneral -> Linear
            name = "weight"
        elif name == "bias" and a.ndim == 2:
            a = a.reshape(-1)  # DenseGeneral head bias
        key = ".".join(parent + [name])
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX variable tree (numpy or array leaves) -> the port's state_dict.
    Every leaf maps to exactly one state_dict entry."""
    out = {}
    for coll in COLLECTIONS:
        _from_tree(variables.get(coll, {}) or {}, out)
    return out


def from_reference_state_dict(sd: dict, cfg, kernel_order: str = "xyz", mirror: bool = False,
                              few_shot: bool = False) -> dict[str, torch.Tensor]:
    """An upstream PyTorch GeoFormer state_dict (numpy or tensor leaves) ->
    the port's state_dict: the reference checkpoint converter's ``convert``
    followed by ``from_jax_variables``."""
    from geoformer_tpu_torch.tools.convert_reference_checkpoint import convert

    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    params, stats, consts = convert(sd, cfg, kernel_order, mirror, few_shot)
    return from_jax_variables({"params": params, "batch_stats": stats, "constants": consts})


def _collection(name: str) -> str:
    return {"mean": "batch_stats", "var": "batch_stats", "gauss_B": "constants"}.get(
        name, "params")


def _head_counts(model: torch.nn.Module) -> dict:
    """Attention projections (``prefix.q`` etc.) -> their head count, which
    un-flattens a Linear into a DenseGeneral kernel."""
    from geoformer_tpu_torch.models.blocks import MultiHeadAttention, MultiHeadSelfAttention

    return {f"{prefix}.{p}" if prefix else p: mod.nhead
            for prefix, mod in model.named_modules()
            if isinstance(mod, (MultiHeadSelfAttention, MultiHeadAttention))
            and getattr(mod, "use_in_proj", True) for p in "qkv"}


def _to_tree(tensors, heads: dict, split_collections: bool = True) -> dict:
    """Port-named tensors -> a JAX tree of numpy leaves (by collection, or
    one params-shaped tree)."""
    tree = {c: {} for c in COLLECTIONS} if split_collections else {}
    for key, t in tensors:
        *parent, name = key.split(".")
        a = t.detach().cpu().numpy()
        h = heads.get(".".join(parent))
        if name == "weight":  # Linear [out, in] -> Dense [in, out] / DenseGeneral [in, H, Dh]
            a = a.T if h is None else a.T.reshape(a.shape[1], h, -1)
            name = "kernel"
        elif name == "bias" and h is not None:
            a = a.reshape(h, -1)
        node = tree[_collection(name)] if split_collections else tree
        for part in parent:
            node = node.setdefault(part, {})
        node[name] = np.array(a, order="C")  # a copy: a CPU tensor's numpy() shares memory
    return tree


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The model's state_dict as a JAX variable tree of numpy leaves: the
    inverse of ``from_jax_variables``. The head counts that un-flatten the
    q/k/v projections come from the model's attention modules."""
    return _to_tree(model.state_dict().items(), _head_counts(model))


# ---------------- optimizer state ----------------


def _i32(x) -> np.ndarray:
    return np.asarray(int(x), np.int32)


def _f32(x) -> np.ndarray:
    return np.asarray(float(x), np.float32)


def _masked_tree(state, per_param, heads: dict) -> dict:
    """A params-shaped tree of one optimizer buffer: every top-level module
    of the model's params, {} (optax's MaskedNode) for a frozen one."""
    tree = _to_tree(((k, per_param(k, p)) for k, p in state.params.items()), heads,
                    split_collections=False)
    for name, _ in state.model.named_parameters():
        tree.setdefault(name.split(".")[0], {})
    return tree


def opt_state_to_jax(state) -> dict:
    """A TrainState's optimizer as the JAX package's optax state tree, laid
    out as ``flax.serialization.to_state_dict`` lays out the state of
    ``parallel.train_state.make_optimizer`` there: multi_transform ->
    masked -> inject_hyperparams -> (Adam's count/mu/nu | add_decayed_weights,
    SGD's trace), wrapped in MultiSteps' fields under accumulation."""
    heads = _head_counts(state.model)
    opt = state.optimizer

    def buf(name):
        def get(_, p):
            st = opt.state.get(p, {})
            return st[name] if name in st and st[name] is not None else torch.zeros_like(p)
        return get

    if state.optim_name == "adam":
        hyper = {"b1": _f32(0.9), "b2": _f32(0.999), "eps": _f32(1e-8), "eps_root": _f32(0.0),
                 "learning_rate": _f32(state.lr)}
        inner = {"0": {"count": _i32(state.updates),
                       "mu": _masked_tree(state, buf("exp_avg"), heads),
                       "nu": _masked_tree(state, buf("exp_avg_sq"), heads)},
                 "1": {}}
    else:
        hyper = {"learning_rate": _f32(state.lr), "momentum": _f32(state.hyper["momentum"]),
                 "weight_decay": _f32(state.hyper["weight_decay"])}
        inner = {"0": {}, "1": {"0": {"trace": _masked_tree(state, buf("momentum_buffer"),
                                                            heads)}, "1": {}}}
    tree = {"inner_states": {
        "frozen": {"inner_state": {}},
        "train": {"inner_state": {"count": _i32(state.updates), "hyperparams": hyper,
                                  "hyperparams_states": {}, "inner_state": inner}}}}
    if state.accum == 1:
        return tree
    acc = {k: state.acc_grads.get(k) for k in state.params}
    acc_tree = _to_tree(((k, acc[k] if k in acc else torch.zeros_like(p))
                         for k, p in state.model.named_parameters()), heads,
                        split_collections=False)
    return {"acc_grads": acc_tree, "gradient_step": _i32(state.gradient_step),
            "inner_opt_state": tree, "mini_step": _i32(state.mini_step), "skip_state": {}}


def opt_state_from_jax(state, tree: dict) -> None:
    """Load an optax state tree (``opt_state_to_jax``'s layout, from either
    package) into a TrainState built for the same config."""
    if state.accum > 1:
        acc = _from_tree(tree["acc_grads"], {})
        for k in state.params:
            state.acc_grads[k].copy_(acc[k])
        state.mini_step = int(tree["mini_step"])
        state.gradient_step = int(tree["gradient_step"])
        tree = tree["inner_opt_state"]
    train = tree["inner_states"]["train"]["inner_state"]
    state.updates = int(train["count"])
    state.set_lr(float(train["hyperparams"]["learning_rate"]))
    inner = train["inner_state"]
    if state.optim_name == "adam":
        bufs = {"exp_avg": _from_tree(inner["0"]["mu"], {}),
                "exp_avg_sq": _from_tree(inner["0"]["nu"], {})}
        count = int(inner["0"]["count"])
    else:
        bufs = {"momentum_buffer": _from_tree(inner["1"]["0"]["trace"], {})}
        count = state.updates
    opt = state.optimizer
    opt.state.clear()
    if count == 0:  # never updated: the optimizer's own initial state
        return
    for k, p in state.params.items():
        st = {name: b[k].to(p.device, p.dtype).clone() for name, b in bufs.items()}
        if state.optim_name == "adam":
            st["step"] = torch.tensor(float(count))
        opt.state[p] = st


# ---------------- msgpack files ----------------


def read_msgpack(path: str) -> dict:
    """A flax msgpack file as a tree of numpy arrays and Python values
    (``flax.serialization.msgpack_restore``; msgpack is imported here)."""
    import msgpack

    def ext_hook(code, data):
        if code in (1, 3):  # flax ndarray / numpy scalar
            shape, dtype, buf = msgpack.unpackb(data, raw=False)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def write_msgpack(path: str, tree: dict) -> None:
    """A tree of dicts, numpy arrays and Python scalars as a flax msgpack
    file (``flax.serialization.msgpack_serialize``: each array an ext type 1
    of (shape, dtype name, bytes)). Arrays here stay far below msgpack's
    2 GiB leaf limit, so flax's chunked form is not needed."""
    import msgpack

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb(
                (x.shape, x.dtype.name, x.tobytes()), use_bin_type=True))
        raise TypeError(f"cannot pack {type(x)}")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, default=default, strict_types=True))


def load_jax_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a flax msgpack checkpoint (``test.py --pretrain`` files) into
    the port's state_dict."""
    tree = read_msgpack(path)
    return from_jax_variables({c: tree.get(c, {}) for c in COLLECTIONS})


def checkpoint_tree(model: torch.nn.Module, epoch: int = 0, state=None) -> dict:
    """The model's weights as a checkpoint tree: ``params``, ``batch_stats``,
    ``constants`` and ``epoch``; with a TrainState also ``opt_state`` and
    ``step`` (the JAX package's ``state_payload``)."""
    tree = dict(to_jax_variables(model))
    if state is not None:
        tree.update(opt_state=opt_state_to_jax(state), step=int(state.step))
    tree["epoch"] = int(epoch)
    return tree


def save_jax_checkpoint(path: str, model: torch.nn.Module, epoch: int = 0,
                        state=None) -> None:
    """Write ``checkpoint_tree`` as a flax msgpack checkpoint."""
    write_msgpack(path, checkpoint_tree(model, epoch, state))


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model`` from an explicit generator: fan-in
    normal weights, zero biases, unit norm scales, BN running stats (0, 1),
    a standard-normal gauss_B, and the controller at normal(0.01)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in model.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if name in ("scale", "alpha", "var"):
            v = torch.ones_like(t)
        elif name in ("bias", "mean"):
            v = torch.zeros_like(t)
        elif name == "gauss_B":
            v = torch.randn(t.shape, generator=g)
        elif key == "controller_head.controller.weight":
            v = torch.randn(t.shape, generator=g) * 0.01
        elif name == "weight":  # nn.Linear [out, in]
            v = torch.randn(t.shape, generator=g) / t.shape[1] ** 0.5
        else:  # conv weights [..., in, out]: fan-in over all but the last axis
            v = torch.randn(t.shape, generator=g) / (t.numel() // t.shape[-1]) ** 0.5
        sd[key] = v.to(t.dtype)
    return sd
