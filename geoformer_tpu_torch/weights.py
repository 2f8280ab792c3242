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
packages either way. Importing an upstream PyTorch checkpoint directly is
not wired yet.
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


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX variable tree (numpy or array leaves) -> the port's state_dict.
    Every leaf maps to exactly one state_dict entry."""
    out = {}
    for coll in COLLECTIONS:
        for path, leaf in _leaves(variables.get(coll, {}) or {}):
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


def load_jax_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a flax msgpack checkpoint (``test.py --pretrain`` files) into
    the port's state_dict. msgpack is imported here, only when needed."""
    import msgpack

    def ext_hook(code, data):
        if code in (1, 3):  # flax ndarray / numpy scalar
            shape, dtype, buf = msgpack.unpackb(data, raw=False)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return from_jax_variables({c: tree.get(c, {}) for c in COLLECTIONS})


def _collection(name: str) -> str:
    return {"mean": "batch_stats", "var": "batch_stats", "gauss_B": "constants"}.get(
        name, "params")


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The model's state_dict as a JAX variable tree of numpy leaves: the
    inverse of ``from_jax_variables``. The head counts that un-flatten the
    q/k/v projections come from the model's attention modules."""
    from geoformer_tpu_torch.models.blocks import MultiHeadSelfAttention

    heads = {f"{prefix}.{p}": mod.nhead for prefix, mod in model.named_modules()
             if isinstance(mod, MultiHeadSelfAttention) for p in "qkv"}
    tree = {c: {} for c in COLLECTIONS}
    for key, t in model.state_dict().items():
        *parent, name = key.split(".")
        a = t.detach().cpu().numpy()
        h = heads.get(".".join(parent))
        if name == "weight":  # Linear [out, in] -> Dense [in, out] / DenseGeneral [in, H, Dh]
            a = a.T if h is None else a.T.reshape(a.shape[1], h, -1)
            name = "kernel"
        elif name == "bias" and h is not None:
            a = a.reshape(h, -1)
        node = tree[_collection(name)]
        for part in parent:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def save_jax_checkpoint(path: str, model: torch.nn.Module, epoch: int = 0) -> None:
    """Write the model's weights as a flax msgpack checkpoint (a tree of
    ``params``, ``batch_stats``, ``constants`` and ``epoch``; each array an
    ext type 1 of (shape, dtype name, bytes), as flax.serialization packs
    it). Arrays here stay far below msgpack's 2 GiB leaf limit, so flax's
    chunked form is not needed."""
    import msgpack

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb(
                (x.shape, x.dtype.name, x.tobytes()), use_bin_type=True))
        raise TypeError(f"cannot pack {type(x)}")

    state = dict(to_jax_variables(model), epoch=int(epoch))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(state, default=default, strict_types=True))


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
