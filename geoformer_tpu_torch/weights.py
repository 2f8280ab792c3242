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

Upstream PyTorch checkpoints reach the port through
tools/convert_reference_checkpoint.py and then ``from_jax_variables``.
"""

from __future__ import annotations

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
