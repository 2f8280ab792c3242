"""Seeded weights, made on the run's device from ``--seed`` in one draw:
fan-in normal weights, zero biases, unit norm scales, batch-norm running
statistics (0, 1), a standard-normal Fourier basis, the controller at
normal(0.01), plus the configuration's fixed logit biases. The leaves and
their shapes are the model's (the port's module tree, built on the meta
device, holds no value)."""

from __future__ import annotations

import torch


def leaf_shapes(cfg) -> dict:
    from geoformer_tpu_torch.models.geoformer import GeoFormer, ModelConfig

    with torch.device("meta"):
        model = GeoFormer(ModelConfig.from_cfg(cfg))
    return {k: (tuple(t.shape), t.dtype) for k, t in model.state_dict().items()}


def state_dict(cfg, seed: int, device, bias: dict | None = None) -> dict:
    """{name: tensor on ``device``}; ``bias`` maps a leaf to [index, value]
    set after the draw."""
    shapes = leaf_shapes(cfg)
    drawn = [k for k in shapes if k.rsplit(".", 1)[-1] not in ("scale", "alpha", "var",
                                                               "bias", "mean")]
    total = sum(int(torch.Size(shapes[k][0]).numel()) for k in drawn)
    g = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    z = torch.randn(total, generator=g, device=device)
    sd, off = {}, 0
    for key, (shape, dtype) in shapes.items():
        name = key.rsplit(".", 1)[-1]
        n = int(torch.Size(shape).numel())
        if name in ("scale", "alpha", "var"):
            sd[key] = torch.ones(shape, dtype=dtype, device=device)
            continue
        if name in ("bias", "mean"):
            sd[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        v = z[off:off + n].view(shape)
        off += n
        if name == "gauss_B":
            pass
        elif key == "controller_head.controller.weight":
            v = v * 0.01
        elif name == "weight":  # nn.Linear [out, in]
            v = v / shape[1] ** 0.5
        else:  # conv weights [..., in, out]
            v = v / (n // shape[-1]) ** 0.5
        sd[key] = v.to(dtype).clone()
    for key, (index, value) in (bias or {}).items():
        sd[key][index] = value
    return sd
