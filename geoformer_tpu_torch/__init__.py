"""PyTorch/CUDA port of geoformer_tpu (the JAX package is the reference).

Layout mirrors the JAX package: ``ops/`` (voxelize, sparse conv, FPS, ball
query, radius graph, geodesic, NMS), ``models/`` (blocks, U-Net, aggregator,
decoder, mask head, GeoFormer), ``config.py``, ``engine.py`` and
``weights.py``. Hand-written Hopper kernels live in ``csrc/`` and their
wrappers in ``kernels/``. Nothing here imports JAX or the JAX package.
"""

import torch


def default_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller passes a device.

    With no device and no CUDA this raises: the port never falls back to
    the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda")


def set_fp32_precision() -> None:
    """Full float32 matmuls and convolutions on the card (no TF32): the JAX
    reference runs full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
