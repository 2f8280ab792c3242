"""PyTorch/CUDA port of geoformer_tpu (the JAX package is the reference).

Layout mirrors the JAX package: ``ops/`` (voxelize, sparse conv, FPS, ball
query, radius graph, geodesic, NMS, kNN, 3-NN interpolation, segment ops,
clustering), ``models/`` (blocks, U-Net, aggregator, decoder, mask head,
GeoFormer, GeoFormerFS), ``data/`` (datasets, augmentation), ``evaluation/``
(ScanNet AP), ``utils/``, ``config.py``, ``engine.py``, ``weights.py`` and
``native.py`` (the g++-built host ops). Hand-written Hopper kernels live in
``csrc/`` and their wrappers in ``kernels/``; the drivers are in ``cli/``,
the tools (row-gather probe, profiled step, upstream-checkpoint importer)
in ``tools/``. Nothing here imports JAX or the JAX package.
"""

import torch


def default_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller passes a device.

    With no device and no CUDA this raises: the port never falls back to
    the CPU on its own. Under an initialised process group (one process per
    GPU, parallel/dist.py) an unindexed CUDA device is this rank's card,
    ``cuda:{LOCAL_RANK}``, made the current device: never every rank on
    ``cuda:0``."""
    from geoformer_tpu_torch.parallel import dist

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run on the CPU"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dist.is_initialized():
        if dev.index is None:
            dev = torch.device("cuda", dist.cuda_index())
        torch.cuda.set_device(dev)
    return dev


def set_fp32_precision() -> None:
    """Full float32 matmuls and convolutions on the card (no TF32): the JAX
    reference runs full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
