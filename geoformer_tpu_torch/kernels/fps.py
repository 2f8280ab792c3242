"""Furthest point sampling: CUDA kernel K2 and its plain version.

The kernel (csrc/fps.cu) replaces the TPU kernel
geoformer_tpu/ops/fps_pallas.py:_fps_kernel; the plain version mirrors
geoformer_tpu/ops/fps.py:_fps_scene with the batch written out. The kernel
samples each scene with one thread-block cluster of ``cluster_size(P)``
CTAs, each holding a contiguous chunk of the points in its shared memory,
which bounds P at ``kernels.lib().fps_max_points()``.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch import kernels


def fps_plain(points: torch.Tensor, mask: torch.Tensor, n_samples: int) -> torch.Tensor:
    """points [B,P,3] f32, mask [B,P] bool -> idx [B,n_samples] int32.

    Pick 0 is index 0; each pick updates the running min squared distance
    ((dx*dx + dy*dy) + dz*dz, invalid points -1) and takes the first index
    attaining the max (torch.argmax returns the first maximum)."""
    b = points.shape[0]
    dist = torch.where(mask, 1e10, -1.0).to(points.dtype)
    idxs = torch.zeros(b, n_samples, dtype=torch.long, device=points.device)
    bidx = torch.arange(b, device=points.device)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    last = idxs[:, 0]
    for i in range(1, n_samples):
        lp = points[bidx, last]  # [B,3]
        dx = x - lp[:, 0:1]
        dy = y - lp[:, 1:2]
        dz = z - lp[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        dist = torch.where(mask, torch.minimum(dist, d), -1.0)
        last = torch.argmax(dist, dim=1)
        idxs[:, i] = last
    return idxs.to(torch.int32)


def cluster_size(p: int) -> int:
    """CTAs in the cluster that samples one scene of p points on the card."""
    return kernels.lib().fps_cluster_size(p)


def fps(points: torch.Tensor, mask: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Batched FPS -> idx [B, n_samples] int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if fps.capture is not None:
        fps.capture.append((points.clone(), mask.clone(), n_samples))
    if points.device.type == "cpu":
        return fps_plain(points, mask, n_samples)
    if points.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {points.device}")
    b, p, three = points.shape
    if three != 3 or points.dtype != torch.float32 or mask.shape != (b, p):
        raise ValueError(f"fps: points {tuple(points.shape)} {points.dtype}, "
                         f"mask {tuple(mask.shape)}")
    lib = kernels.lib()
    if p > lib.fps_max_points():
        raise ValueError(f"fps: {p} points exceed the kernel's shared-memory "
                         f"capacity of {lib.fps_max_points()}")
    points = points.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty(b, n_samples, dtype=torch.int32, device=points.device)
    err = lib.fps_launch(points.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), b, p,
                         n_samples, torch.cuda.current_stream(points.device).cuda_stream)
    kernels.check(err, "fps")
    fps.launches += 1
    return out


fps.launches = 0
fps.capture = None  # a list to record (points, mask, n_samples) of each call
