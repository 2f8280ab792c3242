"""Row gather ``out[r, :] = x[idx[r], :]``: CUDA kernel K3 and its plain version.

The kernel (csrc/row_gather.cu) replaces the four TPU probe kernels of
tools/pallas_gather_probe.py (take, take_along_axis, fori dynamic slice,
one-hot matmul): they are candidate lowerings of this one function, so one
kernel is their counterpart. A gather moves bits, so kernel and plain
version agree exactly, NaN payloads and -0.0 included.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch import kernels


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P,Q], idx [N] or [N,1] int (each in [0, P)) -> [N,Q]."""
    return x[idx.reshape(-1).long()]


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P,Q] f32 contiguous, idx [N] or [N,1] int32, every id in [0, P) ->
    [N,Q] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise). Shapes and dtypes are checked on the host; the ids are not read
    there (no synchronize), so in-range ids are the caller's promise."""
    if row_gather.capture is not None:
        row_gather.capture.append((x.clone(), idx.clone()))
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {x.device}")
    if (x.ndim != 2 or x.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.device != x.device or x.shape[1] < 1 or not x.is_contiguous()
            or not (idx.ndim == 1 or (idx.ndim == 2 and idx.shape[1] == 1))):
        raise ValueError(f"row_gather: x {tuple(x.shape)} {x.dtype} strides {x.stride()} "
                         f"on {x.device}, "
                         f"idx {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    idx = idx.reshape(-1).contiguous()
    n, q = idx.shape[0], x.shape[1]
    out = torch.empty(n, q, dtype=torch.float32, device=x.device)
    if n == 0:
        return out  # nothing to launch
    err = kernels.lib().row_gather_launch(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, q,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
row_gather.capture = None  # a list to record (x, idx) of each call
