"""k-smallest candidate selection: CUDA kernel K1 and its plain version.

The kernel (csrc/knn_select.cu) replaces the TPU kernel
geoformer_tpu/ops/knn_select_pallas.py:_select_kernel (select_min_k_cand).
Both versions pick, per row, the k smallest d2 values in ascending order,
ties to the lowest lane, and the candidate ids at those lanes: the order of
a stable ascending sort, which is also lax.top_k's order.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch import kernels


def select_min_k_cand_plain(d2: torch.Tensor, cand: torch.Tensor, k: int):
    """d2 [N,W] f32, cand [N,W] int -> (vals [N,k] f32, idx [N,k] int32)."""
    vals, pos = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), torch.gather(cand, 1, pos[:, :k]).to(torch.int32)


def select_min_k_cand(d2: torch.Tensor, cand: torch.Tensor, k: int,
                      exact_rows: torch.Tensor | None = None):
    """Exact k-smallest per row with candidate ids. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise).

    ``exact_rows``, an int32 CUDA tensor of one element, gets the number of
    rows that took the kernel's exact path added to it (the kernel's two
    paths give the same result; this measures which one ran). The plain
    version has one path and leaves it as it is."""
    if select_min_k_cand.capture is not None:
        select_min_k_cand.capture.append((d2.clone(), cand.clone(), k))
    if d2.device.type == "cpu":
        return select_min_k_cand_plain(d2, cand, k)
    if d2.device.type != "cuda":
        raise ValueError(f"select_min_k_cand: unsupported device {d2.device}")
    n, w = d2.shape
    if (d2.dtype != torch.float32 or cand.dtype != torch.int32 or cand.shape != d2.shape
            or not 1 <= k <= w or w > 1024):
        raise ValueError(f"select_min_k_cand: d2 {tuple(d2.shape)} {d2.dtype}, "
                         f"cand {tuple(cand.shape)} {cand.dtype}, k={k} (W <= 1024)")
    if exact_rows is not None and (exact_rows.dtype != torch.int32 or exact_rows.numel() != 1
                                   or exact_rows.device != d2.device):
        raise ValueError("select_min_k_cand: exact_rows must be one int32 on d2's device")
    d2 = d2.contiguous()
    cand = cand.contiguous()
    vals = torch.empty(n, k, dtype=torch.float32, device=d2.device)
    idx = torch.empty(n, k, dtype=torch.int32, device=d2.device)
    err = kernels.lib().knn_select_launch(
        d2.data_ptr(), cand.data_ptr(), vals.data_ptr(), idx.data_ptr(), n, w, k,
        None if exact_rows is None else exact_rows.data_ptr(),
        torch.cuda.current_stream(d2.device).cuda_stream)
    kernels.check(err, "select_min_k_cand")
    select_min_k_cand.launches += 1
    return vals, idx


select_min_k_cand.launches = 0
select_min_k_cand.capture = None  # a list to record (d2, cand, k) of each call
