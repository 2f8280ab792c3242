"""Submanifold 3x3x3 sparse conv on the card: CUDA kernel K4
(csrc/subm_conv.cu), its three launches (forward, input gradient, weight
gradient) and the autograd Function that joins them.

The JAX package has no Pallas kernel for this op (XLA gathers and a dot,
geoformer_tpu/ops/sparse_conv.py:subm_conv). The plain version is
``ops/sparse_conv.py:subm_conv_plain``, the port's rulebook conv as it
stood before the kernels, and CPU tensors take it there (``apply_subm``):
offsets in chunks of 128 // Cin, each chunk's neighbour rows gathered into
a [B, V, c, Cin] buffer, widened to float32 and multiplied in one GEMM,
its gradients by autograd. The kernels compute the same products and sums
without the buffers: see the source's note for the design and the bound.
These launches take CUDA tensors and raise for anything else; none falls
back.

Precision: ``compute_dtype`` bf16 rounds the features and the weights to
bf16; products and sums are float32 and the output is float32. The input
gradient rounds each read's gradient (one offset's product) to bf16 before
its float32 sum, and the sum; the weight gradient is rounded to bf16. The
plain version's autograd also rounds each chunk's sum before the chunks
are added, which the kernel does not. ``kernels/edge_cases.py:subm_check``
holds the two to a float64 reference.

A map is a rulebook: entry [b, o, k] is the row of scene b that row o
reads through offset k, or V (the zero row), and each (row, offset) is read
by at most one row. ``n_voxels`` [B], where given, promises that rows at or
past it neither read nor are read (a plan's voxel slots past the scene's
count); the kernels skip them.
"""

from __future__ import annotations

import math

import torch

from geoformer_tpu_torch import kernels

OFFSETS = 27
MAX_COUT_MMA = 112  # the tensor-core forward keeps at most 14 n-tiles of 8
WGRAD_BLOCKS = 4096  # weight-gradient blocks aimed at (27 offsets x slices x tiles)



def _card_args(name, compute_dtype, n_voxels, rows, maps, w):
    """Check what the kernels take (raise ValueError otherwise); -> the
    narrow flag and n_voxels' pointer (0 for none)."""
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    b, v = maps[0].shape[:2]
    k, cin, cout = w.shape
    bad = [f"w {tuple(w.shape)} {w.dtype}"] if (
        k != OFFSETS or w.dtype != torch.float32 or not w.is_contiguous()) else []
    for label, t, width in rows:
        if (t.dtype != torch.float32 or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != (b, v, width)):
            bad.append(f"{label} {tuple(t.shape)} {t.dtype} on {t.device}")
    for t in maps:
        if (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != (b, v, OFFSETS)):
            bad.append(f"map {tuple(t.shape)} {t.dtype} on {t.device}")
    if n_voxels is not None and (n_voxels.dtype != torch.int32 or n_voxels.device != dev
                                 or tuple(n_voxels.shape) != (b,)):
        bad.append(f"n_voxels {tuple(n_voxels.shape)} {n_voxels.dtype} on {n_voxels.device}")
    if compute_dtype not in (None, torch.bfloat16):
        bad.append(f"compute_dtype {compute_dtype}")
    if bad:
        raise ValueError(f"{name}: the kernel takes float32 rows, int32 [B,V,27] maps and "
                         f"float32 [27,Cin,Cout] weights, contiguous on one card; got "
                         + ", ".join(bad))
    return int(compute_dtype is not None), 0 if n_voxels is None else n_voxels.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def subm_fwd(feats, nbr, w, compute_dtype=None, n_voxels=None):
    """[B,V,Cout] float32: the kernel (bf16: tensor cores, Cout <= 112;
    float32: FMA)."""
    b, v, cin = feats.shape
    cout = w.shape[-1]
    flag, nv = _card_args("subm_conv", compute_dtype, n_voxels, [("feats", feats, cin)],
                          [nbr], w)
    if flag and cout > MAX_COUT_MMA:
        raise ValueError(f"subm_conv: the bf16 kernel takes Cout <= {MAX_COUT_MMA}, got {cout}")
    out = torch.empty(b, v, cout, dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    err = kernels.lib().subm_conv_fwd_launch(feats.data_ptr(), nbr.data_ptr(), nv, w.data_ptr(),
                                             out.data_ptr(), b, v, cin, cout, flag,
                                             _stream(feats))
    kernels.check(err, "subm_conv")
    subm_fwd.launches += 1
    return out


def subm_dgrad(grad, nbr_t, w, compute_dtype=None, n_voxels=None):
    """The input gradient [B,V,Cin] float32: the kernel over the transposed
    map nbr_t (``ops/sparse_conv.py:transpose_map``)."""
    if nbr_t is None:
        raise ValueError("subm_conv_dgrad: the input gradient needs the transposed map")
    b, v, cout = grad.shape
    cin = w.shape[1]
    flag, nv = _card_args("subm_conv_dgrad", compute_dtype, n_voxels, [("grad", grad, cout)],
                          [nbr_t], w)
    dx = torch.empty(b, v, cin, dtype=torch.float32, device=grad.device)
    if dx.numel() == 0:
        return dx
    err = kernels.lib().subm_conv_dgrad_launch(grad.data_ptr(), nbr_t.data_ptr(), nv,
                                               w.data_ptr(), dx.data_ptr(), b, v, cin, cout,
                                               flag, _stream(grad))
    kernels.check(err, "subm_conv_dgrad")
    subm_dgrad.launches += 1
    return dx


def wgrad_slices(b: int, v: int, cin: int, cout: int) -> int:
    """Row-tile slices of the weight gradient: about WGRAD_BLOCKS blocks,
    at most one slice a 64-row tile."""
    tiles = math.ceil(cin / 32) * math.ceil(cout / 32)
    return max(1, min(b * math.ceil(v / 64), math.ceil(WGRAD_BLOCKS / (OFFSETS * tiles))))


def subm_wgrad(feats, nbr, grad, w, compute_dtype=None, n_voxels=None):
    """The weight gradient [27,Cin,Cout] float32 (bf16 values for bf16
    operands): the kernel's partial sums and their fixed-order reduction,
    one count."""
    b, v, cin = feats.shape
    cout = w.shape[-1]
    flag, nv = _card_args("subm_conv_wgrad", compute_dtype, n_voxels,
                          [("feats", feats, cin), ("grad", grad, cout)], [nbr], w)
    if b * v == 0:
        return torch.zeros_like(w)
    slices = wgrad_slices(b, v, cin, cout)
    partial = torch.empty(slices, OFFSETS, cin, cout, dtype=torch.float32, device=w.device)
    dw = torch.empty_like(w)
    err = kernels.lib().subm_conv_wgrad_launch(feats.data_ptr(), grad.data_ptr(), nbr.data_ptr(),
                                               nv, partial.data_ptr(), dw.data_ptr(), b, v, cin,
                                               cout, slices, flag, _stream(w))
    kernels.check(err, "subm_conv_wgrad")
    subm_wgrad.launches += 1
    return dw


for _fn in (subm_fwd, subm_dgrad, subm_wgrad):
    _fn.launches = 0


class SubmConv(torch.autograd.Function):
    """The conv with its two gradients, each through its launch above; the
    input gradient needs the transposed map (None where no gradient will
    be taken)."""

    @staticmethod
    def forward(ctx, feats, w, nbr, nbr_t, n_voxels, compute_dtype):
        ctx.save_for_backward(feats, w, nbr, nbr_t, n_voxels)
        ctx.compute_dtype = compute_dtype
        return subm_fwd(feats, nbr, w, compute_dtype, n_voxels)

    @staticmethod
    def backward(ctx, grad):
        feats, w, nbr, nbr_t, n_voxels = ctx.saved_tensors
        cd = ctx.compute_dtype
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = subm_dgrad(grad, nbr_t, w, cd, n_voxels)
        if ctx.needs_input_grad[1]:
            dw = subm_wgrad(feats, nbr, grad, w, cd, n_voxels)
        return dx, dw, None, None, None, None

