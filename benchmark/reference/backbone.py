"""The backbone and semantic head, as functions of a dict of weights named
as the model names them (a state dict).

Voxel features are [N, C] over a level's voxels (``voxels.Level``). A
sparse convolution sums, for each kernel offset, the input voxel's
features times that offset's weight into the output voxel it pairs with:
3x3x3 submanifold convs over a level's own voxels, a stride-2 conv from
the children of a cell to the cell, and its transpose back. Where the
configuration narrows them (``tpu_compute_dtype: bfloat16``), a conv's
features and weights are rounded to that type, products and sums stay in
float32, and the gradients of those operands come out rounded to it too:
the gradient of each row read, before it is summed into its row in
float32, and that sum.

The U-Net: per level of width m * (level + 1), two residual blocks
(BN-ReLU-conv-BN-ReLU-conv plus the input, through a 1x1 weight where the
widths differ), then, but at the deepest level, BN-ReLU-stride-2 conv, the
next level, BN-ReLU-transposed conv, concatenation with the level's input
and two residual blocks; the two deepest levels end with a transformer
over their voxels. Batch norms take the statistics of the batch's voxels
or points (eps 1e-4). The transformer (width 128, 4 heads, feed-forward
64, 2 pre-norm layers, dropout 0.1 on each residual branch) runs on a
scene's voxels; its dropout masks are drawn on [scenes, capacity, width]
tensors that hold each voxel at its rank in its scene, the level's
capacity being ``tpu_max_voxels`` times ``tpu_voxel_decay`` to the level.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.voxels import build_levels

BN_EPS = 1e-4
NORM_EPS = 1e-6
D_MODEL, HEADS, LAYERS, DROPOUT = 128, 4, 2, 0.1


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x's values rounded to ``dtype`` and back to float32; a float8 type
    scales the tensor by its largest magnitude first, as float8 training
    does. None leaves x as it is."""
    if dtype is None:
        return x
    if dtype.itemsize == 1:
        amax = x.detach().abs().max().clamp(min=1e-30)
        s = torch.finfo(dtype).max / amax
        return (x * s).to(dtype).float() / s
    return x.to(dtype).float()


class PairConv(torch.autograd.Function):
    """out[o] += x[i] @ w[k] for each pair (o, i) of offset k."""

    @staticmethod
    def forward(ctx, x, w, pairs, n_out, narrow, grad_narrow):
        xn, wn = round_to(x, narrow), round_to(w, narrow)
        out = x.new_zeros(n_out, w.shape[-1])
        for k, (o, i) in enumerate(pairs):
            if o.numel():
                out.index_add_(0, o, xn[i] @ wn[k])
        ctx.xn, ctx.wn, ctx.pairs, ctx.grad_narrow = xn, wn, pairs, grad_narrow
        return out

    @staticmethod
    def backward(ctx, g):
        xn, wn, r = ctx.xn, ctx.wn, ctx.grad_narrow
        gx, gw = torch.zeros_like(xn), torch.zeros_like(wn)
        for k, (o, i) in enumerate(ctx.pairs):
            if o.numel():
                go = g[o]
                # the gradient of each narrowed row read, summed into its row
                gx.index_add_(0, i, round_to(go @ wn[k].T, r))
                gw[k] = xn[i].T @ go
        return round_to(gx, r), round_to(gw, r), None, None, None, None


def _grad_type(narrow):
    """The type the gradients of narrowed operands come out in: the operand
    type itself, float8 e5m2 for a float8 one."""
    if narrow is not None and narrow.itemsize == 1:
        return torch.float8_e5m2
    return narrow


def batch_norm(x, w: dict, name: str):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[f"{name}.scale"] + w[f"{name}.bias"]


def linear(x, w: dict, name: str):
    out = x @ w[f"{name}.weight"].T
    bias = w.get(f"{name}.bias")
    return out if bias is None else out + bias


def simple_norm(x, w: dict, name: str):
    """(x - mean) / (unbiased std + eps) over the features."""
    mean = x.mean(-1, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).sum(-1, keepdim=True) / (x.shape[-1] - 1))
    return w[f"{name}.alpha"] * (x - mean) / (std + NORM_EPS) + w[f"{name}.bias"]


class Backbone:
    """The forward of one batch; ``semantic_scores`` [B * P, classes] at the
    valid points' flat indices."""

    def __init__(self, cfg, weights: dict, narrow=None, training: bool = True):
        self.cfg, self.w, self.training = cfg, weights, training
        self.narrow, self.grad_narrow = narrow, _grad_type(narrow)
        self.depth = cfg.tpu_unet_depth
        self.caps = [math.ceil(cfg.tpu_max_voxels * cfg.tpu_voxel_decay ** lvl)
                     for lvl in range(self.depth)]

    def conv(self, x, name, pairs, n_out):
        return PairConv.apply(x, self.w[name], pairs, n_out, self.narrow, self.grad_narrow)

    def residual(self, x, pre: str, lvl: int):
        level = self.levels[lvl]
        n = x.shape[0]
        skip = x @ self.w[f"{pre}.i_branch"] if f"{pre}.i_branch" in self.w else x
        h = F.relu(batch_norm(x, self.w, f"{pre}.MaskedBatchNorm_0"))
        h = self.conv(h, f"{pre}.conv1", level.subm, n)
        h = F.relu(batch_norm(h, self.w, f"{pre}.MaskedBatchNorm_1"))
        return self.conv(h, f"{pre}.conv2", level.subm, n) + skip

    def padded(self, x, lvl: int):
        level = self.levels[lvl]
        out = x.new_zeros(len(level.per_scene), self.caps[lvl], x.shape[-1])
        return out.index_put((level.scene, level.slot), x)

    def drop(self, x, lvl: int):
        """Dropout of voxel rows x [N, C], its mask drawn on the level's
        padded layout."""
        if not self.training:
            return x
        level = self.levels[lvl]
        return F.dropout(self.padded(x, lvl), DROPOUT, True)[level.scene, level.slot]

    def attention(self, x, pre: str, lvl: int):
        level = self.levels[lvl]
        d_head = D_MODEL // HEADS
        q, k, v = (linear(x, self.w, f"{pre}.{p}") for p in "qkv")
        out = torch.empty_like(q)
        start = 0
        for n in level.per_scene.tolist():
            sl = slice(start, start + n)
            qs, ks, vs = (t[sl].reshape(n, HEADS, d_head).transpose(0, 1) for t in (q, k, v))
            att = torch.softmax(qs @ ks.transpose(1, 2) / math.sqrt(d_head), dim=-1)
            out[sl] = (att @ vs).transpose(0, 1).reshape(n, D_MODEL)
            start += n
        return linear(out, self.w, f"{pre}.out")

    def transformer(self, x, pre: str, lvl: int):
        level, w = self.levels[lvl], self.w
        xyz = level.zyx.flip(1).to(x.dtype)
        centre = torch.zeros(len(level.per_scene), 3, dtype=x.dtype, device=x.device)
        centre = centre.index_add(0, level.scene, xyz) / level.per_scene.clamp(min=1)[:, None]
        h = linear(x, w, f"{pre}.before_transformer_linear")
        h = h + linear(xyz - centre[level.scene], w, f"{pre}.transformer.position_linear")
        t = f"{pre}.transformer"
        for i in range(LAYERS):
            a = simple_norm(h, w, f"{t}.norm1_{i}")
            h = h + self.drop(self.attention(a, f"{t}.attn_{i}", lvl), lvl)
            a = simple_norm(h, w, f"{t}.norm2_{i}")
            f = self.drop(F.relu(linear(a, w, f"{t}.ff1_{i}")), lvl)
            h = h + self.drop(linear(f, w, f"{t}.ff2_{i}"), lvl)
        h = simple_norm(h, w, f"{t}.norm_out")
        return linear(h, w, f"{pre}.after_transformer_linear")

    def unet(self, x, lvl: int):
        pre = "backbone.unet" + ".u" * lvl
        level = self.levels[lvl]
        for i in range(2):
            x = self.residual(x, f"{pre}.block{i}", lvl)
        if lvl < self.depth - 1:
            nxt = self.levels[lvl + 1]
            down = [((level.child_offset == k).nonzero().flatten(),) for k in range(8)]
            down = [(level.parent[c], c) for (c,) in down]
            up = [(c, p) for p, c in down]
            d = F.relu(batch_norm(x, self.w, f"{pre}.conv_bn"))
            d = self.unet(self.conv(d, f"{pre}.conv_w", down, nxt.scene.numel()), lvl + 1)
            u = F.relu(batch_norm(d, self.w, f"{pre}.deconv_bn"))
            x = torch.cat([x, self.conv(u, f"{pre}.deconv_w", up, x.shape[0])], dim=1)
            for i in range(2):
                x = self.residual(x, f"{pre}.block_tail{i}", lvl)
        if lvl >= self.depth - 2:
            x = self.transformer(x, pre, lvl)
        return x

    def __call__(self, batch: dict) -> dict:
        cfg, w = self.cfg, self.w
        self.levels, scene, voxel, flat = build_levels(batch["coords"], batch["point_mask"],
                                                       self.depth, cfg.tpu_spatial_shape)
        for lvl, level in enumerate(self.levels):
            if int(level.per_scene.max()) > self.caps[lvl]:
                raise ValueError(f"level {lvl} holds more voxels than its capacity")
        feats = batch["feats"].reshape(-1, batch["feats"].shape[-1])[flat]
        if cfg.use_coords:
            feats = torch.cat([feats, batch["points"].reshape(-1, 3)[flat]], dim=1)
        level0 = self.levels[0]
        n0 = level0.scene.numel()
        count = torch.bincount(voxel, minlength=n0).to(feats.dtype)
        mean = feats.new_zeros(n0, feats.shape[1]).index_add(0, voxel, feats) / count[:, None]
        x = self.conv(mean, "backbone.input_conv", level0.subm, n0)
        x = F.relu(batch_norm(self.unet(x, 0), w, "backbone.output_bn"))
        h = x[voxel]
        for i in range(2):
            h = F.relu(batch_norm(linear(h, w, f"semantic.Dense_{i}"), w,
                                  f"semantic.MaskedBatchNorm_{i}"))
        return {"semantic_scores": linear(h, w, "semantic.Dense_2"), "flat": flat}
