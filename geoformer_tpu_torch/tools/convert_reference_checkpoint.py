"""Import a reference PyTorch GeoFormer checkpoint (the port's copy of
tools/convert_reference_checkpoint.py: convert, convert_backbone and their
helpers, numpy only).

Maps the reference state_dict (model/geoformer/geoformer.py,
geoformer_fs.py) onto the JAX variable tree, which the port's state_dict
mirrors (weights.from_reference_state_dict carries it on):

  torch Linear weight [out, in]        -> kernel [in, out] (transposed)
  torch Conv1d k=1 weight [out, in, 1] -> kernel [in, out]
  BatchNorm1d {weight, bias, running_mean, running_var}
      -> params {scale, bias} + batch_stats {mean, var}
  nn.MultiheadAttention in_proj_weight [3d, d]
      -> q/k/v DenseGeneral kernels [d, h, dh]
  spconv SubMConv3d weight [k0, k1, k2, in, out]
      -> [27, in, out] in (dz,dy,dx)-major offset order
  pos_embedding.gauss_B -> constants (never re-drawn)

    python3 -m geoformer_tpu_torch.tools.convert_reference_checkpoint \
        --torch_ckpt ref.pth --config config/test_geoformer_scannet.yaml \
        --out converted.ckpt [--kernel_order xyz|zyx] [--mirror_kernel] [--few_shot]

writes the msgpack checkpoint that the JAX package's converter writes, which
both packages' ``--pretrain`` read.

spconv's kernel offset order: spconv 1.0 enumerates kernel positions with
the last spatial dim fastest over (d0,d1,d2) aligned with the coords
(x,y,z); the port's is (dz,dy,dx) row-major. ``--kernel_order`` flips
between the two hypotheses (``xyz`` default, ``zyx``) and
``--mirror_kernel`` applies the center-symmetry flip if the rulebook
convention is transposed; which holds is open until a real upstream
checkpoint can be scored (the JAX converter has the same question).
"""

from __future__ import annotations

import argparse

import numpy as np


def t(x):
    return np.asarray(x).T


def conv1d(x):
    return np.asarray(x)[:, :, 0].T


def subm_weight(x, kernel_order="xyz", mirror=False):
    w = np.asarray(x)
    if w.ndim == 3:  # already [K, in, out]
        k = w
    else:  # [k0,k1,k2,in,out]
        if kernel_order == "xyz":
            # (dx,dy,dz) enum -> ours (dz,dy,dx)-major: transpose spatial dims
            w = np.transpose(w, (2, 1, 0, 3, 4))
        k = w.reshape(-1, w.shape[-2], w.shape[-1])
    if mirror:
        k = k[::-1]
    return np.ascontiguousarray(k)


def bn(sd, prefix):
    return (
        {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])},
        {"mean": np.asarray(sd[f"{prefix}.running_mean"]), "var": np.asarray(sd[f"{prefix}.running_var"])},
    )


def mha(sd, prefix, d_model, nhead):
    dh = d_model // nhead
    w = np.asarray(sd[f"{prefix}.in_proj_weight"])  # [3d, d]
    b = np.asarray(sd[f"{prefix}.in_proj_bias"])
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        wi = w[i * d_model : (i + 1) * d_model].T  # [d, d] in->out
        bi = b[i * d_model : (i + 1) * d_model]
        out[name] = {"kernel": wi.reshape(d_model, nhead, dh), "bias": bi.reshape(nhead, dh)}
    out["out"] = {
        "kernel": t(sd[f"{prefix}.out_proj.weight"]),
        "bias": np.asarray(sd[f"{prefix}.out_proj.bias"]),
    }
    return out


def dense(sd, prefix):
    out = {"kernel": t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def dense_conv(sd, prefix):
    out = {"kernel": conv1d(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_backbone(sd: dict, cfg, kernel_order="xyz", mirror=False):
    """Backbone (input conv + UBlock + output BN) + semantic head subtrees.

    Split out so parity tests can convert a backbone-only state_dict (the
    full-model golden test runs the reference backbone through a CPU spconv
    shim and must not require the other heads' keys)."""
    m = cfg.m
    params: dict = {}
    stats: dict = {}
    put = _put

    sw = lambda key: subm_weight(sd[key], kernel_order, mirror)

    # ---- backbone input conv ----
    put(params, ("backbone", "input_conv"), sw("input_conv.0.weight"))

    # ---- recursive UBlock ----
    def convert_resblock(tprefix, oprefix, cin, cout):
        if cin != cout:
            # SubMConv3d k=1: [1,1,1,in,out] -> [in,out]
            w = np.asarray(sd[f"{tprefix}.i_branch.0.weight"])
            put(params, oprefix + ("i_branch",), w.reshape(w.shape[-2], w.shape[-1]))
        p0, s0 = bn(sd, f"{tprefix}.conv_branch.0")
        put(params, oprefix + ("MaskedBatchNorm_0",), p0)
        put(stats, oprefix + ("MaskedBatchNorm_0",), s0)
        put(params, oprefix + ("conv1",), sw(f"{tprefix}.conv_branch.2.weight"))
        p1, s1 = bn(sd, f"{tprefix}.conv_branch.3")
        put(params, oprefix + ("MaskedBatchNorm_1",), p1)
        put(stats, oprefix + ("MaskedBatchNorm_1",), s1)
        put(params, oprefix + ("conv2",), sw(f"{tprefix}.conv_branch.5.weight"))

    def convert_ublock(tprefix, oprefix, planes):
        c0 = planes[0]
        for i in range(cfg.block_reps):
            cin = c0 if i > 0 else c0  # head blocks keep width at this level
            convert_resblock(f"{tprefix}.blocks.block{i}", oprefix + (f"block{i}",), cin, c0)
        if len(planes) > 1:
            c1 = planes[1]
            pb, sb = bn(sd, f"{tprefix}.conv.0")
            put(params, oprefix + ("conv_bn",), pb)
            put(stats, oprefix + ("conv_bn",), sb)
            put(params, oprefix + ("conv_w",), subm_weight(sd[f"{tprefix}.conv.2.weight"], kernel_order, mirror))
            convert_ublock(f"{tprefix}.u", oprefix + ("u",), planes[1:])
            pd, sdn = bn(sd, f"{tprefix}.deconv.0")
            put(params, oprefix + ("deconv_bn",), pd)
            put(stats, oprefix + ("deconv_bn",), sdn)
            put(params, oprefix + ("deconv_w",), subm_weight(sd[f"{tprefix}.deconv.2.weight"], kernel_order, mirror))
            for i in range(cfg.block_reps):
                convert_resblock(
                    f"{tprefix}.blocks_tail.block{i}", oprefix + (f"block_tail{i}",),
                    c0 * (2 - i), c0,
                )
        if f"{tprefix}.before_transformer_linear.weight" in sd:
            put(params, oprefix + ("before_transformer_linear",), dense(sd, f"{tprefix}.before_transformer_linear"))
            put(params, oprefix + ("after_transformer_linear",), dense(sd, f"{tprefix}.after_transformer_linear"))
            # bottleneck transformer internals
            tf = f"{tprefix}.transformer"
            put(params, oprefix + ("transformer", "position_linear"), dense(sd, f"{tf}.position_linear"))
            for li in range(2):
                lp = f"{tf}.layers.{li}"
                for norm_i, name in ((1, f"norm1_{li}"), (2, f"norm2_{li}")):
                    put(params, oprefix + ("transformer", name), {
                        "alpha": np.asarray(sd[f"{lp}.norm_{norm_i}.alpha"]),
                        "bias": np.asarray(sd[f"{lp}.norm_{norm_i}.bias"]),
                    })
                attn = {}
                for tname, oname in (("q_linear", "q"), ("k_linear", "k"), ("v_linear", "v")):
                    w = t(sd[f"{lp}.attn_1.{tname}.weight"])
                    b = np.asarray(sd[f"{lp}.attn_1.{tname}.bias"])
                    d_model = w.shape[0]
                    dh = d_model // 4
                    attn[oname] = {"kernel": w.reshape(d_model, 4, dh), "bias": b.reshape(4, dh)}
                attn["out"] = dense(sd, f"{lp}.attn_1.out")
                put(params, oprefix + ("transformer", f"attn_{li}"), attn)
                put(params, oprefix + ("transformer", f"ff1_{li}"), dense(sd, f"{lp}.ff.linear_1"))
                put(params, oprefix + ("transformer", f"ff2_{li}"), dense(sd, f"{lp}.ff.linear_2"))
            put(params, oprefix + ("transformer", "norm_out"), {
                "alpha": np.asarray(sd[f"{tf}.norm.alpha"]),
                "bias": np.asarray(sd[f"{tf}.norm.bias"]),
            })

    planes = [m * (i + 1) for i in range(cfg.tpu_unet_depth)]
    convert_ublock("unet", ("backbone", "unet"), planes)

    po, so = bn(sd, "output_layer.0")
    put(params, ("backbone", "output_bn"), po)
    put(stats, ("backbone", "output_bn"), so)

    # ---- semantic head ----
    put(params, ("semantic", "Dense_0"), dense(sd, "semantic.0"))
    p, s = bn(sd, "semantic.1")
    put(params, ("semantic", "MaskedBatchNorm_0"), p)
    put(stats, ("semantic", "MaskedBatchNorm_0"), s)
    put(params, ("semantic", "Dense_1"), dense(sd, "semantic.3"))
    p, s = bn(sd, "semantic.4")
    put(params, ("semantic", "MaskedBatchNorm_1"), p)
    put(stats, ("semantic", "MaskedBatchNorm_1"), s)
    put(params, ("semantic", "Dense_2"), dense(sd, "semantic_linear"))
    return params, stats


def convert(sd: dict, cfg, kernel_order="xyz", mirror=False, few_shot=False):
    """Returns (params, batch_stats, constants) trees in our naming."""
    dec = cfg.dec_dim
    params, stats = convert_backbone(sd, cfg, kernel_order, mirror)
    consts: dict = {}
    put = _put

    # ---- mask tower ----
    for i in range(3):
        put(params, (f"mask_tower{i}", "Dense_0"), dense_conv(sd, f"mask_tower.{i}.0"))
        p, s = bn(sd, f"mask_tower.{i}.1")
        put(params, (f"mask_tower{i}", "MaskedBatchNorm_0"), p)
        put(stats, (f"mask_tower{i}", "MaskedBatchNorm_0"), s)
    put(params, ("mask_out",), dense_conv(sd, "mask_tower.3"))

    # ---- set aggregator SharedMLP ----
    for i in range(3):
        put(params, ("set_aggregator", "mlp", f"layer{i}"), {
            "kernel": np.asarray(sd[f"set_aggregator.mlp_module.layer{i}.conv.weight"])[:, :, 0, 0].T
        })
        p = {
            "scale": np.asarray(sd[f"set_aggregator.mlp_module.layer{i}.bn.bn.weight"]),
            "bias": np.asarray(sd[f"set_aggregator.mlp_module.layer{i}.bn.bn.bias"]),
        }
        s = {
            "mean": np.asarray(sd[f"set_aggregator.mlp_module.layer{i}.bn.bn.running_mean"]),
            "var": np.asarray(sd[f"set_aggregator.mlp_module.layer{i}.bn.bn.running_var"]),
        }
        put(params, ("set_aggregator", "mlp", f"bn{i}"), p)
        put(stats, ("set_aggregator", "mlp", f"bn{i}"), s)

    # ---- pos embedding ----
    put(consts, ("pos_embedding",), {"gauss_B": np.asarray(sd["pos_embedding.gauss_B"])})

    # ---- projections ----
    put(params, ("query_projection", "Dense_0"), dense_conv(sd, "query_projection.layers.0"))
    put(params, ("query_projection", "Dense_1"), dense_conv(sd, "query_projection.layers.2"))
    put(params, ("encoder_to_decoder_projection", "Dense_0"), dense_conv(sd, "encoder_to_decoder_projection.layers.0"))
    p, s = bn(sd, "encoder_to_decoder_projection.layers.1")
    put(params, ("encoder_to_decoder_projection", "MaskedBatchNorm_0"), p)
    put(stats, ("encoder_to_decoder_projection", "MaskedBatchNorm_0"), s)
    put(params, ("encoder_to_decoder_projection", "Dense_1"), dense_conv(sd, "encoder_to_decoder_projection.layers.3"))
    p, s = bn(sd, "encoder_to_decoder_projection.layers.4")
    put(params, ("encoder_to_decoder_projection", "MaskedBatchNorm_1"), p)
    put(stats, ("encoder_to_decoder_projection", "MaskedBatchNorm_1"), s)

    # ---- detr_sem_head (supervised) ----
    if "detr_sem_head.layers.0.weight" in sd:
        put(params, ("detr_sem_head", "Dense_0"), dense_conv(sd, "detr_sem_head.layers.0"))
        p, s = bn(sd, "detr_sem_head.layers.1")
        put(params, ("detr_sem_head", "MaskedBatchNorm_0"), p)
        put(stats, ("detr_sem_head", "MaskedBatchNorm_0"), s)
        put(params, ("detr_sem_head", "Dense_1"), dense_conv(sd, "detr_sem_head.layers.3"))
        p, s = bn(sd, "detr_sem_head.layers.4")
        put(params, ("detr_sem_head", "MaskedBatchNorm_1"), p)
        put(stats, ("detr_sem_head", "MaskedBatchNorm_1"), s)
        put(params, ("detr_sem_head", "Dense_2"), dense_conv(sd, "detr_sem_head.layers.6"))

    # ---- similarity net (FS) ----
    if few_shot and "similarity_net.0.weight" in sd:
        put(params, ("similarity_net", "Dense_0"), dense(sd, "similarity_net.0"))
        p, s = bn(sd, "similarity_net.1")
        put(params, ("similarity_net", "MaskedBatchNorm_0"), p)
        put(stats, ("similarity_net", "MaskedBatchNorm_0"), s)
        put(params, ("similarity_net", "Dense_1"), dense(sd, "similarity_net.3"))
        p, s = bn(sd, "similarity_net.4")
        put(params, ("similarity_net", "MaskedBatchNorm_1"), p)
        put(stats, ("similarity_net", "MaskedBatchNorm_1"), s)
        put(params, ("similarity_net", "Dense_2"), dense(sd, "similarity_net.6"))

    # ---- controller ----
    put(params, ("controller_head", "before_embedding", "Dense_0"), dense_conv(sd, "before_embedding_tower.0.0"))
    p, s = bn(sd, "before_embedding_tower.0.1")
    put(params, ("controller_head", "before_embedding", "MaskedBatchNorm_0"), p)
    put(stats, ("controller_head", "before_embedding", "MaskedBatchNorm_0"), s)
    put(params, ("controller_head", "controller"), dense_conv(sd, "controller"))

    # ---- decoder ----
    for li in range(cfg.dec_nlayers):
        lp = f"decoder.layers.{li}"
        op = ("decoder", f"layer{li}")
        put(params, op + ("self_attn",), mha(sd, f"{lp}.self_attn", dec, cfg.dec_nhead))
        for tname, oname in (("norm1", "norm1"), ("norm2", "norm2"), ("norm3", "norm3")):
            put(params, op + (oname,), {
                "scale": np.asarray(sd[f"{lp}.{tname}.weight"]),
                "bias": np.asarray(sd[f"{lp}.{tname}.bias"]),
            })
        put(params, op + ("attn_mlp0",), dense(sd, f"{lp}.attn_mlp.0"))
        put(params, op + ("attn_mlp1",), dense(sd, f"{lp}.attn_mlp.2"))
        put(params, op + ("v_mlp",), dense(sd, f"{lp}.v_mlp.0"))
        put(params, op + ("out_mlp",), dense(sd, f"{lp}.out_mlp.0"))
        put(params, op + ("linear1",), dense(sd, f"{lp}.linear1"))
        put(params, op + ("linear2",), dense(sd, f"{lp}.linear2"))
    put(params, ("decoder", "norm"), {
        "scale": np.asarray(sd["decoder.norm.weight"]),
        "bias": np.asarray(sd["decoder.norm.bias"]),
    })

    return params, stats, consts


def main(argv=None) -> str:
    """Read the .pth (its ``state_dict`` when it has one), convert, write
    the msgpack checkpoint; returns the output path."""
    ap = argparse.ArgumentParser(description="import a reference PyTorch GeoFormer checkpoint")
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kernel_order", default="xyz", choices=["xyz", "zyx"])
    ap.add_argument("--mirror_kernel", action="store_true")
    ap.add_argument("--few_shot", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from geoformer_tpu_torch.config import load_config
    from geoformer_tpu_torch.weights import write_msgpack

    cfg = load_config(args.config)
    ckpt = torch.load(args.torch_ckpt, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    params, stats, consts = convert(sd, cfg, args.kernel_order, args.mirror_kernel, args.few_shot)
    write_msgpack(args.out, {"params": params, "batch_stats": stats, "constants": consts,
                             "epoch": int(ckpt.get("epoch", 0))})
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
