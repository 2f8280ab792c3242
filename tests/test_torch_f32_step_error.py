"""How far a float32 training step is from float64, in the JAX package and in
the port (a measurement run by hand, not a test: it defines no test).

    JAX_PLATFORMS=cpu python tests/test_torch_f32_step_error.py [--out FILE]

One full-phase training step on ``chip_smoke.small_train_inputs`` (two
scenes of 4,096 points at the published U-Net depth of 7 levels, seeded
weights, the foreground class biased on), the same subsample draws in both
packages (``tests/torch_dist_worker.py``'s), no dropout: the port's step in
float32 and float64, the JAX package's step in float32 and, under
``jax_enable_x64``, with float64 parameters and batch. Prints, for each pair,
the worst gradient leaves by max |a - b| / max(1, |b|inf) and the median
leaf.

The JAX package is not written for x64: under it this script casts the
slice indices of ``dynamic_slice`` / ``dynamic_update_slice`` to int32, runs
FPS, the geodesic solve and the auction matcher on float32 inputs (their
loop carries are float32; FPS and the matcher return indices, and no
gradient reaches a parameter through the geodesic table), and uses the
rulebook conv and the ``topk`` selection (exact layouts of the brick conv
and the Pallas selection, which fix float32 products). MaskedBatchNorm's
statistics, the U-Net's output and the dynamic conv's products stay
float32 inside the JAX package's x64 step, so that step is not a float64
reference; the port's float64 step is, and the JAX float32 step is held
against it too.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, path=()):
    import numpy as np

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree, np.float64)


def _errors(got, want) -> dict:
    import numpy as np

    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w), set(g) ^ set(w)
    return {k: float(np.abs(g[k] - w[k]).max()) / max(1.0, float(np.abs(w[k]).max()))
            for k in w}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the result here as JSON")
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    import geoformer_tpu.models.aggregator as jagg
    import geoformer_tpu.models.geoformer as jgf
    import geoformer_tpu.models.unet as junet
    import geoformer_tpu_torch.models.geoformer as gf
    from geoformer_tpu.losses import InstSetCriterion
    from geoformer_tpu.utils.config import load_config as jax_load_config
    from geoformer_tpu_torch import config as cfg_mod
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.synthetic import synthetic_batch
    from geoformer_tpu_torch.weights import _head_counts, _to_tree, to_jax_variables
    from torch_dist_worker import ROTATION, draw_table, port_pack

    def float32_in(fn):
        """fn on float32 copies of its floating arguments, floating results
        back in the first floating argument's dtype."""
        def is_float(x):
            return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)

        def wrapped(*a, **k):
            dt = next(x.dtype for x in (*a, *k.values()) if is_float(x))
            to32 = lambda x: x.astype(jnp.float32) if is_float(x) else x
            out = fn(*map(to32, a), **{kk: to32(v) for kk, v in k.items()})
            return jax.tree_util.tree_map(lambda y: y.astype(dt) if is_float(y) else y, out)
        return wrapped

    def jax_pack(mask, capacity, rng):
        p = mask.shape[0]
        if capacity >= p:
            n = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)
            pos = jnp.arange(p, dtype=jnp.int32)
            idx = jnp.where(pos < n, (pos + ROTATION % n) % n, pos)
            return idx, mask[idx]
        scores = jnp.where(mask, jnp.asarray(draw_table(p, capacity)), 2.0)
        idx = jnp.argsort(scores)[:capacity].astype(jnp.int32)
        return idx, mask[idx]

    class NoDrop(junet.BottleneckTransformer):
        dropout: float = 0.0

    ds, dus = jax.lax.dynamic_slice, jax.lax.dynamic_update_slice
    i32 = lambda idx: tuple(jnp.asarray(i, jnp.int32) for i in idx)
    jax.lax.dynamic_slice = lambda op, idx, sizes: ds(op, i32(idx), sizes)
    jax.lax.dynamic_update_slice = lambda op, up, idx: dus(op, up, i32(idx))
    jgf.random_pack_by_mask = jax_pack
    jgf.geodesic_distance_hier = float32_in(jgf.geodesic_distance_hier)
    jagg.furthest_point_sample = float32_in(jagg.furthest_point_sample)
    junet.BottleneckTransformer = NoDrop
    gf.random_pack_by_mask = port_pack

    inp = cs.small_train_inputs(torch, cfg_mod, synthetic_batch)
    cfg, batch, sd = inp["cfg"], inp["batch"], inp["sd"]
    port = {dt: cs.small_train_step(torch, Engine, cfg, sd, batch, "cpu", dt)
            for dt in (torch.float32, torch.float64)}
    model = Engine(cfg, device="cpu", state_dict=sd).model
    heads = _head_counts(model)
    variables = to_jax_variables(model)

    jcfg = jax_load_config(None, **{k: v for k, v in cfg.to_dict().items() if k != "config"})
    jcfg = jcfg.replace(tpu_brick_occupancy=0, tpu_knn_select="topk")
    jm = jgf.GeoFormer(jgf.ModelConfig.from_cfg(jcfg))
    crit = InstSetCriterion(jcfg)
    crit._assign = float32_in(crit._assign)
    rngs = {"sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

    def step(params, stats, consts, b):
        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": stats, "constants": consts}, b,
                              train=True, rngs=rngs, mutable=["batch_stats"])
            return crit(out, b, 1)[0]
        return jax.value_and_grad(loss_fn)(params)

    jres = {}
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dt)), t)
        jb = {k: jnp.asarray(v.astype(dt) if np.issubdtype(v.dtype, np.floating) else v)
              for k, v in batch.items()}
        loss, g = jax.jit(step)(cast(variables["params"]), cast(variables["batch_stats"]),
                                cast(variables["constants"]), jb)
        jres[name] = (float(loss), jax.tree_util.tree_map(np.asarray, g))

    p32, p64 = (_to_tree(port[dt]["grads"].items(), heads, split_collections=False)
                for dt in (torch.float32, torch.float64))
    pairs = {"port32_vs_port64": (p32, p64),
             "jax32_vs_jax64": (jres["f32"][1], jres["f64"][1]),
             "jax32_vs_port64": (jres["f32"][1], p64),
             "jax64_vs_port64": (jres["f64"][1], p64),
             "jax32_vs_port32": (jres["f32"][1], p32)}
    res = {"losses": {"port32": port[torch.float32]["loss"],
                      "port64": port[torch.float64]["loss"],
                      "jax32": jres["f32"][0], "jax64": jres["f64"][0]},
           "unet_depth": cfg.tpu_unet_depth, "points": cfg.tpu_max_points}
    for name, (a, b) in pairs.items():
        e = _errors(a, b)
        res[name] = {"worst": sorted(e.items(), key=lambda kv: -kv[1])[:5],
                     "median": float(np.median(list(e.values())))}
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
