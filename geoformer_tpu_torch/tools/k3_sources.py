"""K3 (csrc/row_gather.cu) built from several sources timed on the same
gathers in one process on the card, beside the tree's own kernel.

    python3 -m geoformer_tpu_torch.tools.k3_sources \\
        --source parent=build/parent_row_gather.cu \\
        --order parent,rows,per_unit,per_unit,rows,parent

Each ``--source`` is compiled alone with the port's nvcc flags into build/
and launched through its C entry point (``row_gather_launch``); the tree's
own kernel runs through ``kernels/row_gather.py`` (``rows``) and through
its per-unit entry point (``per_unit``: one unit a thread at any width).
The ptxas report of each source is printed. The gathers: the TPU probe's
([512,128] by 256), the eval forward's foreground gather ([250000,16] by
131,072 ids of one synthetic scene), one block's slab of the geodesic fine
sweep (4,096 ids, spatially sorted neighbours, into [131073, Q] at the
training config's Q = 128 and at the eval's 256; ``sweep_slab``), and each
width class of the design at [250000, q] by 131,072 random ids. On each,
every source and the tree's kernel is held bit-equal to the plain version,
then timed by torch.profiler's device time (``tools/profiling.py``
``device_ms``) with the L2 flushed by a write (``ms``) and by a read
(``l2_clean``) before every call and warm (``l2_warm``), in the
``--order`` given, beside the plain version and ``torch.index_select``.
One JSON line a gather.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from geoformer_tpu_torch import kernels
from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain
from geoformer_tpu_torch.tools.k1_sources import compile_source
from geoformer_tpu_torch.tools.profiling import compare

# edge slots a slab of the fine sweep (ops/geodesic.py _block_sweeps)
SWEEP_SLAB = 8
WIDTHS = (1, 3, 4, 7, 8, 16, 128, 256, 1000)


def fg_gather_inputs(engine, batch):
    """The eval forward's foreground gather, gather_rows(point_feats,
    fg_idx), of scene 0: (point_feats [P, C] f32, fg_idx [F] i32)."""
    with torch.no_grad():
        tb = engine.to_device(batch)
        point_feats, _, semantic_preds, _ = engine.model.forward_backbone(tb)
        fg_idx, _ = engine.model.foreground_pack(semantic_preds, tb["point_mask"])
    return point_feats[0].contiguous(), fg_idx[0].to(torch.int32)


def sweep_slab(engine, batch, q: int, slab: int = 0, seed: int = 0):
    """One block's slab of the geodesic fine sweep's gather
    ``dist[nb2[rows, cols]]`` (ops/geodesic.py ``_block_sweeps``) on scene
    0's radius-kNN table, from the edge table that one eval forward's solve
    builds (``_scene_edges``, recorded): the middle block of the live rows,
    edge slots [8 * slab, 8 * slab + 8), as int32 ids in the sweep's order
    (block_size rows x 8 slots), and a seeded [PP + 1, q] f32 table."""
    from geoformer_tpu_torch.ops import geodesic

    calls = []
    edges = geodesic._scene_edges

    def keep(**kw):
        calls.append((kw, edges(**kw)))
        return calls[-1][1]

    geodesic._scene_edges = keep
    try:
        engine.eval_batch(batch)
    finally:
        geodesic._scene_edges = edges
    kw, (_, _, _, _, _, nb2, _, pp) = calls[0]
    rows = kw["block_size"]
    block = int(kw["point_mask"].sum()) // rows // 2
    ids = nb2[block * rows:(block + 1) * rows, slab * SWEEP_SLAB:(slab + 1) * SWEEP_SLAB]
    gen = torch.Generator(device=nb2.device).manual_seed(seed)
    dist = torch.randn(pp + 1, q, generator=gen, device=nb2.device)
    return dist, ids.reshape(-1).to(torch.int32).contiguous()


def train_queries() -> int:
    """n_query_points of config/geoformer_scannet.yaml: the width of the
    training step's geodesic table."""
    from geoformer_tpu_torch.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return load_config(os.path.join(root, "config", "geoformer_scannet.yaml")).n_query_points


def gather_bytes(x, idx) -> dict:
    """What a gather must move: each distinct row read once (``bytes``), or
    each id's row (``bytes_all_ids``); each output row written and each id
    read once."""
    n, q = idx.numel(), x.shape[1]
    distinct = int(torch.unique(idx).numel())
    return {"distinct_rows": distinct, "bytes": distinct * q * 4 + n * (q * 4 + 4),
            "bytes_all_ids": n * (2 * q * 4 + 4)}


def launcher(entry):
    """The gather through a C entry point of row_gather_launch's signature
    (x, idx, out, n, q, stream); no launch is counted."""
    def gather(x, idx):
        idx = idx.reshape(-1)
        out = torch.empty(idx.numel(), x.shape[1], dtype=torch.float32, device=x.device)
        err = entry(x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), x.shape[1],
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"row gather entry point failed with error {err}")
        return out
    return gather


def per_unit(x, idx):
    """The tree's K3 by its per-unit kernel (one unit a thread, the first
    design) at any width: the yardstick the design is timed against."""
    return launcher(kernels.lib().row_gather_per_unit_launch)(x, idx)


def gathers(seed: int = 0) -> dict:
    """{name: (x, idx)} on the card: the probe's, the foreground gather's,
    the sweep's slab at Q = 128 and 256, and the width classes."""
    from geoformer_tpu_torch.config import scannet_eval_config
    from geoformer_tpu_torch.engine import Engine
    from geoformer_tpu_torch.synthetic import synthetic_batch
    from geoformer_tpu_torch.tools.gather_probe import probe_inputs

    out = {"probe": tuple(torch.from_numpy(a).cuda() for a in probe_inputs())}
    cfg = scannet_eval_config()
    engine = Engine(cfg, seed=seed)
    batch = synthetic_batch(cfg, 1, seed=seed)
    out["fg_gather"] = fg_gather_inputs(engine, batch)
    dist, ids = sweep_slab(engine, batch, train_queries())
    out[f"sweep_q{dist.shape[1]}"] = (dist, ids)
    # the eval forward's table is [PP + 1, n_query_points of the eval config]
    out[f"sweep_q{cfg.n_query_points}"] = (
        torch.randn(dist.shape[0], cfg.n_query_points, device="cuda"), ids)
    del engine
    g = torch.Generator(device="cuda").manual_seed(seed)
    for q in WIDTHS:
        out[f"width_q{q}"] = (torch.randn(250000, q, generator=g, device="cuda"),
                              torch.randint(0, 250000, (131072,), generator=g, device="cuda",
                                            dtype=torch.int32))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a row_gather.cu (entry point row_gather_launch)")
    ap.add_argument("--order", help="labels (sources, rows, per_unit) in timing order, "
                    "comma-separated (default: each, then the reverse)")
    ap.add_argument("--only", help="gathers to time, comma-separated (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_sources: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for spec in args.source:
        label, src = spec.split("=", 1)
        lib, report = compile_source(f"k3_{label}", src)
        lib.row_gather_launch.argtypes = [p, p, p, i, i, p]
        lib.row_gather_launch.restype = i
        fns[label] = launcher(lib.row_gather_launch)
        print(json.dumps({"source": label, "path": src, "ptxas": report}), flush=True)
    fns["rows"], fns["per_unit"] = row_gather, per_unit
    order = args.order.split(",") if args.order else [*fns, *reversed(fns)]
    for name, (x, idx) in gathers().items():
        if args.only and name not in args.only.split(","):
            continue
        want = row_gather_plain(x, idx).view(torch.int32)
        equal = {label: torch.equal(f(x, idx).view(torch.int32), want) for label, f in fns.items()}
        idx64 = idx.reshape(-1).long()
        res = {"gather": name, "shape": [*x.shape, idx.numel()], **gather_bytes(x, idx),
               "equal": equal,
               **compare({label: (lambda f=f: f(x, idx)) for label, f in fns.items()}, order),
               **compare({"plain": lambda: row_gather_plain(x, idx),
                          "index_select": lambda: torch.index_select(x, 0, idx64)},
                         ["plain", "index_select"])}
        print(json.dumps(res), flush=True)
        if not all(equal.values()):
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
