"""Profile of the port's training step on the card.

    python3 -m geoformer_tpu_torch.tools.profile_train [--batch 8] [--thin 0.2]
        [--gather take_rows index embedding] [--out build/profile_train.jsonl]

At config/geoformer_scannet.yaml (its widths, bf16 sparse convs and remat)
with seeded random weights whose semantic head makes every point
foreground, on a synthetic batch of B 250,000-point scenes (every second
scene's last ``--thin`` share of point slots invalid, as in scans smaller
than the capacity), it takes one prepare-phase and one full-phase
``Engine.train_step``, each timed stage by stage (wall, up to a
synchronize) and then once more under torch.profiler: device time, kernel
launches, the largest device kernels and the largest host operators.

``--gather`` names the padded row gather of the sparse convs and of
``devoxelize``: ``take_rows`` (the
port's, an index_add_ backward with the pad row's reads spread over
scratch rows), ``index`` (advanced indexing, whose backward sums a repeated
row serially) or ``embedding`` (F.embedding with the pad row as its
padding_idx). Each is profiled in turn in the same process. One JSON
object per line goes to stdout and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from geoformer_tpu_torch import config as cfg_mod
from geoformer_tpu_torch import ops
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.ops import sparse_conv, voxelize
from geoformer_tpu_torch.synthetic import synthetic_batch

FG_BIAS = 30.0  # class 4's logit bias: every point foreground


def _flat_ids(idx, n, pad):
    """idx [B, *S] in [0, n] -> ids into a padded_table (n -> its pad row)."""
    b = idx.shape[0]
    offsets = (torch.arange(b, device=idx.device) * n).view((b,) + (1,) * (idx.ndim - 1))
    return torch.where(idx >= n, pad, idx + offsets)


def _index_rows(table, idx, n):
    return table[_flat_ids(idx, n, table.shape[0] - 1)]


def _embedding_rows(table, idx, n):
    pad = table.shape[0] - 1
    return F.embedding(_flat_ids(idx, n, pad), table, padding_idx=pad)


GATHERS = {"take_rows": ops.take_rows, "index": _index_rows, "embedding": _embedding_rows}


def profile_step(engine, batch, epoch, gen, top: int) -> dict:
    """One train_step under torch.profiler -> device ms, launches, the
    largest device kernels and host operators."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_step(batch, epoch, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    cuda.sort(key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events),
                  key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in cuda), "launches": sum(r[2] for r in cuda),
            "top_device": [[k[:80], ms, n] for k, ms, n in cuda[:top]],
            "top_host_self": [[k[:60], ms, n] for k, ms, n in host[:top // 2]]}


def run(batch_size: int, thin: float, gathers, out_path: str | None, top: int = 20):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = None
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        out = open(out_path, "a")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    cfg = cfg_mod.load_config(os.path.join(here, "config", "geoformer_scannet.yaml"),
                              batch_size=batch_size, prepare_epochs=1)
    batch = synthetic_batch(cfg, batch_size, seed=1)
    batch["instance_labels"] = np.where(batch["instance_labels"] < cfg.tpu_max_instances,
                                        batch["instance_labels"], -100).astype(np.int32)
    n_invalid = int(cfg.tpu_max_points * thin)
    if n_invalid:
        batch["point_mask"][1::2, cfg.tpu_max_points - n_invalid:] = False
    try:
        for name in gathers:
            sparse_conv.take_rows = voxelize.take_rows = GATHERS[name]
            engine = Engine(cfg, seed=0)
            with torch.no_grad():
                engine.model.semantic.Dense_2.bias[4] += FG_BIAS
            gen = torch.Generator(device="cuda").manual_seed(0)
            for epoch, phase in ((1, "prepare"), (2, "full")):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                engine.model.stage_ms = {}
                t0 = time.perf_counter()
                loss, ld, _ = engine.train_step(batch, epoch, gen)
                float(loss)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                stages = engine.model.stage_ms
                engine.model.stage_ms = None
                emit({"gather": name, "batch": batch_size, "invalid_slots": n_invalid,
                      "phase": phase, "ms": ms, "stage_ms": stages,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "loss": {k: float(v) for k, v in ld.items()}})
                emit(dict({"gather": name, "batch": batch_size, "phase": phase,
                           "profiled": True}, **profile_step(engine, batch, epoch, gen, top)))
            del engine
            torch.cuda.empty_cache()
    finally:
        sparse_conv.take_rows = voxelize.take_rows = ops.take_rows
        if out:
            out.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--thin", type=float, default=0.2,
                    help="share of every second scene's point slots left invalid")
    ap.add_argument("--gather", nargs="+", default=["take_rows"], choices=sorted(GATHERS))
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    run(args.batch, args.thin, args.gather, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
