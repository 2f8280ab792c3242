"""One training step and one eval forward on a ("data", "model") mesh
(counterpart of the model-axis runs of tools/train_bench.py --mesh).

Under torchrun, N x M ranks: ``Engine(cfg, mesh=make_mesh(model_parallel=M))``
splits each scene's queries over the M ranks of a model group, and the
batch (``batch_size`` scenes, synthetic, seeded) over the N data indices.
Rank 0 prints one JSON line a stage: the step's global loss terms and the
collectives' largest tensors, then the eval forward's proposals.

    # the CPU, 2 x 2 gloo ranks, the tiny config
    torchrun --nproc_per_node=4 -m geoformer_tpu_torch.tools.mp_step \\
        --config config/tiny_cpu_test.yaml --model_parallel 2 --device cpu
    # the card (gloo lets ranks share one card)
    torchrun --nproc_per_node=2 -m geoformer_tpu_torch.tools.mp_step \\
        --config config/geoformer_scannet.yaml --model_parallel 2 --batch_size 2
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from geoformer_tpu_torch.config import load_config
from geoformer_tpu_torch.engine import Engine
from geoformer_tpu_torch.parallel.dist import process_group
from geoformer_tpu_torch.parallel.mesh import TRAFFIC, make_mesh
from geoformer_tpu_torch.synthetic import synthetic_batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--model_parallel", type=int, default=2)
    ap.add_argument("--batch_size", type=int, help="global batch (default: the config's)")
    ap.add_argument("--device", help="cpu, or the card when omitted")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = load_config(args.config, **({"batch_size": args.batch_size}
                                      if args.batch_size else {}))
    with process_group("gloo", device=args.device or "cuda"):
        mesh = make_mesh(model_parallel=args.model_parallel, device=args.device)
        torch.manual_seed(args.seed + mesh.data_rank)  # dropout: alike in a model group
        engine = Engine(cfg, device=mesh.device, seed=args.seed, mesh=mesh)
        batch = synthetic_batch(cfg, cfg.batch_size, seed=args.seed)
        gen = torch.Generator(device=engine.device).manual_seed(args.seed)
        t = time.perf_counter()
        _, loss_dict, _ = engine.train_step(batch, cfg.prepare_epochs + 1, gen)
        step = {"stage": "train_step", "layout": f"{mesh.data_world}x{mesh.model_world}",
                "loss": {k: float(v) for k, v in loss_dict.items()},
                "seconds": time.perf_counter() - t, "collective_bytes": dict(TRAFFIC.largest)}
        out = engine.eval_batch(batch)
        evals = {"stage": "eval_batch", "rows": int(out["mask_logits"].shape[1]),
                 "queries": int(out["mask_logits"].shape[2])}
        if "proposals" in out:
            evals.update(kept=int(out["proposals"]["keep"].sum()),
                         after_nms=int(out["nms"]["keep"].sum()))
        if mesh.rank == 0:
            for line in (step, evals):
                print(json.dumps(line), flush=True)
    return {"train_step": step, "eval_batch": evals}


if __name__ == "__main__":
    main()
