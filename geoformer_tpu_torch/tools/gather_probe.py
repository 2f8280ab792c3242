"""Probe of the row gather ``x[idx]`` on the card (counterpart of
tools/pallas_gather_probe.py).

The TPU probe asks which of four gather forms lower in a compiled Pallas
kernel. On the card one hand-written kernel (K3, kernels/row_gather.py)
computes that function, so the probe runs the kernel and its plain version
on the TPU probe's seed-0 inputs and reports ``OK`` or the failure of each.

    python3 -m geoformer_tpu_torch.tools.gather_probe [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from geoformer_tpu_torch import default_device
from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain

IMPLEMENTATIONS = {"row_gather": row_gather, "plain": row_gather_plain}


def probe_inputs():
    """The TPU probe's inputs: x [512,128] f32, idx [256,1] i32, seed 0."""
    p, q, n = 512, 128, 256
    rng = np.random.default_rng(0)
    x = rng.normal(size=(p, q)).astype(np.float32)
    idx = rng.integers(0, p, size=(n, 1)).astype(np.int32)
    return x, idx


def run_probe(device=None) -> dict:
    """{implementation: "OK" | "WRONG RESULT" | "FAIL: ..."} on ``device``
    (the card when None; raises without one). On a CPU device ``row_gather``
    takes its plain version, as every wrapper does."""
    device = default_device(device)
    x, idx = probe_inputs()
    want = x[idx[:, 0]]
    tx, tidx = torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)
    results = {}
    for name, fn in IMPLEMENTATIONS.items():
        try:
            out = fn(tx, tidx).cpu().numpy()
            ok = out.shape == want.shape and np.array_equal(
                out.view(np.uint32), want.view(np.uint32))
            results[name] = "OK" if ok else "WRONG RESULT"
        except Exception as e:  # noqa: BLE001  (the probe reports each failure)
            results[name] = f"FAIL: {type(e).__name__}: {str(e)[:120]}"
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    print(f"device={device}")
    results = run_probe(device)
    for name, res in results.items():
        print(f"{name:20s} {res}")
    return 0 if all(r == "OK" for r in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
