"""K1 (csrc/knn_select.cu) built from several sources, timed on the same
tables in one process on the card.

    python3 -m geoformer_tpu_torch.tools.k1_sources \\
        --source parent=build/parent_knn_select.cu \\
        --source new=geoformer_tpu_torch/csrc/knn_select.cu \\
        --order parent,new,new,parent

Each source is compiled alone with the port's nvcc flags into build/ and
launched through its C entry point (``knn_select_launch``). The ptxas
report (registers and spills of each instantiation) is printed per source.
On each table at [131072, 648], every source's result is held bit-equal to
the plain version and its exact-path share is read; then each source is
timed by CUDA events in the ``--order`` given (20 calls a turn), beside the
plain version and ``torch.topk``. The tables: the exact geodesic solver's
row shape (at most 44 live lanes of the radius graph's 27 cells, 1e30
elsewhere), uniform d2 live in every lane, and that table with each row's
smallest values packed in 7 lanes. One JSON line per table and k.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from geoformer_tpu_torch import kernels
from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand_plain


def build(label: str, src: str):
    """The source's library and its ptxas report (one nvcc, alone)."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out = os.path.join(kernels.BUILD_DIR, f"libk1_{label}.so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src, "-o", out],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_select_launch.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.knn_select_launch.restype = i
    report = [" ".join(line.split()) for line in (r.stdout + r.stderr).splitlines()
              if "Compiling entry" in line or "Used" in line or "spill" in line]
    return lib, report


def launcher(lib):
    def select(d2, cand, k, exact_rows=None):
        n, w = d2.shape
        vals = torch.empty(n, k, dtype=torch.float32, device=d2.device)
        idx = torch.empty(n, k, dtype=torch.int32, device=d2.device)
        err = lib.knn_select_launch(
            d2.data_ptr(), cand.data_ptr(), vals.data_ptr(), idx.data_ptr(), n, w, k,
            None if exact_rows is None else exact_rows.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"knn_select_launch failed with error {err}")
        return vals, idx
    return select


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def tables(n: int = 131072, w: int = 648, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cand = torch.randint(0, n, (n, w), generator=g, device=dev, dtype=torch.int32)
    cap = w // 27
    solver = torch.full((n, w), 1e30, device=dev)
    live = torch.randint(0, 45, (n, 1), generator=g, device=dev)
    pos = (torch.randint(0, 27, (n, 44), generator=g, device=dev) * cap
           + torch.randint(0, 8, (n, 44), generator=g, device=dev))
    vals = torch.rand(n, 44, generator=g, device=dev)
    vals = torch.where(torch.arange(44, device=dev)[None] < live, vals, torch.full_like(vals, 1e30))
    solver.scatter_(1, pos, vals)
    all_live = torch.rand(n, w, generator=g, device=dev)
    packed = all_live + (torch.arange(w, device=dev) % 32 >= 7).float()[None]
    return {"cand": cand, "solver_le44_live": solver, "all_live_uniform": all_live,
            "packed_in_7_lanes": packed}


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", required=True, help="LABEL=PATH of a knn_select.cu")
    ap.add_argument("--order", help="labels in timing order, comma-separated (default: as given)")
    ap.add_argument("--k", default="16,48,64,96", help="k values, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_sources: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    select = {}
    for spec in args.source:
        label, src = spec.split("=", 1)
        lib, report = build(label, src)
        select[label] = launcher(lib)
        print(json.dumps({"source": label, "path": src, "ptxas": report}), flush=True)
    order = args.order.split(",") if args.order else list(select)
    t = tables()
    cand = t.pop("cand")
    for name, d2 in t.items():
        for k in map(int, args.k.split(",")):
            want = select_min_k_cand_plain(d2, cand, k)
            res = {"table": name, "shape": [*d2.shape, k]}
            for label, f in select.items():
                rows = torch.zeros(1, dtype=torch.int32, device="cuda")
                got = f(d2, cand, k, exact_rows=rows)
                res[label] = {"equal": bits_equal(got, want),
                              "exact_share": int(rows) / d2.shape[0], "ms": []}
            for label in order:
                res[label]["ms"].append(time_ms(lambda: select[label](d2, cand, k), 20))
            res["plain_ms"] = time_ms(lambda: select_min_k_cand_plain(d2, cand, k), 3)
            res["topk_ms"] = time_ms(lambda: torch.topk(d2, k, dim=1, largest=False), 20)
            print(json.dumps(res), flush=True)
            if not all(res[label]["equal"] for label in select):
                return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
