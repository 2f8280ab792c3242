"""Run one benchmark cell once and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``geoformer_tpu_torch``),
on a machine with the cards the cell asks for (benchmark/harness.py)."""

import time

T0 = time.perf_counter()  # set-up runs from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not benchmark/, is where imports start
# one process with few threads: the program's host work is one Python
# thread launching kernels, and idle worker threads of the CPU math
# libraries only contend with it for the host's cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
# kernel and compiler caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0, root=ROOT))
