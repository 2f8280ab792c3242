"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import), one ``nvcc -c`` per source started
together, into ``build/`` at the repository root (listed in .gitignore). The
library's file name carries a hash of the sources, so an edited source
rebuilds. Processes that share ``build/`` (the ranks of a data-parallel
run) build one at a time under a file lock, and the library and its log
appear by ``os.replace``: no process loads a half-written file, and the
second finds the first's library.

Wrappers (``kernels/fps.py``, ``kernels/knn_select.py``,
``kernels/row_gather.py``) take the plain PyTorch version for CPU tensors
and launch the kernel for CUDA tensors; ``kernels/subm_conv.py``'s launches
take CUDA tensors alone (its caller, ``ops/sparse_conv.py:apply_subm``,
sends CPU tensors to the plain conv). They raise if the kernel cannot run,
and never fall back.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # no FMA contraction: FPS distances must round like the plain version
    "--fmad=false",
    # registers, shared memory and spills of each kernel, kept in build_log()
    "-Xptxas", "-v",
]

_lib = None
build_seconds = None  # wall time of this process's build (None: not built here)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgeoformer_kernels_{h.hexdigest()[:12]}.so")


@contextlib.contextmanager
def _build_lock():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".kernels.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> str:
    """Compile every csrc/*.cu (in parallel) and link one shared library;
    returns its path. A no-op when the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    with _build_lock():
        if not os.path.exists(out):  # another process may have built it meanwhile
            _build(out)
    return out


def _build(out: str) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, logs = [], []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            objs.append(obj)
            logs.append(log)
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_so],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        with open(os.path.join(tmp, "lib.log"), "w") as f:
            f.write("".join(logs))
        os.replace(os.path.join(tmp, "lib.log"), out + ".log")
        os.replace(tmp_so, out)
    build_seconds = time.time() - t0


def wrappers() -> dict:
    """Each kernel's wrapper by name; ``wrapper.launches`` counts the
    kernel's launches (a plain attribute, set to 0 to start a count)."""
    from geoformer_tpu_torch.kernels.fps import fps
    from geoformer_tpu_torch.kernels.knn_select import select_min_k_cand
    from geoformer_tpu_torch.kernels.row_gather import row_gather
    from geoformer_tpu_torch.kernels.subm_conv import subm_dgrad, subm_fwd, subm_wgrad

    return {"knn_select": select_min_k_cand, "fps": fps, "row_gather": row_gather,
            "subm_conv": subm_fwd, "subm_conv_dgrad": subm_dgrad, "subm_conv_wgrad": subm_wgrad}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def build_log() -> str:
    """What nvcc and ptxas printed when the current library was built."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        so.knn_select_launch.argtypes = [p, p, p, p, i, i, i, p, p]
        so.knn_select_launch.restype = i
        so.fps_launch.argtypes = [p, p, p, i, i, i, p]
        so.fps_launch.restype = i
        so.fps_max_points.argtypes = []
        so.fps_max_points.restype = i
        so.fps_cluster_size.argtypes = [i]
        so.fps_cluster_size.restype = i
        so.row_gather_launch.argtypes = [p, p, p, i, i, p]
        so.row_gather_launch.restype = i
        so.row_gather_per_unit_launch.argtypes = [p, p, p, i, i, p]
        so.row_gather_per_unit_launch.restype = i
        so.subm_conv_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        so.subm_conv_fwd_launch.restype = i
        so.subm_conv_dgrad_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        so.subm_conv_dgrad_launch.restype = i
        so.subm_conv_wgrad_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        so.subm_conv_wgrad_launch.restype = i
        so.error_string.argtypes = [i]
        so.error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError after it)."""
    if err != 0:
        msg = lib().error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
