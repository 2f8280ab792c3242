"""ctypes bindings of the native host ops, with numpy fallbacks (the port's
copy of geoformer_tpu/native/__init__.py).

``csrc/host_ops.cpp`` is compiled with ``g++`` and the JAX package's flags
at first use (never at import) into ``build/`` at the repository root, under
the kernels' build lock, so that processes sharing ``build/`` build it once;
the file name carries a hash of the source, the flags and the host CPU's
feature flags (``-march=native`` compiles for that CPU). Where no ``g++``
builds it, every entry point takes its numpy/scipy fallback, the same
semantics; ``available()`` says which path runs. See host_ops.cpp for the
contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from geoformer_tpu_torch import kernels

SRC = os.path.join(kernels.CSRC, "host_ops.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False
build_error = None  # what g++ said when the build failed in this process


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> str:
    """build/ path of the library for this source, these flags and this CPU."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    return os.path.join(kernels.BUILD_DIR, f"libgeoformer_host_ops_{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, "lib.so")
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp_so], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp_so, out)


def get_lib():
    """The loaded native library (built on first call), or None where it
    cannot be built or loaded."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not os.path.exists(out):
                with kernels._build_lock():
                    if not os.path.exists(out):
                        _build(out)
            lib = ctypes.CDLL(out)
        except subprocess.CalledProcessError as e:
            build_error = e.stderr
            return None
        except (OSError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.voxelize_idx.restype = ctypes.c_int32
        lib.voxelize_idx.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                     i32p, i32p, i32p]
        lib.voxel_rulebook.restype = None
        lib.voxel_rulebook.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, i32p]
        lib.elastic_blur3.restype = None
        lib.elastic_blur3.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.trilinear_gather.restype = None
        lib.trilinear_gather.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_float, f32p,
                                         ctypes.c_int64, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the entry points run the native library (else numpy)."""
    return get_lib() is not None


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def voxelize_idx(coords: np.ndarray, batch: np.ndarray | None = None, spatial: int = 1024):
    """Host voxel dedup. coords [N,3] int32 >= 0 -> (input_map [N] int32
    point -> voxel, voxel_coords [M,3] int32 in sorted-key order, counts [M]
    int32)."""
    coords = _i32(coords)
    n = coords.shape[0]
    lib = get_lib()
    if lib is not None and n > 0:
        input_map = np.empty(n, np.int32)
        vox = np.empty((n, 3), np.int32)
        counts = np.empty(n, np.int32)
        b = _i32(batch) if batch is not None else None
        m = lib.voxelize_idx(
            _ptr(coords, ctypes.c_int32), _ptr(b, ctypes.c_int32) if b is not None else None,
            n, spatial, _ptr(input_map, ctypes.c_int32), _ptr(vox, ctypes.c_int32),
            _ptr(counts, ctypes.c_int32))
        return input_map, vox[:m].copy(), counts[:m].copy()
    # numpy: unique on packed int64 keys
    b = np.zeros(n, np.int64) if batch is None else batch.astype(np.int64)
    s = np.int64(spatial)
    key = ((b * s + coords[:, 2]) * s + coords[:, 1]) * s + coords[:, 0]
    ukeys, input_map, counts = np.unique(key, return_inverse=True, return_counts=True)
    idx_sorted = np.argsort(input_map, kind="stable")
    first = idx_sorted[np.searchsorted(input_map[idx_sorted], np.arange(len(ukeys)))]
    return input_map.astype(np.int32), coords[first], counts.astype(np.int32)


def voxel_rulebook(input_map: np.ndarray, n_voxels: int, max_active: int):
    """Voxel -> point-list rulebook [M, 1+max_active]: column 0 the count
    (clamped to max_active), then the points, -1 padding."""
    input_map = _i32(input_map)
    lib = get_lib()
    out = np.empty((n_voxels, 1 + max_active), np.int32)
    if lib is not None:
        lib.voxel_rulebook(_ptr(input_map, ctypes.c_int32), input_map.shape[0],
                           n_voxels, max_active, _ptr(out, ctypes.c_int32))
        return out
    out[:, 0] = 0
    out[:, 1:] = -1
    for i, v in enumerate(input_map):
        c = out[v, 0]
        if c < max_active:
            out[v, 1 + c] = i
        out[v, 0] = c + 1
    np.minimum(out[:, 0], max_active, out=out[:, 0])
    return out


def elastic_blur(noise: np.ndarray) -> np.ndarray:
    """Six 3-tap box blur passes over 3 noise grids [3,dx,dy,dz] (the
    reference's blur0/blur1/blur2 twice, scannetv2_inst.py:146-152)."""
    noise = _f32(noise)
    lib = get_lib()
    if lib is not None:
        out = noise.copy()
        lib.elastic_blur3(_ptr(out, ctypes.c_float), *noise.shape[1:])
        return out
    import scipy.ndimage

    blur0 = np.ones((3, 1, 1), np.float32) / 3
    blur1 = np.ones((1, 3, 1), np.float32) / 3
    blur2 = np.ones((1, 1, 3), np.float32) / 3
    grids = [g for g in noise]
    for blur in (blur0, blur1, blur2, blur0, blur1, blur2):
        grids = [scipy.ndimage.convolve(g, blur, mode="constant", cval=0) for g in grids]
    return np.stack(grids)


def trilinear_gather(noise: np.ndarray, gran: float, pts: np.ndarray) -> np.ndarray:
    """Sample 3 grids at pts with the reference's axis convention
    (scannetv2_inst.py:153-158); out of bounds -> 0. -> [N,3]."""
    noise, pts = _f32(noise), _f32(pts)
    lib = get_lib()
    if lib is not None:
        out = np.empty((pts.shape[0], 3), np.float32)
        lib.trilinear_gather(_ptr(noise, ctypes.c_float), *noise.shape[1:], gran,
                             _ptr(pts, ctypes.c_float), pts.shape[0],
                             _ptr(out, ctypes.c_float))
        return out
    import scipy.interpolate

    d = noise.shape[1:]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in d]
    interp = [scipy.interpolate.RegularGridInterpolator(ax, n, bounds_error=False, fill_value=0)
              for n in noise]
    return np.stack([i(pts) for i in interp], axis=1).astype(np.float32)
