"""Host-side post-processing of stored chains (C++ via ctypes), with numpy
fallbacks.

Copy of the JAX package's ``bssm_tpu/native``: Sokal's IACT over long
chains, streaming weighted moments and stratified resampling, host code of
the diagnostics, not device kernels.  ``fastdiag.cpp`` is compiled by
``g++ -O3`` at first use into ``bssm_tpu_torch/_build/libfastdiag.so`` (the
git-ignored build directory the CUDA kernels share), rebuilt when the source
is newer.  Every entry point computes the same thing with numpy when the
library cannot be built; ``get_lib() is None`` says so.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastdiag.cpp"
_LIB = _SRC.parent.parent / "_build" / "libfastdiag.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile into a file of this process's own, then rename it into
    place, so that processes building at once never load a half-written
    library."""
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o",
             str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        i64 = ctypes.c_int64
        lib.bssm_iact.restype = ctypes.c_double
        lib.bssm_iact.argtypes = [f64, i64]
        lib.bssm_iact_batch.restype = None
        lib.bssm_iact_batch.argtypes = [f64, i64, i64, f64]
        lib.bssm_weighted_moments.restype = None
        lib.bssm_weighted_moments.argtypes = [f64, f64, i64, i64, f64, f64]
        lib.bssm_stratified_sample.restype = None
        lib.bssm_stratified_sample.argtypes = [
            f64, i64, f64, i64, np.ctypeslib.ndpointer(np.int64, flags="C")]
        _lib = lib
        return _lib


def iact_batch(xs: np.ndarray) -> np.ndarray:
    """Batched Sokal IACT over the rows of xs (m, n); native or numpy."""
    xs = np.ascontiguousarray(np.atleast_2d(xs), dtype=np.float64)
    m, n = xs.shape
    lib = get_lib()
    if lib is not None:
        out = np.empty(m, dtype=np.float64)
        lib.bssm_iact_batch(xs, m, n, out)
        return out
    from ..diagnostics.summary import iact as _py_iact
    return np.array([_py_iact(row) for row in xs])


def weighted_moments(x: np.ndarray, w: np.ndarray):
    """Streaming weighted mean/var over axis 0 of x (s, d)."""
    x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    s, d = x.shape
    lib = get_lib()
    if lib is not None:
        mean = np.empty(d)
        var = np.empty(d)
        lib.bssm_weighted_moments(x, w, s, d, mean, var)
        return mean, var
    sw = w.sum()
    mean = (w[:, None] * x).sum(0) / sw
    var = (w[:, None] * (x - mean) ** 2).sum(0) / sw
    return mean, var


def stratified_sample(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Host-side stratified resampling: indices (N,) from normalised
    weights p (n,) and uniforms r (N,)."""
    p = np.ascontiguousarray(p, dtype=np.float64)
    r = np.ascontiguousarray(r, dtype=np.float64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(r), dtype=np.int64)
        lib.bssm_stratified_sample(p, len(p), r, len(r), out)
        return out
    cp = np.cumsum(p)
    cp[-1] = 1.0
    u = (np.arange(len(r)) + r) / len(r)
    return np.clip(np.searchsorted(cp, u, side="left"), 0, len(p) - 1)
