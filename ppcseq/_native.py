"""ctypes loader for the native host runtime (native/ppcseq_native.cpp).

Every entry point has a NumPy fallback in the pure-Python modules; this
module decides whether the compiled library is available and exposes typed
wrappers. The library is not committed: the first `_load()` in a checkout
compiles it from source with the host's C++ compiler (`$CXX`, default g++)
into native/libppcseq_native.so, which .gitignore lists. When it cannot be
built or loaded, callers use the NumPy fallback, which gives the same
answers; `status()` says which one runs, and the fallback warns once.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import warnings

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "ppcseq_native.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libppcseq_native.so")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_LIB = None
_TRIED = False
_STATUS = "not loaded yet"


def build(path: str) -> str:
    """Compile ppcseq_native.cpp into `path`.

    The compiler writes a temporary file in the target directory, which is
    then renamed onto `path`: concurrent builders (test workers) each
    publish a whole library, and no process loads a half-written one.
    """
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, _SRC],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _open(path: str):
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pivot_counts.argtypes = [i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.pivot_counts.restype = None
    lib.tmm_factor.argtypes = [f64p, f64p, ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    lib.tmm_factor.restype = ctypes.c_double
    lib.tmm_norm_factors.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p]
    lib.tmm_norm_factors.restype = None
    lib.quantile7_sorted.argtypes = [f64p, ctypes.c_int64, ctypes.c_double]
    lib.quantile7_sorted.restype = ctypes.c_double
    return lib


def _load():
    global _LIB, _TRIED, _STATUS
    if _TRIED:
        return _LIB
    _TRIED = True
    built = False
    try:
        if not os.path.exists(_LIB_PATH):
            build(_LIB_PATH)
            built = True
        _LIB = _open(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        _STATUS = f"not available ({detail.strip()[:200]}); NumPy fallback"
        warnings.warn(f"ppcseq native host library {_STATUS}", RuntimeWarning, stacklevel=3)
        return None
    _STATUS = f"loaded {_LIB_PATH}" + (" (built from source)" if built else "")
    return _LIB


def status() -> str:
    """Whether the native library is in use, and why not if it is not."""
    _load()
    return _STATUS


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pivot_counts(s_idx: np.ndarray, g_idx: np.ndarray, values: np.ndarray, S: int, G: int):
    lib = _load()
    out = np.zeros((S, G), dtype=np.int64)
    s = np.ascontiguousarray(s_idx, dtype=np.int64)
    g = np.ascontiguousarray(g_idx, dtype=np.int64)
    v = np.ascontiguousarray(values, dtype=np.int64)
    lib.pivot_counts(
        _ptr(s, ctypes.c_int64), _ptr(g, ctypes.c_int64), _ptr(v, ctypes.c_int64),
        len(v), G, _ptr(out, ctypes.c_int64),
    )
    return out


def tmm_norm_factors(counts_genes_by_samples: np.ndarray, ref_column: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(counts_genes_by_samples, dtype=np.float64)
    n_genes, n_samples = x.shape
    out = np.zeros(n_samples, dtype=np.float64)
    lib.tmm_norm_factors(
        _ptr(x, ctypes.c_double), n_genes, n_samples, ref_column, _ptr(out, ctypes.c_double)
    )
    return out
