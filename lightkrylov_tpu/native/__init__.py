"""Native (C++) host runtime tier: Block-ELL assembly.

Builds ``bell_assembler.cpp`` into a shared object on first use (cached next
to the source) and exposes it via ctypes.  Falls back transparently to the
numpy assembly path in :mod:`lightkrylov_tpu.ops.bell` when a
compiler is unavailable.

This mirrors the reference's native substrate split: compute on the
accelerator (there: BLAS/LAPACK; here: XLA), heavy host-side data
preparation in compiled native code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "bell_assemble"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bell_assembler.cpp")
_SO = os.path.join(_HERE, "_bell_assembler.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", _SRC, "-o", _SO],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_SO)
            lib.bell_compute_k.restype = ctypes.c_int32
            lib.bell_compute_k.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
            for name in ("bell_fill_f32", "bell_fill_f64"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def bell_assemble(csr, bm: int, bn: int, dtype=np.float32):
    """CSR -> (data, cols, K) Block-ELL arrays via the native assembler.

    ``csr`` is a ``scipy.sparse.csr_matrix``; returns numpy arrays with the
    layout contract of :mod:`lightkrylov_tpu.ops.bell`.
    Raises ``RuntimeError`` if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native bell assembler unavailable")
    m, _ = csr.shape
    indptr = np.ascontiguousarray(csr.indptr, np.int64)
    indices = np.ascontiguousarray(csr.indices, np.int32)
    values = np.ascontiguousarray(csr.data, np.float64)
    K = lib.bell_compute_k(
        indptr.ctypes.data, indices.ctypes.data,
        ctypes.c_int64(m), ctypes.c_int32(bm), ctypes.c_int32(bn))
    nbr = -(-m // bm)
    dtype = np.dtype(dtype)
    data = np.zeros((nbr, K, bm, bn), dtype)
    cols = np.zeros((nbr, K), np.int32)
    fill = lib.bell_fill_f32 if dtype == np.float32 else lib.bell_fill_f64
    fill(indptr.ctypes.data, indices.ctypes.data, values.ctypes.data,
         ctypes.c_int64(m), ctypes.c_int32(bm), ctypes.c_int32(bn),
         ctypes.c_int32(K), data.ctypes.data, cols.ctypes.data)
    return data, cols, int(K)
