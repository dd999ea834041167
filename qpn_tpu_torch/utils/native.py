"""ctypes loader for the native host kernels.

The port builds the JAX package's own source, ``qpn_tpu/native/qpn_host.cpp``,
by path (nothing of the JAX package is imported), with g++ on first use into
``build/qpn_tpu_torch/``, and falls back to pure-Python implementations when
no compiler is available — behavior is identical either way.  Slice 1 of
the port needs one of its kernels, the quantized row dedup that ``Poly``
runs while a model is built; the others come with the code that calls
them.  These are host helpers, not device code."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .cuda_build import PACKAGE_DIR, build_library

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SOURCE = PACKAGE_DIR.parent / "qpn_tpu" / "native" / "qpn_host.cpp"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _SOURCE.exists():
        return None
    try:
        try:
            so = build_library("qpn_host", [_SOURCE],
                               ["g++", "-O3", "-fopenmp", "-shared", "-fPIC"])
        except RuntimeError:
            # toolchains without libgomp: serial build, same semantics
            so = build_library("qpn_host", [_SOURCE],
                               ["g++", "-O3", "-shared", "-fPIC"])
    except (RuntimeError, OSError):
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.qpn_dedupe_rows.restype = None
        lib.qpn_dedupe_rows.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def dedupe_rows_mask(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """keep[r] = True iff row r is the first occurrence of its quantized
    content (Set-of-Slice semantics, sets.jl:104-112)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    lib = _load()
    if lib is None or rows == 0:
        seen = {}
        keep = np.zeros(rows, dtype=bool)
        for r in range(rows):
            key = tuple(np.round(data[r], digits) + 0.0)
            if key not in seen:
                seen[key] = r
                keep[r] = True
        return keep
    out = np.empty(rows, dtype=np.uint8)
    lib.qpn_dedupe_rows(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        digits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
