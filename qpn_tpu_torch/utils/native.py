"""ctypes loader for the port's native host kernels, ``csrc/qpn_host.cpp``.

The source is the port's own copy of the JAX package's host kernels.  It is
built with g++ on first use into ``build/qpn_tpu_torch/``
(``utils/cuda_build.build_library``, with OpenMP, else serially where the
toolchain has no libgomp).  Its kernels: the quantized row dedup that
``Poly`` runs while a model is built, the label-recipe product of the piece
enumeration, a quantized row hash, and the exact-shape batched Lemke
pivoting behind the geometry layer's LP queries
(``ops/lemke.solve_lp_host_batch``).  These are host helpers, not device
code.

A missing source, a missing compiler, a failed build or a failed load
raises ``RuntimeError`` (with the compiler's stderr): no route changes
engine because the library is missing, and a machine without g++ is not
supported.  The ``*_plain`` functions below are the helpers' plain Python
versions, which the tests hold the library against; no route calls them.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .cuda_build import CSRC_DIR, build_library

_LIB: Optional[ctypes.CDLL] = None
# lockstep scenario threads may make the first call together; one builds
_LOAD_LOCK = threading.Lock()

_SOURCE = CSRC_DIR / "qpn_host.cpp"
_CXX = "g++"


def _load() -> ctypes.CDLL:
    """Build (once; the build is cached on disk by content) and load the
    library.  Raises ``RuntimeError`` when the source or the compiler is
    missing, g++ fails or the library does not load."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
        return _LIB


def _build_and_load() -> ctypes.CDLL:
    if not _SOURCE.exists():
        raise RuntimeError(f"native host source {_SOURCE} is missing")
    try:
        so = _build(["-O3", "-fopenmp", "-shared", "-fPIC"])
    except RuntimeError as omp_error:
        # toolchains without libgomp: serial build, same semantics
        try:
            so = _build(["-O3", "-shared", "-fPIC"])
        except RuntimeError as serial_error:
            raise RuntimeError(f"{omp_error}\n{serial_error}") from None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"native host library {so} did not load: {e}") \
            from None
    lib.qpn_recipe_product.restype = ctypes.c_int64
    lib.qpn_recipe_product.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.qpn_quantize_hash.restype = None
    lib.qpn_quantize_hash.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
    lib.qpn_dedupe_rows.restype = None
    lib.qpn_dedupe_rows.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
    lib.qpn_lemke_batch.restype = None
    lib.qpn_lemke_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
    return lib


def _build(flags):
    """``build_library`` of the source with ``_CXX`` and ``flags``; a
    compiler that cannot be started raises ``RuntimeError`` too."""
    cmd = [_CXX, *flags]
    try:
        return build_library("qpn_host", [_SOURCE], cmd)
    except OSError as e:
        raise RuntimeError(f"build of qpn_host failed: {' '.join(cmd)} could "
                           f"not be run ({e}); the port needs g++") from None


def library_path() -> Path:
    """The loaded library's file (built on first call)."""
    return Path(_load()._name)


def recipe_product_plain(label_sets: Sequence[Sequence[int]],
                         cap: int) -> np.ndarray:
    """Plain version of :func:`recipe_product` (``itertools.product``)."""
    lists = [sorted(s) for s in label_sets]
    out = list(itertools.islice(itertools.product(*lists), cap))
    return np.asarray(out, dtype=np.int32).reshape(len(out), len(lists))


def recipe_product(label_sets: Sequence[Sequence[int]], cap: int) -> np.ndarray:
    """Cartesian product of per-row label choices as an (N, n_rows) int32
    array, truncated at ``cap`` (all_Ks, avi_solutions.jl:200-215)."""
    n_rows = len(label_sets)
    lib = _load()
    if n_rows == 0:
        # the product of no choices: one empty recipe
        return np.zeros((min(1, cap), 0), dtype=np.int32)
    lists = [sorted(s) for s in label_sets]
    flat = np.asarray([x for s in lists for x in s], dtype=np.int32)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum([len(s) for s in lists], out=offsets[1:])
    out = np.empty((cap, n_rows), dtype=np.int32)
    count = lib.qpn_recipe_product(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_rows, cap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[:count].copy()


def quantize_hash(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """Per-row FNV hash of 5-digit-rounded values (dedup currency)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    out = np.empty(rows, dtype=np.uint64)
    lib.qpn_quantize_hash(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        digits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def lemke_batch(M, q, l, u, z0=None, tol=1e-9, piv_tol=1e-11,
                max_pivots=None, synth_scale=1e4):
    """Native batched box-AVI complementary pivoting (exact shapes).

    C++ port of the host oracle ops/lemke.py::solve_lemke_np — per-pivot
    work on these small exact-shape tableaus is microseconds, so the
    native loop beats any device dispatch for the geometry query LPs.
    Returns (z (B,n), status (B,), pivots (B,)).  Its plain version is
    ``ops/lemke.solve_lemke_np``.
    """
    lib = _load()
    M = np.ascontiguousarray(M, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    l = np.ascontiguousarray(l, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    B, n = q.shape
    if max_pivots is None:
        max_pivots = max(400, 20 * n)
    z0p = ctypes.POINTER(ctypes.c_double)()
    if z0 is not None:
        z0 = np.ascontiguousarray(z0, dtype=np.float64)
        z0p = z0.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    z = np.empty((B, n), dtype=np.float64)
    status = np.empty(B, dtype=np.int32)
    pivots = np.empty(B, dtype=np.int64)
    lib.qpn_lemke_batch(
        M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        z0p, B, n, tol, piv_tol, int(max_pivots), synth_scale,
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return z, status, pivots


def dedupe_rows_mask_plain(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """Plain version of :func:`dedupe_rows_mask` (a dict of rounded rows)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    seen = set()
    keep = np.zeros(data.shape[0], dtype=bool)
    for r in range(data.shape[0]):
        key = tuple(np.round(data[r], digits) + 0.0)
        if key not in seen:
            seen.add(key)
            keep[r] = True
    return keep


def dedupe_rows_mask(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """keep[r] = True iff row r is the first occurrence of its quantized
    content (Set-of-Slice semantics, sets.jl:104-112)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    lib = _load()
    if rows == 0:
        return np.zeros(0, dtype=bool)
    out = np.empty(rows, dtype=np.uint8)
    lib.qpn_dedupe_rows(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        digits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
