"""Wrapper of the hand-written Hopper kernel for the Lemke pivot loop
(``csrc/lemke_pivot.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/lemke_pallas.py::_make_kernel``).

:func:`lemke_pivot_cuda` takes the :class:`~.lemke.LemkeInit` that
``lemke.lemke_setup`` builds and returns a :class:`~.lemke.PivotResult`,
exactly like the plain PyTorch loop ``lemke.lemke_pivot_torch`` it is held
against.  It takes CUDA tensors only and raises on anything the kernel does
not take; there is no fallback to the plain loop.  The kernel is built with
nvcc on first use (``utils/cuda_build.py``) and launched on the current
stream; every launch is counted in ``METRICS.launches["lemke_pivot"]``.

:func:`lemke_pivot_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import load_cuda_library, load_host_library
from ..utils.metrics import METRICS
from .lemke import LemkeInit, PivotResult

KERNEL = "lemke_pivot"
_ERR_SMEM = -1
_PARAMS = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_int]
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["lemke_pivot.cu"], ["lemke_lane.cuh"])
        for fn in (lib.qpn_lemke_pivot_f32, lib.qpn_lemke_pivot_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_void_p]
        lib.qpn_lemke_lane_bytes.restype = ctypes.c_longlong
        lib.qpn_lemke_lane_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qpn_cuda_error_string.restype = ctypes.c_char_p
        lib.qpn_cuda_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("lemke_lane_host", ["lemke_lane_host.cpp"],
                                ["lemke_lane.cuh"])
        for fn in (lib.qpn_lemke_pivot_host_f32, lib.qpn_lemke_pivot_host_f64):
            fn.restype = None
            fn.argtypes = _PARAMS
        _HOST_LIB = lib
    return _HOST_LIB


def build() -> None:
    """Build (or find) the kernel library now, so a caller can time the
    build apart from the first launch."""
    _cuda_lib()


def _check(init: LemkeInit) -> None:
    """Device, dtype, shape and contiguity of every input, as the kernel
    reads them."""
    T = init.T
    if T.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lemke pivot kernel: tableau dtype {T.dtype}, "
                        "expected float32 or float64")
    if T.dim() != 3 or T.shape[2] != 3 * T.shape[1] + 2:
        raise ValueError(f"lemke pivot kernel: tableau shape "
                         f"{tuple(T.shape)}, expected (B, n, 3n+2)")
    B, n, _ = T.shape
    i32, dt = torch.int32, T.dtype
    want = dict(basis=((B, n), i32), val=((B, 3 * n + 1), dt),
                ent=((B,), i32), edir=((B,), dt), ev=((B,), dt),
                status=((B,), i32), var_lb=((B, 3 * n + 1), dt),
                var_ub=((B, 3 * n + 1), dt), l_eff=((B, n), dt),
                u_eff=((B, n), dt))
    for name, (shape, dtype) in want.items():
        t = getattr(init, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"lemke pivot kernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != T.device:
            raise ValueError(f"lemke pivot kernel: {name} on {t.device}, "
                             f"tableau on {T.device}")
    for name in ("T", *want):
        if not getattr(init, name).is_contiguous():
            raise ValueError(f"lemke pivot kernel: {name} is not contiguous")


def _outputs(init: LemkeInit) -> PivotResult:
    B, n, _ = init.T.shape
    kw = dict(device=init.T.device)
    return PivotResult(
        xB=torch.empty(B, n, dtype=init.T.dtype, **kw),
        basis=torch.empty(B, n, dtype=torch.int32, **kw),
        val=torch.empty(B, 3 * n + 1, dtype=init.T.dtype, **kw),
        piv=torch.empty(B, dtype=torch.int32, **kw),
        status=torch.empty(B, dtype=torch.int32, **kw))


def _args(init: LemkeInit, out: PivotResult, tol, piv_tol, max_pivots):
    B, n, _ = init.T.shape
    ptrs = [t.data_ptr() for t in (
        init.T, init.basis, init.val, init.var_lb, init.var_ub, init.l_eff,
        init.u_eff, init.ent, init.edir, init.ev, init.status, *out)]
    return [*ptrs, B, n, float(tol), float(piv_tol), int(max_pivots)]


def lemke_pivot_cuda(init: LemkeInit, *, tol, piv_tol,
                     max_pivots) -> PivotResult:
    """Run the pivot loop of every lane in the CUDA kernel (one launch)."""
    if init.T.device.type != "cuda":
        raise ValueError("lemke_pivot_cuda takes CUDA tensors; CPU tensors "
                         "go to lemke.lemke_pivot_torch")
    _check(init)
    out = _outputs(init)
    if init.T.shape[0] == 0:
        return out
    lib = _cuda_lib()
    fn = (lib.qpn_lemke_pivot_f32 if init.T.dtype == torch.float32
          else lib.qpn_lemke_pivot_f64)
    stream = torch.cuda.current_stream(init.T.device).cuda_stream
    with torch.cuda.device(init.T.device):
        rc = fn(*_args(init, out, tol, piv_tol, max_pivots), stream)
    if rc == _ERR_SMEM:
        n = init.T.shape[1]
        need = lib.qpn_lemke_lane_bytes(n, init.T.element_size())
        raise ValueError(f"lemke pivot kernel: a {init.T.dtype} lane of "
                         f"n={n} needs {need} bytes of shared memory, more "
                         "than a block can have on this card")
    if rc != 0:
        raise RuntimeError("lemke pivot kernel launch failed: "
                           + lib.qpn_cuda_error_string(rc).decode())
    METRICS.launched(KERNEL)
    return out


def lemke_pivot_host(init: LemkeInit, *, tol, piv_tol,
                     max_pivots) -> PivotResult:
    """The kernel's lane code built for the host, on CPU tensors."""
    if init.T.device.type != "cpu":
        raise ValueError("lemke_pivot_host takes CPU tensors")
    _check(init)
    out = _outputs(init)
    lib = _host_lib()
    fn = (lib.qpn_lemke_pivot_host_f32 if init.T.dtype == torch.float32
          else lib.qpn_lemke_pivot_host_f64)
    fn(*_args(init, out, tol, piv_tol, max_pivots))
    return out
