"""Wrapper of the hand-written Hopper kernel for the batched ADMM's inner
block (``csrc/admm_block.cu``, a library of its own).

The kernel runs ``iters`` iterations of ``ops/batch_qp._iterate`` on every
lane in one launch, in f64, updating the lanes' state tensors x, z, y, dx,
dy in place (the caller's copies of its active lanes).  It takes lanes whose
Cholesky factor L and vectors fit one block's shared memory
(``csrc/admm_lane.cuh::admm_fits`` against the card's opt-in limit: n up to
160; A is read in place through the L2); other shapes keep the plain loop.
``batch_qp.solve_qp_batch`` asks :func:`block_for` once a call and launches
what it returns on each block, unchecked; :func:`admm_block_cuda` is the
checked entry, which raises on anything the kernel does not take.  Every
launch is counted in ``METRICS.launches["admm_block"]``.

:func:`admm_block_host` runs the same lane code built with g++ on CPU
tensors, every sum in the kernel's order: the CPU tests' window on the
kernel's arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import (HOPPER_SMEM_OPTIN, load_cuda_library,
                                load_host_library, smem_optin)
from ..utils.metrics import METRICS

KERNEL = "admm_block"
_PARAMS = ([ctypes.c_void_p] * 12 + [ctypes.c_double] * 2
           + [ctypes.c_int] * 5)
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["admm_block.cu"], ["admm_lane.cuh"])
        lib.qpn_admm_block.restype = ctypes.c_int
        lib.qpn_admm_block.argtypes = _PARAMS + [ctypes.c_void_p]
        _fits_function(lib)
        lib.qpn_admm_smem_optin.restype = ctypes.c_longlong
        lib.qpn_admm_smem_optin.argtypes = []
        lib.qpn_admm_error_string.restype = ctypes.c_char_p
        lib.qpn_admm_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("admm_lane_host", ["admm_lane_host.cpp"],
                                ["admm_lane.cuh"])
        lib.qpn_admm_block_host.restype = None
        lib.qpn_admm_block_host.argtypes = _PARAMS
        _fits_function(lib)
        _HOST_LIB = lib
    return _HOST_LIB


def _fits_function(lib: ctypes.CDLL) -> None:
    lib.qpn_admm_fits.restype = ctypes.c_int
    lib.qpn_admm_fits.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong]


def card_fits(n: int, m: int, device: torch.device) -> bool:
    """Whether the kernel takes lanes of ``n`` variables and ``m`` rows on
    the CUDA ``device``."""
    lib = _cuda_lib()
    return bool(lib.qpn_admm_fits(int(n), int(m),
                                  smem_optin(lib.qpn_admm_smem_optin, device)))


def host_fits(n: int, m: int, optin: int = HOPPER_SMEM_OPTIN) -> bool:
    """Whether the card's kernel takes lanes of ``n`` variables and ``m``
    rows under the opt-in limit ``optin`` (an H100's by default), from the
    kernel's header built for the host."""
    return bool(_host_lib().qpn_admm_fits(int(n), int(m), int(optin)))


def block_for(n: int, m: int, device: torch.device):
    """The kernel's launch for lanes of ``n`` variables and ``m`` rows on
    the CUDA ``device``, or None where it does not take them.  The launch
    checks nothing: its caller hands it what :func:`admm_block_cuda`
    takes."""
    return _launch if card_fits(n, m, device) else None


_NAMES = ("A", "L", "R", "q", "lc", "uc", "loose", "x", "z", "y", "dx", "dy")


def _check(tensors, iters) -> None:
    """Device, dtype, shape and layout of every input, as the kernel
    reads them."""
    A = tensors[0]
    if A.dim() != 3:
        raise ValueError(f"admm kernel: A shape {tuple(A.shape)}, expected "
                         "(B, m, n)")
    B, m, n = A.shape
    want = dict(A=(B, m, n), L=(B, n, n), R=(B, m), q=(B, n), lc=(B, m),
                uc=(B, m), loose=(B, m), x=(B, n), z=(B, m), y=(B, m),
                dx=(B, n), dy=(B, m))
    for name, t in zip(_NAMES, tensors):
        dtype = torch.bool if name == "loose" else torch.float64
        if t.dtype != dtype:
            raise TypeError(f"admm kernel: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"admm kernel: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.device != A.device:
            raise ValueError(f"admm kernel: {name} on {t.device}, A on "
                             f"{A.device}")
    _check_layout(tensors)
    if iters < 0:
        raise ValueError(f"admm kernel: iters={iters} < 0")


def _check_layout(tensors) -> None:
    """Every input contiguous, as the kernel reads it (L may be
    column-major)."""
    for name, t in zip(_NAMES, tensors):
        if not (t.is_contiguous() or name == "L" and _column_major(t)):
            raise ValueError(f"admm kernel: {name} is not contiguous")


def _column_major(L) -> bool:
    """Whether each matrix of L is stored column-major, as
    ``torch.linalg.cholesky_ex`` returns its factors."""
    return L.transpose(1, 2).is_contiguous()


def _args(tensors, sigma, alpha, iters):
    B, m, n = tensors[0].shape
    L_cm = not tensors[1].is_contiguous()
    return [*(t.data_ptr() for t in tensors), float(sigma), float(alpha), B,
            n, m, int(iters), int(L_cm)]


def admm_block_cuda(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *,
                    sigma: float, alpha: float, iters: int):
    """``iters`` iterations of ``batch_qp._iterate`` on every lane in one
    launch, x, z, y, dx, dy updated in place and returned.  A (B,m,n); L
    (B,n,n) the lower Cholesky factors of K(ρ); R, lc, uc, z, y, dy (B,m);
    loose (B,m) bool; q, x, dx (B,n); f64 on one CUDA device, each
    contiguous (L may be column-major)."""
    if A.device.type != "cuda":
        raise ValueError("admm_block_cuda takes CUDA tensors; CPU tensors "
                         "go to batch_qp._iterate")
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _check(tensors, iters)
    B, m, n = A.shape
    if not card_fits(n, m, A.device):
        raise ValueError(f"admm kernel: lanes of n={n}, m={m} do not fit")
    return _launch(*tensors, sigma=sigma, alpha=alpha, iters=iters)


def _launch(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *, sigma: float,
            alpha: float, iters: int):
    """The launch, counted, on inputs that fit and that the caller has
    checked or built as :func:`admm_block_cuda` takes them; only their
    layout is checked here (a wrong one would read other values)."""
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _check_layout(tensors)
    if A.shape[0]:
        lib = _cuda_lib()
        stream = torch.cuda.current_stream(A.device).cuda_stream
        with torch.cuda.device(A.device):
            rc = lib.qpn_admm_block(*_args(tensors, sigma, alpha, iters),
                                    stream)
        if rc != 0:
            raise RuntimeError("admm kernel launch failed: "
                               + lib.qpn_admm_error_string(rc).decode())
        METRICS.launched(KERNEL)
    return tensors[7:]


def admm_block_host(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *,
                    sigma: float, alpha: float, iters: int):
    """The kernel's lane code built for the host, on CPU tensors, x, z, y,
    dx, dy updated in place and returned: the kernel's bits."""
    if A.device.type != "cpu":
        raise ValueError("admm_block_host takes CPU tensors")
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _check(tensors, iters)
    if A.shape[0] and A.shape[2]:
        _host_lib().qpn_admm_block_host(*_args(tensors, sigma, alpha, iters))
    return tensors[7:]
