"""Wrapper of the hand-written Hopper kernel for the batched ADMM's inner
block (``csrc/admm_block.cu``, a library of its own).

The kernel runs ``iters`` iterations of ``ops/batch_qp._iterate`` on every
lane in one launch, in f64, updating the lanes' state tensors x, z, y, dx,
dy in place (the caller's copies of its active lanes).  It takes lanes whose
Cholesky factor L and vectors fit one block's shared memory
(``csrc/admm_lane.cuh::admm_fits`` against the card's opt-in limit: n up to
160; A is read in place through the L2); other shapes keep the plain loop.
``batch_qp.solve_qp_batch`` asks :func:`block_for` once a call and launches
what it returns on each block; :func:`admm_block_cuda` is the checked
entry, which raises on anything the kernel does not take.  The kernel is
built with nvcc on first use and launched on the current stream through its
declared library :data:`LIB` (``utils/cuda_build.py``); every launch is
counted in ``METRICS.launches["admm_block"]``.

:func:`admm_block_host` runs the same lane code built with g++ on CPU
tensors, every sum in the kernel's order: the CPU tests' window on the
kernel's arithmetic.
"""

from __future__ import annotations

from ctypes import c_char_p, c_double, c_int, c_longlong, c_void_p

import torch

from ..utils.cuda_build import (EITHER_MAJOR, HOPPER_SMEM_OPTIN, Build,
                                KernelInputs, KernelLibrary)

KERNEL = "admm_block"
_PARAMS = [c_void_p] * 12 + [c_double] * 2 + [c_int] * 5
LIB = KernelLibrary(
    cuda=Build(KERNEL, ["admm_block.cu"], ["admm_lane.cuh"], {
        "qpn_admm_block": (c_int, [*_PARAMS, c_void_p]),
        "qpn_admm_smem_optin": (c_longlong, []),
        "qpn_admm_error_string": (c_char_p, [c_int])}),
    host=Build("admm_lane_host", ["admm_lane_host.cpp"], ["admm_lane.cuh"], {
        "qpn_admm_block_host": (None, _PARAMS)}),
    shape={"qpn_admm_fits": (c_int, [c_int, c_int, c_longlong])},
    error="qpn_admm_error_string", optin="qpn_admm_smem_optin")
_F64 = torch.float64
_INPUTS = KernelInputs(
    "admm kernel", A=("B m n", _F64), L=("B n n", _F64, EITHER_MAJOR),
    R=("B m", _F64), q=("B n", _F64), lc=("B m", _F64), uc=("B m", _F64),
    loose=("B m", torch.bool), x=("B n", _F64), z=("B m", _F64),
    y=("B m", _F64), dx=("B n", _F64), dy=("B m", _F64))


def card_fits(n: int, m: int, device: torch.device) -> bool:
    """Whether the kernel takes lanes of ``n`` variables and ``m`` rows on
    the CUDA ``device``."""
    return bool(LIB.cuda().qpn_admm_fits(int(n), int(m), LIB.optin(device)))


def host_fits(n: int, m: int, optin: int = HOPPER_SMEM_OPTIN) -> bool:
    """Whether the card's kernel takes lanes of ``n`` variables and ``m``
    rows under the opt-in limit ``optin`` (an H100's by default), from the
    kernel's header built for the host."""
    return bool(LIB.host().qpn_admm_fits(int(n), int(m), int(optin)))


def block_for(n: int, m: int, device: torch.device):
    """The kernel's launch for lanes of ``n`` variables and ``m`` rows on
    the CUDA ``device``, or None where it does not take them.  The launch
    checks only its inputs' layout (a wrong one would read other values),
    so that ``solve_qp_batch``'s block loop pays no more host work a block:
    its caller hands it what :func:`admm_block_cuda` takes."""
    return _launch if card_fits(n, m, device) else None


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
    loose (B,m) bool; q, x, dx (B,n); f64 on one CUDA device (CPU tensors
    go to ``batch_qp._iterate``), each contiguous (L may be
    column-major)."""
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _INPUTS(tensors, "cuda", iters=iters)
    B, m, n = A.shape
    if not card_fits(n, m, A.device):
        raise ValueError(f"admm kernel: lanes of n={n}, m={m} do not fit")
    return _launch(*tensors, sigma=sigma, alpha=alpha, iters=iters)


def _launch(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *, sigma: float,
            alpha: float, iters: int):
    """The launch, counted, on inputs that fit and that the caller has
    checked or built as :func:`admm_block_cuda` takes them; only their
    layout is checked here."""
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _INPUTS.contiguous(tensors)
    if A.shape[0]:
        LIB.launch(KERNEL, "qpn_admm_block", A.device,
                   *_args(tensors, sigma, alpha, iters))
    return tensors[7:]


def admm_block_host(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *,
                    sigma: float, alpha: float, iters: int):
    """The kernel's lane code built for the host, on CPU tensors, x, z, y,
    dx, dy updated in place and returned: the kernel's bits."""
    tensors = (A, L, R, q, lc, uc, loose, x, z, y, dx, dy)
    _INPUTS(tensors, "cpu", iters=iters)
    if A.shape[0] and A.shape[2]:
        LIB.host().qpn_admm_block_host(*_args(tensors, sigma, alpha, iters))
    return tensors[7:]
