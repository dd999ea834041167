"""Wrapper of the hand-written Hopper kernel for the hybrid solver's
extragradient hop (``csrc/hybrid_hop.cu``, built into the extragradient
kernel's library, ``eg_cuda.LIB``, which declares its C functions).

:func:`hybrid_hop_cuda` computes ``ops/avi._eg_phase(M, q, l, u, tau, z,
steps)`` for every lane in one launch, in the inputs' precision (f32 or
f64): the last z, the best-merit z and the best merit ½‖Φ‖².  It takes
CUDA tensors only and raises on anything the kernel does not take; there is
no fallback to the plain loop.  The instance is picked from n and the
precision before the launch (``csrc/hop_lane.cuh::hop_instance`` against
the card's shared-memory opt-in limit): the register instance (n <= 64 in
f32, 40 in f64), M in one block's shared memory, or M read in place from
device memory.  Every launch is counted in
``METRICS.launches["hybrid_hop"]``.

:func:`hybrid_hop_host` runs the same lane code built with g++ on CPU
tensors, every sum in the order of the instance the card would pick: the
CPU tests' window on the kernel's arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.cuda_build import EITHER_FLOAT, HOPPER_SMEM_OPTIN, KernelInputs
from .eg_cuda import LIB

KERNEL = "hybrid_hop"
# csrc/hop_lane.cuh::hop_instance
HOP_REGISTER, HOP_SHARED, HOP_GLOBAL = 0, 1, 2
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INPUTS = KernelInputs(
    "hop kernel", M=("B n n", EITHER_FLOAT), q=("B n", EITHER_FLOAT),
    l=("B n", EITHER_FLOAT), u=("B n", EITHER_FLOAT), tau=("B", EITHER_FLOAT),
    z=("B n", EITHER_FLOAT))


def card_instance(n: int, dtype: torch.dtype, device: torch.device) -> int:
    """The instance the wrapper picks for lanes of rows of ``n`` in
    ``dtype`` on the CUDA ``device``."""
    return LIB.cuda().qpn_hop_instance(int(n), dtype.itemsize,
                                       LIB.optin(device))


def host_instance(n: int, dtype: torch.dtype,
                  optin: int = HOPPER_SMEM_OPTIN) -> int:
    """The instance the card's wrapper picks for rows of ``n`` in ``dtype``
    under the opt-in limit ``optin`` (an H100's by default), from the
    kernel's header built for the host."""
    return LIB.host().qpn_hop_instance(int(n), dtype.itemsize, int(optin))


def _outputs(z):
    return (torch.empty_like(z), torch.empty_like(z),
            torch.empty(z.shape[0], dtype=z.dtype, device=z.device))


def _args(M, q, l, u, tau, z, outs, steps):
    B, n = z.shape
    return [*(t.data_ptr() for t in (M, q, l, u, z, tau, *outs)), B, n,
            int(steps)]


def hybrid_hop_cuda(M, q, l, u, tau, z, steps: int):
    """``steps`` extragradient steps of every lane with its best-merit
    iterate, in one launch: ``(last z, best z, best merit)``, as
    ``avi._eg_phase`` returns them.  M (B,n,n); q/l/u/z (B,n); tau (B,);
    all f32 or all f64 on one CUDA device (CPU tensors go to
    ``avi._eg_phase``)."""
    return _launch(M, q, l, u, tau, z, steps)


def _launch(M, q, l, u, tau, z, steps: int, *,
            instance: Optional[int] = None):
    """One launch on inputs checked here, of the instance the shape picks
    or of ``instance``, counted.  The GPU tests and ``chip_smoke.py`` force
    one to hold the instances against each other."""
    _INPUTS((M, q, l, u, tau, z), "cuda", steps=steps)
    outs = _outputs(z)
    if z.numel() == 0:
        # no launch; n = 0 lanes have merit 0, as in the plain loop
        return z.clone(), z.clone(), torch.zeros_like(outs[2])
    if instance is None:
        instance = card_instance(z.shape[1], z.dtype, z.device)
    LIB.launch(KERNEL, "qpn_hybrid_hop_" + _SUFFIX[z.dtype], z.device,
               *_args(M, q, l, u, tau, z, outs, steps), int(instance))
    return outs


def hybrid_hop_host(M, q, l, u, tau, z, steps: int,
                    optin: int = HOPPER_SMEM_OPTIN,
                    instance: Optional[int] = None):
    """The kernel's lane code built for the host, on CPU tensors: every sum
    in the order of the instance the card's wrapper picks for this n and
    precision under the opt-in limit ``optin`` (an H100's by default), or
    of ``instance``."""
    _INPUTS((M, q, l, u, tau, z), "cpu", steps=steps)
    outs = _outputs(z)
    run = getattr(LIB.host(), "qpn_hybrid_hop_host_" + _SUFFIX[z.dtype])
    if run(*_args(M, q, l, u, tau, z, outs, steps), int(optin),
           -1 if instance is None else int(instance)) != 0:
        raise ValueError(f"hop kernel: no register instance for n="
                         f"{z.shape[1]}")
    return outs
