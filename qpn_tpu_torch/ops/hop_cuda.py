"""Wrapper of the hand-written Hopper kernel for the hybrid solver's
extragradient hop (``csrc/hybrid_hop.cu``, built into the extragradient
kernel's library).

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

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import HOPPER_SMEM_OPTIN
from ..utils.metrics import METRICS
from . import eg_cuda

KERNEL = "hybrid_hop"
# csrc/hop_lane.cuh::hop_instance
HOP_REGISTER, HOP_SHARED, HOP_GLOBAL = 0, 1, 2
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_PARAMS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = eg_cuda._cuda_lib()
        for fn in (lib.qpn_hybrid_hop_f32, lib.qpn_hybrid_hop_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_int, ctypes.c_void_p]
        _instance_function(lib)
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = eg_cuda._host_lib()
        for fn in (lib.qpn_hybrid_hop_host_f32, lib.qpn_hybrid_hop_host_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_longlong, ctypes.c_int]
        _instance_function(lib)
        _HOST_LIB = lib
    return _HOST_LIB


def _instance_function(lib: ctypes.CDLL) -> None:
    lib.qpn_hop_instance.restype = ctypes.c_int
    lib.qpn_hop_instance.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong]


def card_instance(n: int, dtype: torch.dtype, device: torch.device) -> int:
    """The instance the wrapper picks for lanes of rows of ``n`` in
    ``dtype`` on the CUDA ``device``."""
    return _cuda_lib().qpn_hop_instance(
        int(n), dtype.itemsize, eg_cuda.card_optin(device))


def host_instance(n: int, dtype: torch.dtype,
                  optin: int = HOPPER_SMEM_OPTIN) -> int:
    """The instance the card's wrapper picks for rows of ``n`` in ``dtype``
    under the opt-in limit ``optin`` (an H100's by default), from the
    kernel's header built for the host."""
    return _host_lib().qpn_hop_instance(int(n), dtype.itemsize, int(optin))


def _check(M, q, l, u, tau, z, steps) -> None:
    """Device, dtype, shape and contiguity of every input, as the kernel
    reads them."""
    if z.dim() != 2:
        raise ValueError(f"hop kernel: z shape {tuple(z.shape)}, expected "
                         "(B, n)")
    B, n = z.shape
    if z.dtype not in _SUFFIX:
        raise TypeError(f"hop kernel: z is {z.dtype}, expected float32 or "
                        "float64")
    want = dict(M=(B, n, n), q=(B, n), l=(B, n), u=(B, n), tau=(B,),
                z=(B, n))
    for name, t in zip(want, (M, q, l, u, tau, z)):
        if t.dtype != z.dtype:
            raise TypeError(f"hop kernel: {name} is {t.dtype}, z is "
                            f"{z.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"hop kernel: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.device != z.device:
            raise ValueError(f"hop kernel: {name} on {t.device}, z on "
                             f"{z.device}")
        if not t.is_contiguous():
            raise ValueError(f"hop kernel: {name} is not contiguous")
    if steps < 0:
        raise ValueError(f"hop kernel: steps={steps} < 0")


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
    all f32 or all f64 on one CUDA device."""
    if z.device.type != "cuda":
        raise ValueError("hybrid_hop_cuda takes CUDA tensors; CPU tensors go "
                         "to avi._eg_phase")
    _check(M, q, l, u, tau, z, steps)
    instance = card_instance(z.shape[1], z.dtype, z.device)
    return _run(M, q, l, u, tau, z, steps, instance)


def _launch(M, q, l, u, tau, z, steps: int, *, instance: int):
    """One launch of the given instance, counted.
    :func:`hybrid_hop_cuda` picks it from the shape; the GPU tests and
    ``chip_smoke.py`` call this to hold the instances against each other."""
    if z.device.type != "cuda":
        raise ValueError("the hop kernel takes CUDA tensors")
    _check(M, q, l, u, tau, z, steps)
    return _run(M, q, l, u, tau, z, steps, instance)


def _run(M, q, l, u, tau, z, steps: int, instance: int):
    """The launch of both entry points, on inputs they have checked."""
    outs = _outputs(z)
    if z.numel() == 0:
        # no launch; n = 0 lanes have merit 0, as in the plain loop
        return z.clone(), z.clone(), torch.zeros_like(outs[2])
    lib = _cuda_lib()
    launch = getattr(lib, "qpn_hybrid_hop_" + _SUFFIX[z.dtype])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = launch(*_args(M, q, l, u, tau, z, outs, steps), int(instance),
                    stream)
    if rc != 0:
        raise RuntimeError("hop kernel launch failed: "
                           + lib.qpn_eg_error_string(rc).decode())
    METRICS.launched(KERNEL)
    return outs


def hybrid_hop_host(M, q, l, u, tau, z, steps: int,
                    optin: int = HOPPER_SMEM_OPTIN,
                    instance: Optional[int] = None):
    """The kernel's lane code built for the host, on CPU tensors: every sum
    in the order of the instance the card's wrapper picks for this n and
    precision under the opt-in limit ``optin`` (an H100's by default), or
    of ``instance``."""
    if z.device.type != "cpu":
        raise ValueError("hybrid_hop_host takes CPU tensors")
    _check(M, q, l, u, tau, z, steps)
    outs = _outputs(z)
    run = getattr(_host_lib(), "qpn_hybrid_hop_host_" + _SUFFIX[z.dtype])
    if run(*_args(M, q, l, u, tau, z, outs, steps), int(optin),
           -1 if instance is None else int(instance)) != 0:
        raise ValueError(f"hop kernel: no register instance for n="
                         f"{z.shape[1]}")
    return outs
