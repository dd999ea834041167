"""Wrapper of the hand-written Hopper kernel for the fused extragradient
steps (``csrc/eg_warmstart.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/pallas_kernels.py::_eg_kernel``).

:func:`eg_warmstart_cuda` takes the prepared f32 tensors of
``eg.eg_prepare`` and returns the lanes' z after ``steps`` steps, exactly
like the plain PyTorch loop ``eg.eg_steps_torch`` it is held against.  It
takes CUDA tensors only and raises on anything the kernel does not take;
there is no fallback to the plain loop.  The kernel is built with nvcc on
first use (``utils/cuda_build.py``) and launched on the current stream;
every launch is counted in ``METRICS.launches["eg_warmstart"]``.

:func:`eg_steps_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import load_cuda_library, load_host_library
from ..utils.metrics import METRICS

KERNEL = "eg_warmstart"
_ERR_SMEM = -1
_PARAMS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["eg_warmstart.cu"], ["eg_lane.cuh"])
        lib.qpn_eg_warmstart_f32.restype = ctypes.c_int
        lib.qpn_eg_warmstart_f32.argtypes = _PARAMS + [ctypes.c_void_p]
        lib.qpn_eg_lane_bytes.restype = ctypes.c_longlong
        lib.qpn_eg_lane_bytes.argtypes = [ctypes.c_int]
        lib.qpn_eg_error_string.restype = ctypes.c_char_p
        lib.qpn_eg_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("eg_lane_host", ["eg_lane_host.cpp"],
                                ["eg_lane.cuh"])
        lib.qpn_eg_warmstart_host_f32.restype = None
        lib.qpn_eg_warmstart_host_f32.argtypes = _PARAMS
        lib.qpn_eg_pick_chunk.restype = ctypes.c_int
        lib.qpn_eg_pick_chunk.argtypes = [ctypes.c_int]
        _HOST_LIB = lib
    return _HOST_LIB


def build() -> None:
    """Build (or find) the kernel library now, so a caller can time the
    build apart from the first launch."""
    _cuda_lib()


def _check(M, q, l, u, z0, tau, steps) -> None:
    """Device, dtype, shape and contiguity of every input, as the kernel
    reads them."""
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"eg kernel: M shape {tuple(M.shape)}, expected "
                         "(B, n, n)")
    B, n, _ = M.shape
    want = dict(M=(B, n, n), q=(B, n), l=(B, n), u=(B, n), z0=(B, n),
                tau=(B,))
    for name, t in zip(want, (M, q, l, u, z0, tau)):
        if t.dtype != torch.float32:
            raise TypeError(f"eg kernel: {name} is {t.dtype}, expected "
                            "float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"eg kernel: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.device != M.device:
            raise ValueError(f"eg kernel: {name} on {t.device}, M on "
                             f"{M.device}")
        if not t.is_contiguous():
            raise ValueError(f"eg kernel: {name} is not contiguous")
    if steps < 0:
        raise ValueError(f"eg kernel: steps={steps} < 0")


def _args(M, q, l, u, z0, tau, out, steps):
    B, n, _ = M.shape
    return [*(t.data_ptr() for t in (M, q, l, u, z0, tau, out)), B, n,
            int(steps)]


def eg_warmstart_cuda(M, q, l, u, z0, tau, steps: int) -> torch.Tensor:
    """Run ``steps`` extragradient steps of every lane in the CUDA kernel
    (one launch).  M (B,n,n); q/l/u/z0 (B,n); tau (B,); all f32 on one CUDA
    device.  The launcher picks the kernel from n: the register kernel up to
    n = 128, beyond that the generic shared-memory kernel."""
    if M.device.type != "cuda":
        raise ValueError("eg_warmstart_cuda takes CUDA tensors; CPU tensors "
                         "go to eg.eg_steps_torch")
    _check(M, q, l, u, z0, tau, steps)
    out = torch.empty_like(z0)
    if M.shape[0] == 0 or M.shape[1] == 0:
        return out
    lib = _cuda_lib()
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        rc = lib.qpn_eg_warmstart_f32(*_args(M, q, l, u, z0, tau, out, steps),
                                      stream)
    if rc == _ERR_SMEM:
        n = M.shape[1]
        raise ValueError(f"eg kernel: a lane of n={n} needs "
                         f"{lib.qpn_eg_lane_bytes(n)} bytes of shared memory, "
                         "more than a block can have on this card")
    if rc != 0:
        raise RuntimeError("eg kernel launch failed: "
                           + lib.qpn_eg_error_string(rc).decode())
    METRICS.launched(KERNEL)
    return out


def eg_steps_host(M, q, l, u, z0, tau, steps: int) -> torch.Tensor:
    """The kernel's lane code built for the host, on CPU tensors: every sum
    in the order of the kernel that the launcher picks for this n."""
    if M.device.type != "cpu":
        raise ValueError("eg_steps_host takes CPU tensors")
    _check(M, q, l, u, z0, tau, steps)
    out = torch.empty_like(z0)
    _host_lib().qpn_eg_warmstart_host_f32(
        *_args(M, q, l, u, z0, tau, out, steps))
    return out


def host_pick_chunk(n: int) -> int:
    """Columns per thread of the register kernel's instance for rows of
    ``n`` columns (0: none, the generic kernel), from the kernel's header."""
    return _host_lib().qpn_eg_pick_chunk(int(n))
