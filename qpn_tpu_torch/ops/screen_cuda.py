"""Wrapper of the hand-written Hopper kernel for the f32 feasibility screen
(``csrc/screen.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/pallas_kernels.py::_screen_kernel``).

:func:`feasibility_screen_cuda` takes the prepared f32 tensors of
``screen.screen_prepare`` and returns each polyhedron's x after ``steps``
projected-subgradient steps and its max |violation|, exactly like the plain
PyTorch loop ``screen.screen_steps_torch`` it is held against.  It takes CUDA
tensors only and raises on anything the kernel does not take; there is no
fallback to the plain loop.  Before the launch the wrapper picks the
instance from the shape alone (``csrc/screen_lane.cuh::screen_instance``
against the card's shared-memory opt-in limit): one polyhedron in a warp
with A in registers up to 32 rows and columns, else a thread block per
polyhedron with A in shared memory, both counted in
``METRICS.launches["feasibility_screen"]``; where A does not fit (m = n
above 238 on an H100), a polyhedron spread over a thread-block cluster of
2-8 blocks (``screen_cluster_ranks``: the fewest whose bands of A fit; m =
n up to 473), counted in ``METRICS.launches["feasibility_screen_cluster"]``;
past that, a thread block per polyhedron with A in device memory (read in
place, and from a column-major copy the kernel writes at its start into a
workspace allocated here), counted in
``METRICS.launches["feasibility_screen_global"]``.  There is no launch
option.  A launch the card refuses raises ``RuntimeError`` with CUDA's
message; no other instance is tried.  The kernel is built with nvcc on first
use (``utils/cuda_build.py``) and launched on the current stream.

:func:`screen_steps_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic — with the cluster's
ranks emulated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import (HOPPER_SMEM_OPTIN, load_cuda_library,
                                load_host_library, smem_optin)
from ..utils.metrics import METRICS

KERNEL = "feasibility_screen"
KERNEL_GLOBAL = "feasibility_screen_global"
KERNEL_CLUSTER = "feasibility_screen_cluster"
_HEADERS = ["screen_lane.cuh"]
# csrc/screen_lane.cuh::screen_instance
SCREEN_WARP, SCREEN_SHARED, SCREEN_GLOBAL, SCREEN_CLUSTER = 0, 1, 2, 3
_COUNTED = {SCREEN_WARP: KERNEL, SCREEN_SHARED: KERNEL,
            SCREEN_GLOBAL: KERNEL_GLOBAL, SCREEN_CLUSTER: KERNEL_CLUSTER}
_PARAMS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["screen.cu"],
                                [*_HEADERS, "cluster_launch.cuh"])
        lib.qpn_screen_f32.restype = ctypes.c_int
        lib.qpn_screen_f32.argtypes = _PARAMS + [ctypes.c_void_p]
        lib.qpn_screen_cluster_f32.restype = ctypes.c_int
        lib.qpn_screen_cluster_f32.argtypes = _PARAMS + [ctypes.c_int,
                                                         ctypes.c_void_p]
        lib.qpn_screen_global_f32.restype = ctypes.c_int
        lib.qpn_screen_global_f32.argtypes = _PARAMS + [ctypes.c_void_p] * 2
        _instance_function(lib)
        lib.qpn_screen_smem_optin.restype = ctypes.c_longlong
        lib.qpn_screen_smem_optin.argtypes = []
        lib.qpn_screen_error_string.restype = ctypes.c_char_p
        lib.qpn_screen_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("screen_lane_host", ["screen_lane_host.cpp"],
                                _HEADERS)
        lib.qpn_screen_host_f32.restype = None
        lib.qpn_screen_host_f32.argtypes = _PARAMS + [ctypes.c_longlong,
                                                      ctypes.c_int]
        lib.qpn_screen_host_generic_f32.restype = None
        lib.qpn_screen_host_generic_f32.argtypes = _PARAMS
        lib.qpn_screen_cluster_bytes.restype = ctypes.c_longlong
        lib.qpn_screen_cluster_bytes.argtypes = [ctypes.c_int] * 3
        _instance_function(lib)
        _HOST_LIB = lib
    return _HOST_LIB


def _instance_function(lib: ctypes.CDLL) -> None:
    for fn in (lib.qpn_screen_instance, lib.qpn_screen_cluster_ranks):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]


def _pick(lib: ctypes.CDLL, m: int, n: int, optin: int) -> tuple[int, int]:
    """(instance, ranks) that ``lib``'s pure choice gives polyhedra of ``m``
    rows in dimension ``n`` under ``optin``: ranks 1 but in the cluster
    instance."""
    instance = lib.qpn_screen_instance(m, n, optin)
    if instance == SCREEN_CLUSTER:
        return instance, lib.qpn_screen_cluster_ranks(m, n, optin)
    return instance, 1


def card_optin(device: torch.device) -> int:
    """The shared memory a block can opt into on the CUDA ``device``, as
    the kernel library reads it (the limit the instance is picked by)."""
    lib = _cuda_lib()
    return smem_optin(lib.qpn_screen_smem_optin, device)


def card_instance(m: int, n: int, device: torch.device) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for polyhedra of ``m`` rows
    in dimension ``n`` on the CUDA ``device``."""
    return _pick(_cuda_lib(), int(m), int(n), card_optin(device))


def build() -> None:
    """Build (or find) the kernel library now, so a caller can time the
    build apart from the first launch."""
    _cuda_lib()


def _check(A, l, u, x0, steps) -> None:
    """Device, dtype, shape and contiguity of every input, as the kernel
    reads them."""
    if A.dim() != 3:
        raise ValueError(f"screen kernel: A shape {tuple(A.shape)}, expected "
                         "(B, m, n)")
    B, m, n = A.shape
    want = dict(A=(B, m, n), l=(B, m), u=(B, m), x0=(B, n))
    for name, t in zip(want, (A, l, u, x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"screen kernel: {name} is {t.dtype}, expected "
                            "float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"screen kernel: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.device != A.device:
            raise ValueError(f"screen kernel: {name} on {t.device}, A on "
                             f"{A.device}")
        if not t.is_contiguous():
            raise ValueError(f"screen kernel: {name} is not contiguous")
    if steps < 0:
        raise ValueError(f"screen kernel: steps={steps} < 0")


def _args(A, l, u, x0, x_out, v_out, steps, lr):
    B, m, n = A.shape
    return [*(t.data_ptr() for t in (A, l, u, x0, x_out, v_out)), B, m, n,
            int(steps), float(lr)]


def feasibility_screen_cuda(A, l, u, x0, steps: int, lr: float):
    """Run ``steps`` screen steps of every polyhedron in the CUDA kernel (one
    launch).  A (B,m,n) row-normalised; l/u (B,m); x0 (B,n); all f32 on one
    CUDA device.  Returns (x (B,n), max |v| (B,))."""
    _check_cuda(A, l, u, x0, steps)
    B, m, n = A.shape
    instance, ranks = ((SCREEN_SHARED, 1) if B == 0 or m == 0 or n == 0
                       else card_instance(m, n, A.device))
    return _run(A, l, u, x0, steps, lr, instance, ranks)


def _launch_global(A, l, u, x0, steps: int, lr: float):
    """One launch of the global instance at any shape, counted under its
    name.  :func:`feasibility_screen_cuda` picks the instance from the
    shape; ``chip_smoke.py`` and the GPU tests call this to hold the global
    instance against the cluster instance at the cluster's shapes."""
    _check_cuda(A, l, u, x0, steps)
    return _run(A, l, u, x0, steps, lr, SCREEN_GLOBAL, 1)


def _launch_cluster(A, l, u, x0, steps: int, lr: float, ranks: int):
    """One launch of the cluster instance over ``ranks`` blocks a
    polyhedron, counted under its name: the GPU tests ask for a size the
    card refuses."""
    _check_cuda(A, l, u, x0, steps)
    return _run(A, l, u, x0, steps, lr, SCREEN_CLUSTER, ranks)


def _check_cuda(A, l, u, x0, steps) -> None:
    if A.device.type != "cuda":
        raise ValueError("feasibility_screen_cuda takes CUDA tensors; CPU "
                         "tensors go to screen.screen_steps_torch")
    _check(A, l, u, x0, steps)


def _run(A, l, u, x0, steps: int, lr: float, instance: int, ranks: int):
    """The launch of every entry point, on inputs they have checked."""
    B, m, n = A.shape
    x_out = torch.empty_like(x0)
    v_out = torch.empty(B, dtype=torch.float32, device=A.device)
    if B == 0:
        return x_out, v_out
    if m == 0 or n == 0:
        raise ValueError(f"screen kernel: polyhedra of shape {(m, n)}; the "
                         "caller gives every polyhedron at least one row")
    lib = _cuda_lib()
    args = _args(A, l, u, x0, x_out, v_out, steps, lr)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        if instance == SCREEN_GLOBAL:
            # each polyhedron's column-major copy of A, which the kernel
            # writes and reads
            mt = torch.empty(B * m * n, dtype=torch.float32, device=A.device)
            rc = lib.qpn_screen_global_f32(*args, mt.data_ptr(), stream)
        elif instance == SCREEN_CLUSTER:
            rc = lib.qpn_screen_cluster_f32(*args, int(ranks), stream)
        elif instance in (SCREEN_WARP, SCREEN_SHARED):
            rc = lib.qpn_screen_f32(*args, stream)
        else:
            raise ValueError(f"screen kernel: no instance {instance}")
    if rc != 0:
        raise RuntimeError("screen kernel launch failed: "
                           + lib.qpn_screen_error_string(rc).decode())
    METRICS.launched(_COUNTED[instance])
    return x_out, v_out


def screen_steps_host(A, l, u, x0, steps: int, lr: float,
                      generic: bool = False, optin: int = HOPPER_SMEM_OPTIN,
                      ranks: Optional[int] = None):
    """The kernels' lane code built for the host, on CPU tensors: the
    instance the card's launcher would pick for this shape under the opt-in
    limit ``optin`` (an H100's by default; the warp instance up to 32 rows
    and columns, A carved into the working set, spread over a cluster's
    ranks, or in device memory beyond), with ``ranks`` the cluster instance
    over that many ranks whatever the shape, or with ``generic`` the shared
    instance with A in the working set at any shape."""
    if A.device.type != "cpu":
        raise ValueError("screen_steps_host takes CPU tensors")
    _check(A, l, u, x0, steps)
    if ranks is not None and ranks < 1:
        raise ValueError(f"screen_steps_host: ranks={ranks} < 1")
    B, m, n = A.shape
    x_out = torch.empty_like(x0)
    v_out = torch.empty(B, dtype=torch.float32)
    lib = _host_lib()
    args = _args(A, l, u, x0, x_out, v_out, steps, lr)
    if generic:
        lib.qpn_screen_host_generic_f32(*args)
    else:
        lib.qpn_screen_host_f32(*args, int(optin),
                                0 if ranks is None else int(ranks))
    return x_out, v_out


def host_instance(m: int, n: int, optin: int) -> int:
    """The instance the launcher picks for polyhedra of ``m`` rows in
    dimension ``n`` under the opt-in limit ``optin`` in bytes (SCREEN_WARP,
    SCREEN_SHARED, SCREEN_CLUSTER or SCREEN_GLOBAL), from the kernel's
    header built for the host."""
    return _host_lib().qpn_screen_instance(int(m), int(n), int(optin))


def host_cluster_ranks(m: int, n: int, optin: int) -> int:
    """The blocks of the cluster instance's polyhedron of ``m`` rows in
    dimension ``n`` under the opt-in limit ``optin`` (0: no cluster of at
    most 8 holds it), from the kernel's header built for the host."""
    return _host_lib().qpn_screen_cluster_ranks(int(m), int(n), int(optin))


def host_cluster_bytes(m: int, n: int, ranks: int) -> int:
    """Bytes of one rank's part of a polyhedron of ``m`` rows in dimension
    ``n`` spread over ``ranks`` blocks, from the kernel's header."""
    return _host_lib().qpn_screen_cluster_bytes(int(m), int(n), int(ranks))
