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
use and launched on the current stream through its declared library
:data:`LIB` (``utils/cuda_build.py``).

:func:`screen_steps_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic — with the cluster's
ranks emulated.
"""

from __future__ import annotations

from ctypes import c_char_p, c_float, c_int, c_longlong, c_void_p
from typing import Optional

import torch

from ..utils.cuda_build import (HOPPER_SMEM_OPTIN, Build, KernelInputs,
                                KernelLibrary)

KERNEL = "feasibility_screen"
KERNEL_GLOBAL = "feasibility_screen_global"
KERNEL_CLUSTER = "feasibility_screen_cluster"
_HEADERS = ["screen_lane.cuh"]
# csrc/screen_lane.cuh::screen_instance
SCREEN_WARP, SCREEN_SHARED, SCREEN_GLOBAL, SCREEN_CLUSTER = 0, 1, 2, 3
_PARAMS = [c_void_p] * 6 + [c_int] * 4 + [c_float]
LIB = KernelLibrary(
    cuda=Build(KERNEL, ["screen.cu"], [*_HEADERS, "cluster_launch.cuh"], {
        "qpn_screen_f32": (c_int, [*_PARAMS, c_void_p]),
        "qpn_screen_cluster_f32": (c_int, [*_PARAMS, c_int, c_void_p]),
        "qpn_screen_global_f32": (c_int, [*_PARAMS, c_void_p, c_void_p]),
        "qpn_screen_smem_optin": (c_longlong, []),
        "qpn_screen_error_string": (c_char_p, [c_int])}),
    host=Build("screen_lane_host", ["screen_lane_host.cpp"], _HEADERS, {
        "qpn_screen_host_f32": (None, [*_PARAMS, c_longlong, c_int]),
        "qpn_screen_host_generic_f32": (None, _PARAMS),
        "qpn_screen_cluster_bytes": (c_longlong, [c_int] * 3)}),
    shape={
        "qpn_screen_instance": (c_int, [c_int, c_int, c_longlong]),
        "qpn_screen_cluster_ranks": (c_int, [c_int, c_int, c_longlong])},
    error="qpn_screen_error_string", optin="qpn_screen_smem_optin")
_F32 = torch.float32
_INPUTS = KernelInputs("screen kernel", A=("B m n", _F32), l=("B m", _F32),
                       u=("B m", _F32), x0=("B n", _F32))
build = LIB.build


def card_instance(m: int, n: int, device: torch.device) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for polyhedra of ``m`` rows
    in dimension ``n`` on the CUDA ``device``: ranks 1 but in the cluster
    instance."""
    lib, m, n, optin = LIB.cuda(), int(m), int(n), LIB.optin(device)
    instance = lib.qpn_screen_instance(m, n, optin)
    if instance == SCREEN_CLUSTER:
        return instance, lib.qpn_screen_cluster_ranks(m, n, optin)
    return instance, 1


def _args(A, l, u, x0, x_out, v_out, steps, lr):
    B, m, n = A.shape
    return [*(t.data_ptr() for t in (A, l, u, x0, x_out, v_out)), B, m, n,
            int(steps), float(lr)]


def feasibility_screen_cuda(A, l, u, x0, steps: int, lr: float):
    """Run ``steps`` screen steps of every polyhedron in the CUDA kernel (one
    launch).  A (B,m,n) row-normalised; l/u (B,m); x0 (B,n); all f32 on one
    CUDA device (CPU tensors go to ``screen.screen_steps_torch``).  Returns
    (x (B,n), max |v| (B,))."""
    return _launch(A, l, u, x0, steps, lr)


def _launch(A, l, u, x0, steps: int, lr: float, *,
            instance: Optional[int] = None, ranks: int = 1):
    """One launch on inputs checked here: of the instance and ranks that
    the shape picks, or of ``instance`` (SCREEN_CLUSTER over ``ranks``
    blocks a polyhedron), counted under its name.  ``chip_smoke.py`` and the
    GPU tests force the global instance to hold it against the cluster
    instance at the cluster's shapes, and a cluster size the card
    refuses."""
    _INPUTS((A, l, u, x0), "cuda", steps=steps)
    B, m, n = A.shape
    x_out = torch.empty_like(x0)
    v_out = torch.empty(B, dtype=torch.float32, device=A.device)
    if B == 0:
        return x_out, v_out
    if m == 0 or n == 0:
        raise ValueError(f"screen kernel: polyhedra of shape {(m, n)}; the "
                         "caller gives every polyhedron at least one row")
    if instance is None:
        instance, ranks = card_instance(m, n, A.device)
    args = _args(A, l, u, x0, x_out, v_out, steps, lr)
    if instance == SCREEN_GLOBAL:
        # each polyhedron's column-major copy of A, which the kernel writes
        # and reads
        mt = torch.empty(B * m * n, dtype=torch.float32, device=A.device)
        LIB.launch(KERNEL_GLOBAL, "qpn_screen_global_f32", A.device, *args,
                   mt.data_ptr())
    elif instance == SCREEN_CLUSTER:
        LIB.launch(KERNEL_CLUSTER, "qpn_screen_cluster_f32", A.device, *args,
                   int(ranks))
    elif instance in (SCREEN_WARP, SCREEN_SHARED):
        LIB.launch(KERNEL, "qpn_screen_f32", A.device, *args)
    else:
        raise ValueError(f"screen kernel: no instance {instance}")
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
    _INPUTS((A, l, u, x0), "cpu", steps=steps)
    if ranks is not None and ranks < 1:
        raise ValueError(f"screen_steps_host: ranks={ranks} < 1")
    B, m, n = A.shape
    x_out = torch.empty_like(x0)
    v_out = torch.empty(B, dtype=torch.float32)
    lib = LIB.host()
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
    return LIB.host().qpn_screen_instance(int(m), int(n), int(optin))


def host_cluster_ranks(m: int, n: int, optin: int) -> int:
    """The blocks of the cluster instance's polyhedron of ``m`` rows in
    dimension ``n`` under the opt-in limit ``optin`` (0: no cluster of at
    most 8 holds it), from the kernel's header built for the host."""
    return LIB.host().qpn_screen_cluster_ranks(int(m), int(n), int(optin))


def host_cluster_bytes(m: int, n: int, ranks: int) -> int:
    """Bytes of one rank's part of a polyhedron of ``m`` rows in dimension
    ``n`` spread over ``ranks`` blocks, from the kernel's header."""
    return LIB.host().qpn_screen_cluster_bytes(int(m), int(n), int(ranks))
