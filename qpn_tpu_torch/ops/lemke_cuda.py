"""Wrapper of the hand-written Hopper kernel for the Lemke pivot loop
(``csrc/lemke_pivot.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/lemke_pallas.py::_make_kernel``).

:func:`lemke_pivot_cuda` takes the :class:`~.lemke.LemkeInit` that
``lemke.lemke_setup`` builds and returns a :class:`~.lemke.PivotResult`,
exactly like the plain PyTorch loop ``lemke.lemke_pivot_torch`` it is held
against.  It takes CUDA tensors only and raises on anything the kernel does
not take; there is no fallback to the plain loop.  The kernel is built with
nvcc on first use (``utils/cuda_build.py``) and launched on the current
stream.  Before the launch the wrapper picks one of the kernel's three
instances from the shape alone (``csrc/lemke_lane.cuh::lane_instance``
against the card's shared-memory opt-in limit): the lane in the block's
shared memory, counted in ``METRICS.launches["lemke_pivot"]``; for a lane
that does not fit (f32 n >= 136, f64 n >= 95 on an H100), the lane spread
over a cluster of 2-8 blocks (``lane_cluster_ranks``), counted in
``METRICS.launches["lemke_pivot_cluster"]``; past 8 blocks, the lane in a
device-memory workspace that the wrapper allocates, counted in
``METRICS.launches["lemke_pivot_global"]``.  The global instance spreads
each lane over the ranks ``lane_global_ranks`` picks from the shape, the
batch and the card's resident blocks (R blocks on any SMs meeting at a
barrier in device memory; R = 1 where the batch fills the card); the ranks
of its launches are summed in ``METRICS.counters["lemke_pivot_global_ranks"]``.
A launch the card refuses raises ``RuntimeError`` with CUDA's message; no
other instance is tried.

:func:`lemke_pivot_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic — with the lane
spread over the ranks the card's launcher would give it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import (HOPPER_RESIDENT_BLOCKS, HOPPER_SMEM_OPTIN,
                                card_query, load_cuda_library,
                                load_host_library, smem_optin)
from ..utils.metrics import METRICS
from .lemke import LemkeInit, PivotResult

KERNEL = "lemke_pivot"
KERNEL_GLOBAL = "lemke_pivot_global"
KERNEL_CLUSTER = "lemke_pivot_cluster"
GLOBAL_RANKS = "lemke_pivot_global_ranks"
_HEADERS = ["lemke_lane.cuh", "lane_barrier.cuh"]
# csrc/lemke_lane.cuh::lane_instance
LANE_SHARED, LANE_GLOBAL, LANE_CLUSTER = 0, 1, 2
_COUNTED = {LANE_SHARED: KERNEL, LANE_GLOBAL: KERNEL_GLOBAL,
            LANE_CLUSTER: KERNEL_CLUSTER}
_PARAMS = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_int]
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["lemke_pivot.cu"],
                                [*_HEADERS, "cluster_launch.cuh"])
        for fn in (lib.qpn_lemke_pivot_f32, lib.qpn_lemke_pivot_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_void_p]
        for fn in (lib.qpn_lemke_pivot_global_f32,
                   lib.qpn_lemke_pivot_global_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_int] + [ctypes.c_void_p] * 3
        for fn in (lib.qpn_lemke_pivot_cluster_f32,
                   lib.qpn_lemke_pivot_cluster_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = _PARAMS + [ctypes.c_int, ctypes.c_void_p]
        _shape_functions(lib)
        lib.qpn_lemke_smem_optin.restype = ctypes.c_longlong
        lib.qpn_lemke_smem_optin.argtypes = []
        lib.qpn_lemke_global_resident.restype = ctypes.c_longlong
        lib.qpn_lemke_global_resident.argtypes = [ctypes.c_int]
        lib.qpn_cuda_error_string.restype = ctypes.c_char_p
        lib.qpn_cuda_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("lemke_lane_host", ["lemke_lane_host.cpp"],
                                _HEADERS)
        for fn in (lib.qpn_lemke_pivot_host_f32, lib.qpn_lemke_pivot_host_f64):
            fn.restype = None
            fn.argtypes = _PARAMS + [ctypes.c_int] * 2
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn, res, args in (
                (lib.qpn_lk_scan_min_f64, ctypes.c_double, [vp, ci]),
                (lib.qpn_lk_scan_min_f32, ctypes.c_float, [vp, ci]),
                (lib.qpn_lk_scan_ties_f64, ci,
                 [vp, vp, ci, ctypes.c_double, ci, vp,
                  ctypes.POINTER(ci)]),
                (lib.qpn_lemke_lane_stride, ci, [ci]),
                (lib.qpn_lemke_spread_own_bytes, ctypes.c_longlong,
                 [ci, ci]),
                (lib.qpn_lemke_cluster_stride, ci,
                 [ci, ci, ci, ctypes.c_longlong])):
            fn.restype, fn.argtypes = res, args
        _shape_functions(lib)
        _HOST_LIB = lib
    return _HOST_LIB


def _shape_functions(lib: ctypes.CDLL) -> None:
    """Types of the pure functions of the shape that both libraries
    export."""
    lib.qpn_lemke_lane_bytes.restype = ctypes.c_longlong
    lib.qpn_lemke_lane_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.qpn_lemke_lane_instance, lib.qpn_lemke_cluster_ranks):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.qpn_lemke_band_bytes.restype = ctypes.c_longlong
    lib.qpn_lemke_band_bytes.argtypes = [ctypes.c_int] * 3
    lib.qpn_lemke_global_lane_bytes.restype = ctypes.c_longlong
    lib.qpn_lemke_global_lane_bytes.argtypes = [ctypes.c_int] * 3
    lib.qpn_lemke_global_ranks.restype = ctypes.c_int
    lib.qpn_lemke_global_ranks.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 2


def host_lane_instance(n: int, itemsize: int, optin: int) -> int:
    """The instance the launcher picks for a lane of ``n`` (LANE_SHARED,
    LANE_CLUSTER or LANE_GLOBAL) under the opt-in limit ``optin`` in bytes,
    from the kernel's header built for the host."""
    return _host_lib().qpn_lemke_lane_instance(int(n), int(itemsize),
                                               int(optin))


def host_cluster_ranks(n: int, itemsize: int, optin: int) -> int:
    """The blocks of the cluster instance's lane of ``n`` under the opt-in
    limit ``optin`` (0: no cluster of at most 8 holds it), from the
    kernel's header built for the host."""
    return _host_lib().qpn_lemke_cluster_ranks(int(n), int(itemsize),
                                               int(optin))


def host_lane_bytes(n: int, itemsize: int) -> int:
    """Bytes of one lane's working set, from the kernel's header."""
    return _host_lib().qpn_lemke_lane_bytes(int(n), int(itemsize))


def host_band_bytes(n: int, itemsize: int, ranks: int) -> int:
    """Bytes of one rank's part of a lane of ``n`` spread over ``ranks``
    blocks, from the kernel's header."""
    return _host_lib().qpn_lemke_band_bytes(int(n), int(itemsize),
                                            int(ranks))


def host_global_ranks(n: int, itemsize: int, lanes: int, resident: int,
                      optin: int) -> int:
    """The global instance's blocks a lane for ``lanes`` lanes of ``n`` on
    a card that holds ``resident`` of its blocks at once, under the opt-in
    limit ``optin`` (1: one block's lane), from the kernel's header."""
    return _host_lib().qpn_lemke_global_ranks(int(n), int(itemsize),
                                              int(lanes), int(resident),
                                              int(optin))


def host_global_lane_bytes(n: int, itemsize: int, ranks: int) -> int:
    """Bytes of the global instance's workspace a lane at ``ranks``."""
    return _host_lib().qpn_lemke_global_lane_bytes(int(n), int(itemsize),
                                                   int(ranks))


def host_cluster_stride(n: int, itemsize: int, ranks: int,
                        optin: int) -> int:
    """Elements between the rows of the cluster instance's band at
    ``ranks`` blocks under ``optin`` (its launcher's choice: a stride at
    which the fused pass's reads meet no bank conflict where the band still
    fits, else the odd stride), from the kernel's header."""
    return _host_lib().qpn_lemke_cluster_stride(int(n), int(itemsize),
                                                int(ranks), int(optin))


def host_spread_own_bytes(n: int, itemsize: int) -> int:
    """Bytes of a spread global rank's own part (its shared memory)."""
    return _host_lib().qpn_lemke_spread_own_bytes(int(n), int(itemsize))


def _ranks(lib: ctypes.CDLL, n: int, itemsize: int, optin: int, lanes: int,
           resident) -> tuple[int, int]:
    """(instance, ranks) that ``lib``'s pure choice gives ``lanes`` lanes
    of ``n`` under ``optin`` on a card that holds ``resident()`` blocks of
    the global instance (asked only for it): ranks 1 for the shared
    instance."""
    instance = lib.qpn_lemke_lane_instance(n, itemsize, optin)
    if instance == LANE_CLUSTER:
        return instance, lib.qpn_lemke_cluster_ranks(n, itemsize, optin)
    if instance == LANE_GLOBAL:
        return instance, lib.qpn_lemke_global_ranks(n, itemsize, lanes,
                                                    resident(), optin)
    return instance, 1


def card_optin(device: torch.device) -> int:
    """The shared memory a block can opt into on the CUDA ``device``, as
    the kernel library reads it (the limit the instance is picked by)."""
    lib = _cuda_lib()
    return smem_optin(lib.qpn_lemke_smem_optin, device)


def card_resident(itemsize: int, device: torch.device) -> int:
    """Blocks of the global instance that the CUDA ``device`` holds at
    once, each with the opt-in limit of shared memory (one an SM)."""
    lib = _cuda_lib()
    return card_query(f"lemke_global_resident_{int(itemsize)}",
                      lambda: lib.qpn_lemke_global_resident(int(itemsize)),
                      device)


def card_instance(n: int, itemsize: int, device: torch.device,
                  lanes: int = 1) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for ``lanes`` lanes of
    ``n`` on the CUDA ``device``."""
    return _ranks(_cuda_lib(), int(n), int(itemsize), card_optin(device),
                  int(lanes), lambda: card_resident(itemsize, device))


def host_scans() -> ctypes.CDLL:
    """The host library, whose ``qpn_lk_scan_*`` functions are the host
    bodies of the decision's scans (``csrc/lemke_lane.cuh``); the CPU tests
    hold them against numpy."""
    return _host_lib()


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


def lemke_pivot_cuda(init: LemkeInit, *, tol, piv_tol, max_pivots
                     ) -> PivotResult:
    """Run the pivot loop of every lane in the CUDA kernel (one launch of
    the instance that the lane's shape picks)."""
    if init.T.device.type != "cuda":
        raise ValueError("lemke_pivot_cuda takes CUDA tensors; CPU tensors "
                         "go to lemke.lemke_pivot_torch")
    _check(init)
    B, n = init.T.shape[:2]
    instance, ranks = card_instance(n, init.T.element_size(), init.T.device,
                                    lanes=B)
    return _run(init, tol, piv_tol, max_pivots, instance, ranks)


def _launch(init: LemkeInit, *, tol, piv_tol, max_pivots, instance: int,
            ranks: int = 1) -> PivotResult:
    """One launch of the given instance over ``ranks`` blocks a lane
    (LANE_CLUSTER and LANE_GLOBAL), counted under its name.
    :func:`lemke_pivot_cuda` picks the instance and its ranks from the
    shape; ``chip_smoke.py`` and the GPU tests call this to run the global
    instance at cluster sizes or at R = 1, and sizes the card refuses."""
    if init.T.device.type != "cuda":
        raise ValueError("the lemke pivot kernel takes CUDA tensors")
    _check(init)
    return _run(init, tol, piv_tol, max_pivots, instance, ranks)


def _run(init: LemkeInit, tol, piv_tol, max_pivots, instance: int,
         ranks: int) -> PivotResult:
    """The launch of both entry points, on inputs they have checked."""
    out = _outputs(init)
    B, n, _ = init.T.shape
    if B == 0:
        return out
    lib = _cuda_lib()
    device = init.T.device
    f32 = init.T.dtype == torch.float32
    itemsize = init.T.element_size()
    args = _args(init, out, tol, piv_tol, max_pivots)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if instance == LANE_GLOBAL:
            workspace = torch.empty(
                B * lib.qpn_lemke_global_lane_bytes(n, itemsize, int(ranks)),
                dtype=torch.uint8, device=device)
            # each lane's barrier: an arrival count and a generation
            bars = (torch.zeros(2 * B, dtype=torch.int32, device=device)
                    if ranks > 1 else None)
            fn = (lib.qpn_lemke_pivot_global_f32 if f32
                  else lib.qpn_lemke_pivot_global_f64)
            rc = fn(*args, int(ranks), workspace.data_ptr(),
                    None if bars is None else bars.data_ptr(), stream)
        elif instance == LANE_CLUSTER:
            fn = (lib.qpn_lemke_pivot_cluster_f32 if f32
                  else lib.qpn_lemke_pivot_cluster_f64)
            rc = fn(*args, int(ranks), stream)
        elif instance == LANE_SHARED:
            fn = lib.qpn_lemke_pivot_f32 if f32 else lib.qpn_lemke_pivot_f64
            rc = fn(*args, stream)
        else:
            raise ValueError(f"lemke pivot kernel: no instance {instance}")
    if rc != 0:
        raise RuntimeError("lemke pivot kernel launch failed: "
                           + lib.qpn_cuda_error_string(rc).decode())
    METRICS.launched(_COUNTED[instance])
    if instance == LANE_GLOBAL:
        METRICS.bump(GLOBAL_RANKS, int(ranks))
    return out


def lemke_pivot_host(init: LemkeInit, *, tol, piv_tol, max_pivots,
                     optin: int = HOPPER_SMEM_OPTIN,
                     ranks: Optional[int] = None) -> PivotResult:
    """The kernel's lane code built for the host, on CPU tensors, every sum
    in the kernel's order: the lane spread over ``ranks`` ranks (each phase
    run for one rank after another) and carved as the instance the launcher
    picks under the opt-in limit ``optin`` (an H100's by default) carves
    it; by default the ranks it picks for this batch on an H100 (1 for the
    shared instance)."""
    if init.T.device.type != "cpu":
        raise ValueError("lemke_pivot_host takes CPU tensors")
    _check(init)
    lib = _host_lib()
    B, n = init.T.shape[:2]
    itemsize = init.T.element_size()
    instance, picked = _ranks(lib, n, itemsize, int(optin), B,
                              lambda: HOPPER_RESIDENT_BLOCKS)
    if ranks is None:
        ranks = picked
    if ranks < 1:
        raise ValueError(f"lemke_pivot_host: ranks={ranks} < 1")
    out = _outputs(init)
    fn = (lib.qpn_lemke_pivot_host_f32 if init.T.dtype == torch.float32
          else lib.qpn_lemke_pivot_host_f64)
    fn(*_args(init, out, tol, piv_tol, max_pivots), int(ranks),
       int(instance == LANE_GLOBAL))
    return out
