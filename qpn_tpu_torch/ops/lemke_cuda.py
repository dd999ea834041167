"""Wrapper of the hand-written Hopper kernel for the Lemke pivot loop
(``csrc/lemke_pivot.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/lemke_pallas.py::_make_kernel``).

:func:`lemke_pivot_cuda` takes the :class:`~.lemke.LemkeInit` that
``lemke.lemke_setup`` builds and returns a :class:`~.lemke.PivotResult`,
exactly like the plain PyTorch loop ``lemke.lemke_pivot_torch`` it is held
against.  It takes CUDA tensors only and raises on anything the kernel does
not take; there is no fallback to the plain loop.  The kernel is built with
nvcc on first use and launched on the current stream through its declared
library :data:`LIB` (``utils/cuda_build.py``).  Before the launch the
wrapper picks one of the kernel's three instances from the shape alone
(``csrc/lemke_lane.cuh::lane_instance``
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

from ctypes import (CDLL, POINTER, c_char_p, c_double, c_float, c_int,
                    c_longlong, c_void_p)
from typing import Optional

import torch

from ..utils.cuda_build import (EITHER_FLOAT, HOPPER_RESIDENT_BLOCKS,
                                HOPPER_SMEM_OPTIN, Build, KernelInputs,
                                KernelLibrary)
from ..utils.metrics import METRICS
from .lemke import LemkeInit, PivotResult

KERNEL = "lemke_pivot"
KERNEL_GLOBAL = "lemke_pivot_global"
KERNEL_CLUSTER = "lemke_pivot_cluster"
GLOBAL_RANKS = "lemke_pivot_global_ranks"
_HEADERS = ["lemke_lane.cuh", "lane_barrier.cuh"]
# csrc/lemke_lane.cuh::lane_instance
LANE_SHARED, LANE_GLOBAL, LANE_CLUSTER = 0, 1, 2
_PARAMS = [c_void_p] * 16 + [c_int, c_int, c_double, c_double, c_int]
_TYPES = ("f32", "f64")
LIB = KernelLibrary(
    cuda=Build(KERNEL, ["lemke_pivot.cu"], [*_HEADERS, "cluster_launch.cuh"], {
        **{f"qpn_lemke_pivot_{t}": (c_int, [*_PARAMS, c_void_p])
           for t in _TYPES},
        **{f"qpn_lemke_pivot_global_{t}": (c_int,
                                           [*_PARAMS, c_int] + [c_void_p] * 3)
           for t in _TYPES},
        **{f"qpn_lemke_pivot_cluster_{t}": (c_int, [*_PARAMS, c_int, c_void_p])
           for t in _TYPES},
        "qpn_lemke_smem_optin": (c_longlong, []),
        "qpn_lemke_global_resident": (c_longlong, [c_int]),
        "qpn_cuda_error_string": (c_char_p, [c_int])}),
    host=Build("lemke_lane_host", ["lemke_lane_host.cpp"], _HEADERS, {
        **{f"qpn_lemke_pivot_host_{t}": (None, [*_PARAMS, c_int, c_int])
           for t in _TYPES},
        "qpn_lk_scan_min_f64": (c_double, [c_void_p, c_int]),
        "qpn_lk_scan_min_f32": (c_float, [c_void_p, c_int]),
        "qpn_lk_scan_ties_f64": (c_int, [c_void_p, c_void_p, c_int, c_double,
                                         c_int, c_void_p, POINTER(c_int)]),
        "qpn_lemke_lane_stride": (c_int, [c_int]),
        "qpn_lemke_spread_own_bytes": (c_longlong, [c_int, c_int]),
        "qpn_lemke_cluster_stride": (c_int, [c_int, c_int, c_int,
                                             c_longlong])}),
    shape={
        "qpn_lemke_lane_bytes": (c_longlong, [c_int, c_int]),
        "qpn_lemke_lane_instance": (c_int, [c_int, c_int, c_longlong]),
        "qpn_lemke_cluster_ranks": (c_int, [c_int, c_int, c_longlong]),
        "qpn_lemke_band_bytes": (c_longlong, [c_int] * 3),
        "qpn_lemke_global_lane_bytes": (c_longlong, [c_int] * 3),
        "qpn_lemke_global_ranks": (c_int, [c_int] * 3 + [c_longlong] * 2)},
    error="qpn_cuda_error_string", optin="qpn_lemke_smem_optin")
# the fields of LemkeInit, in its order
_INPUTS = KernelInputs(
    "lemke pivot kernel", T=("B n 3n+2", EITHER_FLOAT),
    basis=("B n", torch.int32), val=("B 3n+1", EITHER_FLOAT),
    ent=("B", torch.int32), edir=("B", EITHER_FLOAT), ev=("B", EITHER_FLOAT),
    status=("B", torch.int32), var_lb=("B 3n+1", EITHER_FLOAT),
    var_ub=("B 3n+1", EITHER_FLOAT), l_eff=("B n", EITHER_FLOAT),
    u_eff=("B n", EITHER_FLOAT))
build = LIB.build


def host_lane_instance(n: int, itemsize: int, optin: int) -> int:
    """The instance the launcher picks for a lane of ``n`` (LANE_SHARED,
    LANE_CLUSTER or LANE_GLOBAL) under the opt-in limit ``optin`` in bytes,
    from the kernel's header built for the host."""
    return LIB.host().qpn_lemke_lane_instance(int(n), int(itemsize),
                                               int(optin))


def host_cluster_ranks(n: int, itemsize: int, optin: int) -> int:
    """The blocks of the cluster instance's lane of ``n`` under the opt-in
    limit ``optin`` (0: no cluster of at most 8 holds it), from the
    kernel's header built for the host."""
    return LIB.host().qpn_lemke_cluster_ranks(int(n), int(itemsize),
                                               int(optin))


def host_lane_bytes(n: int, itemsize: int) -> int:
    """Bytes of one lane's working set, from the kernel's header."""
    return LIB.host().qpn_lemke_lane_bytes(int(n), int(itemsize))


def host_band_bytes(n: int, itemsize: int, ranks: int) -> int:
    """Bytes of one rank's part of a lane of ``n`` spread over ``ranks``
    blocks, from the kernel's header."""
    return LIB.host().qpn_lemke_band_bytes(int(n), int(itemsize),
                                            int(ranks))


def host_global_ranks(n: int, itemsize: int, lanes: int, resident: int,
                      optin: int) -> int:
    """The global instance's blocks a lane for ``lanes`` lanes of ``n`` on
    a card that holds ``resident`` of its blocks at once, under the opt-in
    limit ``optin`` (1: one block's lane), from the kernel's header."""
    return LIB.host().qpn_lemke_global_ranks(int(n), int(itemsize),
                                              int(lanes), int(resident),
                                              int(optin))


def host_global_lane_bytes(n: int, itemsize: int, ranks: int) -> int:
    """Bytes of the global instance's workspace a lane at ``ranks``."""
    return LIB.host().qpn_lemke_global_lane_bytes(int(n), int(itemsize),
                                                   int(ranks))


def host_cluster_stride(n: int, itemsize: int, ranks: int,
                        optin: int) -> int:
    """Elements between the rows of the cluster instance's band at
    ``ranks`` blocks under ``optin`` (its launcher's choice: a stride at
    which the fused pass's reads meet no bank conflict where the band still
    fits, else the odd stride), from the kernel's header."""
    return LIB.host().qpn_lemke_cluster_stride(int(n), int(itemsize),
                                                int(ranks), int(optin))


def host_spread_own_bytes(n: int, itemsize: int) -> int:
    """Bytes of a spread global rank's own part (its shared memory)."""
    return LIB.host().qpn_lemke_spread_own_bytes(int(n), int(itemsize))


def _ranks(lib: CDLL, n: int, itemsize: int, optin: int, lanes: int,
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


def card_instance(n: int, itemsize: int, device: torch.device,
                  lanes: int = 1) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for ``lanes`` lanes of
    ``n`` on the CUDA ``device``."""
    return _ranks(LIB.cuda(), int(n), int(itemsize), LIB.optin(device),
                  int(lanes), lambda: LIB.card("qpn_lemke_global_resident",
                                               device, int(itemsize)))


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
    the instance that the lane's shape picks); CPU tensors go to
    ``lemke.lemke_pivot_torch``."""
    return _launch(init, tol=tol, piv_tol=piv_tol, max_pivots=max_pivots)


def _launch(init: LemkeInit, *, tol, piv_tol, max_pivots,
            instance: Optional[int] = None, ranks: int = 1) -> PivotResult:
    """One launch on inputs checked here: of the instance and ranks that
    the shape picks, or of ``instance`` over ``ranks`` blocks a lane
    (LANE_CLUSTER and LANE_GLOBAL), counted under its name.
    ``chip_smoke.py`` and the GPU tests force an instance to run the global
    instance at cluster sizes or at R = 1, and sizes the card refuses."""
    _INPUTS(init, "cuda")
    out = _outputs(init)
    B, n, _ = init.T.shape
    if B == 0:
        return out
    device = init.T.device
    itemsize = init.T.element_size()
    if instance is None:
        instance, ranks = card_instance(n, itemsize, device, lanes=B)
    ty = "f32" if init.T.dtype == torch.float32 else "f64"
    args = _args(init, out, tol, piv_tol, max_pivots)
    if instance == LANE_GLOBAL:
        workspace = torch.empty(
            B * LIB.cuda().qpn_lemke_global_lane_bytes(n, itemsize,
                                                       int(ranks)),
            dtype=torch.uint8, device=device)
        # each lane's barrier: an arrival count and a generation
        bars = (torch.zeros(2 * B, dtype=torch.int32, device=device)
                if ranks > 1 else None)
        LIB.launch(KERNEL_GLOBAL, "qpn_lemke_pivot_global_" + ty, device,
                   *args, int(ranks), workspace.data_ptr(),
                   None if bars is None else bars.data_ptr())
        METRICS.bump(GLOBAL_RANKS, int(ranks))
    elif instance == LANE_CLUSTER:
        LIB.launch(KERNEL_CLUSTER, "qpn_lemke_pivot_cluster_" + ty, device,
                   *args, int(ranks))
    elif instance == LANE_SHARED:
        LIB.launch(KERNEL, "qpn_lemke_pivot_" + ty, device, *args)
    else:
        raise ValueError(f"lemke pivot kernel: no instance {instance}")
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
    _INPUTS(init, "cpu")
    lib = LIB.host()
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
