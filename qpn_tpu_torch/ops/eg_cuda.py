"""Wrapper of the hand-written Hopper kernel for the fused extragradient
steps (``csrc/eg_warmstart.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/pallas_kernels.py::_eg_kernel``).

:func:`eg_warmstart_cuda` takes the prepared f32 tensors of
``eg.eg_prepare`` and returns the lanes' z after ``steps`` steps, exactly
like the plain PyTorch loop ``eg.eg_steps_torch`` it is held against.  It
takes CUDA tensors only and raises on anything the kernel does not take;
there is no fallback to the plain loop.  The kernel is built with nvcc on
first use and launched on the current stream through its declared library
:data:`LIB` (``utils/cuda_build.py``), which the hybrid hop's kernel
(``ops/hop_cuda.py``) shares.
Before the launch the wrapper picks the instance from n alone
(``csrc/eg_lane.cuh::eg_instance`` against the card's shared-memory opt-in
limit): M in registers (n <= 128), or one block a lane with a row over four
threads that hold it in registers and, past 48 columns a thread, in shared
memory (the block instance, up to n = 238 on an H100), counted in
``METRICS.launches["eg_warmstart"]``; M spread over a
cluster of 2-8 blocks (``eg_cluster_ranks``; n = 239-671 on an H100), a row
over four threads that hold part of it in registers and the rest in shared
memory, counted in ``METRICS.launches["eg_warmstart_cluster"]``; or, past
8 blocks, the
global instance, counted in ``METRICS.launches["eg_warmstart_global"]``:
each lane spread over the ranks ``eg_global_ranks`` picks from the shape,
the batch and the card's resident blocks (R blocks on any SMs, each band
of M in its shared memory where it fits, meeting at a barrier in device
memory; R = 1, where the batch fills the card, reads M every half-step from
a column-major copy that the kernel writes at its start); the ranks
of its launches are summed in ``METRICS.counters["eg_warmstart_global_ranks"]``.
Every launch adds its lanes to ``METRICS.counters["eg_lanes"]``, and a
launch of the block instance to ``["eg_block_lanes"]`` too.  A launch the
card refuses raises ``RuntimeError`` with CUDA's message; no other instance
is tried.

:func:`eg_steps_host` runs the same lane code built with g++ on CPU
tensors — the CPU tests' window on the kernel's logic — with the lane
spread over the ranks the card's launcher would give it.
"""

from __future__ import annotations

from ctypes import c_char_p, c_int, c_longlong, c_void_p
from typing import Optional

import torch

from ..utils.cuda_build import (HOPPER_RESIDENT_BLOCKS, HOPPER_SMEM_OPTIN,
                                Build, KernelInputs, KernelLibrary)
from ..utils.metrics import METRICS

KERNEL = "eg_warmstart"
KERNEL_GLOBAL = "eg_warmstart_global"
KERNEL_CLUSTER = "eg_warmstart_cluster"
GLOBAL_RANKS = "eg_warmstart_global_ranks"
LANES = "eg_lanes"
BLOCK_LANES = "eg_block_lanes"
_HEADERS = ["eg_lane.cuh", "lane_barrier.cuh"]
# csrc/eg_lane.cuh::eg_instance
EG_REGISTER, EG_SHARED, EG_GLOBAL, EG_CLUSTER = 0, 1, 2, 3
_PARAMS = [c_void_p] * 7 + [c_int] * 3
# csrc/hybrid_hop.cu's, whose wrapper is ops/hop_cuda.py
_HOP_PARAMS = [c_void_p] * 9 + [c_int] * 3
LIB = KernelLibrary(
    cuda=Build(KERNEL, ["eg_warmstart.cu", "hybrid_hop.cu"],
               [*_HEADERS, "cluster_launch.cuh", "hop_lane.cuh"], {
        "qpn_eg_warmstart_f32": (c_int, [*_PARAMS, c_void_p]),
        "qpn_eg_warmstart_cluster_f32": (c_int, [*_PARAMS, c_int, c_void_p]),
        "qpn_eg_warmstart_global_f32": (c_int,
                                        [*_PARAMS, c_int] + [c_void_p] * 4),
        "qpn_eg_smem_optin": (c_longlong, []),
        "qpn_eg_global_resident": (c_longlong, []),
        "qpn_eg_exchange_floats": (c_longlong, [c_int]),
        "qpn_eg_global_copy_floats": (c_longlong, [c_int, c_int]),
        "qpn_eg_error_string": (c_char_p, [c_int]),
        **{f"qpn_hybrid_hop_{t}": (c_int, [*_HOP_PARAMS, c_int, c_void_p])
           for t in ("f32", "f64")}}),
    host=Build("eg_lane_host", ["eg_lane_host.cpp", "hop_lane_host.cpp"],
               [*_HEADERS, "hop_lane.cuh"], {
        "qpn_eg_warmstart_host_f32": (None, [*_PARAMS, c_longlong, c_int,
                                             c_longlong]),
        "qpn_eg_global_band_fits": (c_int, [c_int, c_int, c_longlong]),
        "qpn_eg_band_bytes": (c_longlong, [c_int, c_int]),
        "qpn_eg_cluster_chunk": (c_int, [c_int]),
        "qpn_eg_cluster_rank_bytes": (c_longlong, [c_int, c_int]),
        "qpn_eg_cluster_reach": (c_int, [c_int, c_longlong]),
        "qpn_eg_block_threads": (c_int, [c_int]),
        "qpn_eg_block_bytes": (c_longlong, [c_int]),
        **{f"qpn_hybrid_hop_host_{t}": (c_int, [*_HOP_PARAMS, c_longlong,
                                                c_int])
           for t in ("f32", "f64")}}),
    shape={
        "qpn_eg_instance": (c_int, [c_int, c_longlong]),
        "qpn_eg_pick_chunk": (c_int, [c_int]),
        "qpn_eg_cluster_ranks": (c_int, [c_int, c_longlong]),
        "qpn_eg_global_ranks": (c_int, [c_int, c_int, c_longlong,
                                        c_longlong]),
        "qpn_hop_instance": (c_int, [c_int, c_int, c_longlong])},
    error="qpn_eg_error_string", optin="qpn_eg_smem_optin")
_F32 = torch.float32
_INPUTS = KernelInputs("eg kernel", M=("B n n", _F32), q=("B n", _F32),
                       l=("B n", _F32), u=("B n", _F32), z0=("B n", _F32),
                       tau=("B", _F32))
build = LIB.build


def card_instance(n: int, device: torch.device, lanes: int = 1
                  ) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for ``lanes`` lanes of
    rows of ``n`` on the CUDA ``device``: ranks 1 for the register kernel
    and the block instance."""
    lib, n, optin = LIB.cuda(), int(n), LIB.optin(device)
    instance = lib.qpn_eg_instance(n, optin)
    if instance == EG_CLUSTER:
        return instance, lib.qpn_eg_cluster_ranks(n, optin)
    if instance == EG_GLOBAL:
        resident = LIB.card("qpn_eg_global_resident", device)
        return instance, lib.qpn_eg_global_ranks(n, int(lanes), resident,
                                                 optin)
    return instance, 1


def _args(M, q, l, u, z0, tau, out, steps):
    B, n, _ = M.shape
    return [*(t.data_ptr() for t in (M, q, l, u, z0, tau, out)), B, n,
            int(steps)]


def eg_warmstart_cuda(M, q, l, u, z0, tau, steps: int) -> torch.Tensor:
    """Run ``steps`` extragradient steps of every lane in the CUDA kernel
    (one launch).  M (B,n,n); q/l/u/z0 (B,n); tau (B,); all f32 on one CUDA
    device (CPU tensors go to ``eg.eg_steps_torch``).  The instance is
    picked from n: the register kernel up to n = 128, beyond that the block
    instance while the lane fits one block's shared memory, then M spread
    over a cluster's blocks, else read from device memory."""
    return _launch(M, q, l, u, z0, tau, steps)


def _launch(M, q, l, u, z0, tau, steps: int, *,
            instance: Optional[int] = None, ranks: int = 1) -> torch.Tensor:
    """One launch on inputs checked here: of the instance and ranks that
    the shape picks, or of ``instance`` (EG_CLUSTER and EG_GLOBAL over
    ``ranks`` blocks a lane; EG_REGISTER and EG_SHARED: the kernel the
    launcher picks from n, the register kernel or the block instance),
    counted under its name, its lanes in ``eg_lanes`` (and in
    ``eg_block_lanes`` for the block instance).  ``chip_smoke.py`` and the
    GPU tests force an instance to run the global instance at cluster
    sizes or at R = 1, and sizes the card refuses."""
    _INPUTS((M, q, l, u, z0, tau), "cuda", steps=steps)
    out = torch.empty_like(z0)
    B, n, _ = M.shape
    if B == 0 or n == 0:
        return out
    device = M.device
    if instance is None:
        instance, ranks = card_instance(n, device, lanes=B)
    args = _args(M, q, l, u, z0, tau, out, steps)
    if instance == EG_GLOBAL:
        lib = LIB.cuda()
        xg = bars = mt = None
        if ranks > 1:
            # each lane's z and z½, and its barrier: an arrival count and a
            # generation
            xg = torch.empty(B * lib.qpn_eg_exchange_floats(n),
                             dtype=torch.float32, device=device)
            bars = torch.zeros(2 * B, dtype=torch.int32, device=device)
        copy = lib.qpn_eg_global_copy_floats(n, int(ranks))
        if copy > 0:
            # each lane's column-major copy of M, which the kernel writes
            # and reads (bands past shared memory)
            mt = torch.empty(B * copy, dtype=torch.float32, device=device)
        LIB.launch(KERNEL_GLOBAL, "qpn_eg_warmstart_global_f32", device,
                   *args, int(ranks), *(None if t is None else t.data_ptr()
                                        for t in (xg, bars, mt)))
        METRICS.bump(GLOBAL_RANKS, int(ranks))
    elif instance == EG_CLUSTER:
        LIB.launch(KERNEL_CLUSTER, "qpn_eg_warmstart_cluster_f32", device,
                   *args, int(ranks))
    elif instance in (EG_REGISTER, EG_SHARED):
        LIB.launch(KERNEL, "qpn_eg_warmstart_f32", device, *args)
        if LIB.cuda().qpn_eg_pick_chunk(n) == 0:
            METRICS.bump(BLOCK_LANES, B)
    else:
        raise ValueError(f"eg kernel: no instance {instance}")
    METRICS.bump(LANES, B)
    return out


def eg_steps_host(M, q, l, u, z0, tau, steps: int,
                  optin: int = HOPPER_SMEM_OPTIN,
                  ranks: Optional[int] = None) -> torch.Tensor:
    """The kernel's lane code built for the host, on CPU tensors: every sum
    in the order of, and the lane carved as by, the kernel that the launcher
    picks for this n under the opt-in limit ``optin`` (an H100's by
    default), spread over the ranks it would give this batch on an H100;
    ``ranks`` spreads it over that many instead (1: one block's lane)."""
    _INPUTS((M, q, l, u, z0, tau), "cpu", steps=steps)
    if ranks is not None and ranks < 1:
        raise ValueError(f"eg_steps_host: ranks={ranks} < 1")
    out = torch.empty_like(z0)
    LIB.host().qpn_eg_warmstart_host_f32(
        *_args(M, q, l, u, z0, tau, out, steps), int(optin),
        0 if ranks is None else int(ranks), HOPPER_RESIDENT_BLOCKS)
    return out


def host_pick_chunk(n: int) -> int:
    """Columns per thread of the register kernel's instance for rows of
    ``n`` columns (0: none, another instance), from the kernel's header."""
    return LIB.host().qpn_eg_pick_chunk(int(n))


def host_instance(n: int, optin: int) -> int:
    """The instance the launcher picks for rows of ``n`` columns under the
    opt-in limit ``optin`` in bytes (EG_REGISTER, EG_SHARED, EG_CLUSTER or
    EG_GLOBAL), from the kernel's header built for the host."""
    return LIB.host().qpn_eg_instance(int(n), int(optin))


def host_global_ranks(n: int, lanes: int, resident: int, optin: int) -> int:
    """The global instance's blocks a lane for ``lanes`` lanes of rows of
    ``n`` on a card that holds ``resident`` of its blocks at once, under the
    opt-in limit ``optin`` (1: one block), from the kernel's header built
    for the host."""
    return LIB.host().qpn_eg_global_ranks(int(n), int(lanes),
                                           int(resident), int(optin))


def host_global_band_fits(n: int, ranks: int, optin: int) -> bool:
    """Whether a global rank's band of M sits in its shared memory at
    ``ranks`` blocks a lane under ``optin`` (else in the lane's column-major
    copy in device memory)."""
    return bool(LIB.host().qpn_eg_global_band_fits(int(n), int(ranks),
                                                    int(optin)))


def host_band_bytes(n: int, ranks: int) -> int:
    """Bytes of one rank's part of a lane of rows of ``n`` spread over
    ``ranks`` blocks, its band of M included, from the kernel's header."""
    return LIB.host().qpn_eg_band_bytes(int(n), int(ranks))


def host_cluster_ranks(n: int, optin: int) -> int:
    """The blocks of the cluster instance's lane for rows of ``n`` under the
    opt-in limit ``optin`` (0: past the instance's domain), from the
    kernel's header built for the host."""
    return LIB.host().qpn_eg_cluster_ranks(int(n), int(optin))


def host_cluster_reach(n: int, optin: int) -> bool:
    """Whether rows of ``n`` lie in the cluster instance's domain under
    ``optin``: some cluster of at most 8 blocks holds M's bands in shared
    memory."""
    return bool(LIB.host().qpn_eg_cluster_reach(int(n), int(optin)))


def host_cluster_chunk(n: int) -> int:
    """Columns of a row that each of its four threads sums in the cluster
    instance (the partition of its order of sums)."""
    return LIB.host().qpn_eg_cluster_chunk(int(n))


def host_block_threads(n: int) -> int:
    """Threads of the block instance's lane of rows of ``n``: a group of
    four on every three rows (two past chunks of 48 columns), whole
    warps."""
    return LIB.host().qpn_eg_block_threads(int(n))


def host_block_bytes(n: int) -> int:
    """Shared memory of the block instance's lane of rows of ``n``: z and
    z½, and the part of M its threads do not hold in registers."""
    return LIB.host().qpn_eg_block_bytes(int(n))


def host_cluster_rank_bytes(n: int, ranks: int) -> int:
    """Shared memory of one rank of the cluster instance at ``ranks`` blocks
    a lane: z and z½, and the part of the band its threads do not hold in
    registers."""
    return LIB.host().qpn_eg_cluster_rank_bytes(int(n), int(ranks))
