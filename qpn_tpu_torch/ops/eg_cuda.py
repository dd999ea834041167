"""Wrapper of the hand-written Hopper kernel for the fused extragradient
steps (``csrc/eg_warmstart.cu``; it replaces the JAX package's Pallas kernel
``qpn_tpu/ops/pallas_kernels.py::_eg_kernel``).

:func:`eg_warmstart_cuda` takes the prepared f32 tensors of
``eg.eg_prepare`` and returns the lanes' z after ``steps`` steps, exactly
like the plain PyTorch loop ``eg.eg_steps_torch`` it is held against.  It
takes CUDA tensors only and raises on anything the kernel does not take;
there is no fallback to the plain loop.  The kernel is built with nvcc on
first use (``utils/cuda_build.py``) and launched on the current stream.
Before the launch the wrapper picks the instance from n alone
(``csrc/eg_lane.cuh::eg_instance`` against the card's shared-memory opt-in
limit): M in registers (n <= 128) or in shared memory (up to n = 238 on an
H100), counted in ``METRICS.launches["eg_warmstart"]``; M spread over a
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
A launch the card refuses raises ``RuntimeError`` with CUDA's message; no
other instance is tried.

:func:`eg_steps_host` runs the same lane code built with g++ on CPU
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

KERNEL = "eg_warmstart"
KERNEL_GLOBAL = "eg_warmstart_global"
KERNEL_CLUSTER = "eg_warmstart_cluster"
GLOBAL_RANKS = "eg_warmstart_global_ranks"
_HEADERS = ["eg_lane.cuh", "lane_barrier.cuh"]
# csrc/eg_lane.cuh::eg_instance
EG_REGISTER, EG_SHARED, EG_GLOBAL, EG_CLUSTER = 0, 1, 2, 3
_COUNTED = {EG_REGISTER: KERNEL, EG_SHARED: KERNEL, EG_GLOBAL: KERNEL_GLOBAL,
            EG_CLUSTER: KERNEL_CLUSTER}
_PARAMS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
_CUDA_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.CDLL] = None


def _cuda_lib() -> ctypes.CDLL:
    global _CUDA_LIB
    if _CUDA_LIB is None:
        lib = load_cuda_library(KERNEL, ["eg_warmstart.cu"],
                                [*_HEADERS, "cluster_launch.cuh"])
        lib.qpn_eg_warmstart_f32.restype = ctypes.c_int
        lib.qpn_eg_warmstart_f32.argtypes = _PARAMS + [ctypes.c_void_p]
        lib.qpn_eg_warmstart_cluster_f32.restype = ctypes.c_int
        lib.qpn_eg_warmstart_cluster_f32.argtypes = _PARAMS + [
            ctypes.c_int, ctypes.c_void_p]
        lib.qpn_eg_warmstart_global_f32.restype = ctypes.c_int
        lib.qpn_eg_warmstart_global_f32.argtypes = _PARAMS + [
            ctypes.c_int] + [ctypes.c_void_p] * 4
        _instance_function(lib)
        for fn in (lib.qpn_eg_smem_optin, lib.qpn_eg_global_resident):
            fn.restype = ctypes.c_longlong
            fn.argtypes = []
        lib.qpn_eg_exchange_floats.restype = ctypes.c_longlong
        lib.qpn_eg_exchange_floats.argtypes = [ctypes.c_int]
        lib.qpn_eg_global_copy_floats.restype = ctypes.c_longlong
        lib.qpn_eg_global_copy_floats.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qpn_eg_error_string.restype = ctypes.c_char_p
        lib.qpn_eg_error_string.argtypes = [ctypes.c_int]
        _CUDA_LIB = lib
    return _CUDA_LIB


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = load_host_library("eg_lane_host", ["eg_lane_host.cpp"],
                                _HEADERS)
        lib.qpn_eg_warmstart_host_f32.restype = None
        lib.qpn_eg_warmstart_host_f32.argtypes = _PARAMS + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
        lib.qpn_eg_pick_chunk.restype = ctypes.c_int
        lib.qpn_eg_pick_chunk.argtypes = [ctypes.c_int]
        lib.qpn_eg_global_band_fits.restype = ctypes.c_int
        lib.qpn_eg_global_band_fits.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_longlong]
        lib.qpn_eg_band_bytes.restype = ctypes.c_longlong
        lib.qpn_eg_band_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qpn_eg_cluster_chunk.restype = ctypes.c_int
        lib.qpn_eg_cluster_chunk.argtypes = [ctypes.c_int]
        lib.qpn_eg_cluster_rank_bytes.restype = ctypes.c_longlong
        lib.qpn_eg_cluster_rank_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qpn_eg_cluster_reach.restype = ctypes.c_int
        lib.qpn_eg_cluster_reach.argtypes = [ctypes.c_int, ctypes.c_longlong]
        _instance_function(lib)
        _HOST_LIB = lib
    return _HOST_LIB


def _instance_function(lib: ctypes.CDLL) -> None:
    for fn in (lib.qpn_eg_instance, lib.qpn_eg_cluster_ranks):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.qpn_eg_global_ranks.restype = ctypes.c_int
    lib.qpn_eg_global_ranks.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_longlong]


def _ranks(lib: ctypes.CDLL, n: int, optin: int, lanes: int,
           resident) -> tuple[int, int]:
    """(instance, ranks) that ``lib``'s pure choice gives ``lanes`` lanes
    of rows of ``n`` under ``optin`` on a card that holds ``resident()``
    blocks of the global instance (asked only for it): ranks 1 for the
    register and shared instances."""
    instance = lib.qpn_eg_instance(n, optin)
    if instance == EG_CLUSTER:
        return instance, lib.qpn_eg_cluster_ranks(n, optin)
    if instance == EG_GLOBAL:
        return instance, lib.qpn_eg_global_ranks(n, lanes, resident(), optin)
    return instance, 1


def card_optin(device: torch.device) -> int:
    """The shared memory a block can opt into on the CUDA ``device``, as
    the kernel library reads it (the limit the instance is picked by)."""
    lib = _cuda_lib()
    return smem_optin(lib.qpn_eg_smem_optin, device)


def card_resident(device: torch.device) -> int:
    """Blocks of the global instance that the CUDA ``device`` holds at
    once, each with the opt-in limit of shared memory (one an SM)."""
    lib = _cuda_lib()
    return card_query("eg_global_resident", lib.qpn_eg_global_resident,
                      device)


def card_instance(n: int, device: torch.device, lanes: int = 1
                  ) -> tuple[int, int]:
    """(instance, ranks) that the launcher picks for ``lanes`` lanes of
    rows of ``n`` on the CUDA ``device``."""
    return _ranks(_cuda_lib(), int(n), card_optin(device), int(lanes),
                  lambda: card_resident(device))


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
    device.  The instance is picked from n: the register kernel up to
    n = 128, beyond that the generic kernel with M in shared memory while it
    fits, then spread over a cluster's shared memory, else with M read from
    device memory."""
    if M.device.type != "cuda":
        raise ValueError("eg_warmstart_cuda takes CUDA tensors; CPU tensors "
                         "go to eg.eg_steps_torch")
    _check(M, q, l, u, z0, tau, steps)
    B, n, _ = M.shape
    instance, ranks = card_instance(n, M.device, lanes=B)
    return _run(M, q, l, u, z0, tau, steps, instance, ranks)


def _launch(M, q, l, u, z0, tau, steps: int, *, instance: int,
            ranks: int = 1) -> torch.Tensor:
    """One launch of the given instance (EG_CLUSTER and EG_GLOBAL over
    ``ranks`` blocks a lane; EG_REGISTER and EG_SHARED: the kernel the
    launcher picks from n), counted under its name.
    :func:`eg_warmstart_cuda` picks the instance and its ranks from the
    shape; ``chip_smoke.py`` and the GPU tests call this to run the global
    instance at cluster sizes or at R = 1, and sizes the card refuses."""
    if M.device.type != "cuda":
        raise ValueError("the eg kernel takes CUDA tensors")
    _check(M, q, l, u, z0, tau, steps)
    return _run(M, q, l, u, z0, tau, steps, instance, ranks)


def _run(M, q, l, u, z0, tau, steps: int, instance: int,
         ranks: int) -> torch.Tensor:
    """The launch of both entry points, on inputs they have checked."""
    out = torch.empty_like(z0)
    B, n, _ = M.shape
    if B == 0 or n == 0:
        return out
    lib = _cuda_lib()
    args = _args(M, q, l, u, z0, tau, out, steps)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        if instance == EG_GLOBAL:
            xg = bars = mt = None
            if ranks > 1:
                # each lane's z and z½, and its barrier: an arrival count
                # and a generation
                xg = torch.empty(B * lib.qpn_eg_exchange_floats(n),
                                 dtype=torch.float32, device=M.device)
                bars = torch.zeros(2 * B, dtype=torch.int32, device=M.device)
            copy = lib.qpn_eg_global_copy_floats(n, int(ranks))
            if copy > 0:
                # each lane's column-major copy of M, which the kernel
                # writes and reads (bands past shared memory)
                mt = torch.empty(B * copy, dtype=torch.float32,
                                 device=M.device)
            rc = lib.qpn_eg_warmstart_global_f32(
                *args, int(ranks), *(None if t is None else t.data_ptr()
                                     for t in (xg, bars, mt)), stream)
        elif instance == EG_CLUSTER:
            rc = lib.qpn_eg_warmstart_cluster_f32(*args, int(ranks), stream)
        elif instance in (EG_REGISTER, EG_SHARED):
            rc = lib.qpn_eg_warmstart_f32(*args, stream)
        else:
            raise ValueError(f"eg kernel: no instance {instance}")
    if rc != 0:
        raise RuntimeError("eg kernel launch failed: "
                           + lib.qpn_eg_error_string(rc).decode())
    METRICS.launched(_COUNTED[instance])
    if instance == EG_GLOBAL:
        METRICS.bump(GLOBAL_RANKS, int(ranks))
    return out


def eg_steps_host(M, q, l, u, z0, tau, steps: int,
                  optin: int = HOPPER_SMEM_OPTIN,
                  ranks: Optional[int] = None) -> torch.Tensor:
    """The kernel's lane code built for the host, on CPU tensors: every sum
    in the order of, and the lane carved as by, the kernel that the launcher
    picks for this n under the opt-in limit ``optin`` (an H100's by
    default), spread over the ranks it would give this batch on an H100;
    ``ranks`` spreads it over that many instead (1: one block's lane)."""
    if M.device.type != "cpu":
        raise ValueError("eg_steps_host takes CPU tensors")
    _check(M, q, l, u, z0, tau, steps)
    if ranks is not None and ranks < 1:
        raise ValueError(f"eg_steps_host: ranks={ranks} < 1")
    out = torch.empty_like(z0)
    _host_lib().qpn_eg_warmstart_host_f32(
        *_args(M, q, l, u, z0, tau, out, steps), int(optin),
        0 if ranks is None else int(ranks), HOPPER_RESIDENT_BLOCKS)
    return out


def host_pick_chunk(n: int) -> int:
    """Columns per thread of the register kernel's instance for rows of
    ``n`` columns (0: none, the generic kernel), from the kernel's header."""
    return _host_lib().qpn_eg_pick_chunk(int(n))


def host_instance(n: int, optin: int) -> int:
    """The instance the launcher picks for rows of ``n`` columns under the
    opt-in limit ``optin`` in bytes (EG_REGISTER, EG_SHARED, EG_CLUSTER or
    EG_GLOBAL), from the kernel's header built for the host."""
    return _host_lib().qpn_eg_instance(int(n), int(optin))


def host_global_ranks(n: int, lanes: int, resident: int, optin: int) -> int:
    """The global instance's blocks a lane for ``lanes`` lanes of rows of
    ``n`` on a card that holds ``resident`` of its blocks at once, under the
    opt-in limit ``optin`` (1: one block), from the kernel's header built
    for the host."""
    return _host_lib().qpn_eg_global_ranks(int(n), int(lanes),
                                           int(resident), int(optin))


def host_global_band_fits(n: int, ranks: int, optin: int) -> bool:
    """Whether a global rank's band of M sits in its shared memory at
    ``ranks`` blocks a lane under ``optin`` (else in the lane's column-major
    copy in device memory)."""
    return bool(_host_lib().qpn_eg_global_band_fits(int(n), int(ranks),
                                                    int(optin)))


def host_band_bytes(n: int, ranks: int) -> int:
    """Bytes of one rank's part of a lane of rows of ``n`` spread over
    ``ranks`` blocks, its band of M included, from the kernel's header."""
    return _host_lib().qpn_eg_band_bytes(int(n), int(ranks))


def host_cluster_ranks(n: int, optin: int) -> int:
    """The blocks of the cluster instance's lane for rows of ``n`` under the
    opt-in limit ``optin`` (0: past the instance's domain), from the
    kernel's header built for the host."""
    return _host_lib().qpn_eg_cluster_ranks(int(n), int(optin))


def host_cluster_reach(n: int, optin: int) -> bool:
    """Whether rows of ``n`` lie in the cluster instance's domain under
    ``optin``: some cluster of at most 8 blocks holds M's bands in shared
    memory."""
    return bool(_host_lib().qpn_eg_cluster_reach(int(n), int(optin)))


def host_cluster_chunk(n: int) -> int:
    """Columns of a row that each of its four threads sums in the cluster
    instance (the partition of its order of sums)."""
    return _host_lib().qpn_eg_cluster_chunk(int(n))


def host_cluster_rank_bytes(n: int, ranks: int) -> int:
    """Shared memory of one rank of the cluster instance at ``ranks`` blocks
    a lane: z and z½, and the part of the band its threads do not hold in
    registers."""
    return _host_lib().qpn_eg_cluster_rank_bytes(int(n), int(ranks))
