"""The (scenario × branch) mesh over the ranks of a ``torch.distributed``
process group (PyTorch port of ``qpn_tpu/parallel/mesh.py``).

The JAX package runs one controller over many devices; ``torch.distributed``
runs one process per device.  The port keeps the JAX package's contract in
its SPMD form, the form its multi-process tests already use:

* every rank calls the same function with the same host (numpy) inputs;
* each rank computes its contiguous block of the scenario axis;
* every rank gets the full result back.

Lane maths is row-local, so the block split moves no lane's decision.  The
mesh's two axes are the JAX package's: ``scenario`` (data-parallel
scenario batches) and ``branch`` (solution-graph pieces), laid over the
ranks row-major, so a batch sharded over both axes gives rank r the r-th
contiguous block.

Collectives run on the group's backend: NCCL when each rank has a card of
its own, gloo otherwise (``multihost.backend_for``).  Gloo moves only CPU
tensors, so under gloo every collective stages through a host copy; the
ranks' compute stays on their device.  :func:`gather` and :func:`rotate`
count the bytes they move in ``METRICS.counters["dist_bytes"]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

AXES = ("scenario", "branch")


def mesh_axes(n_devices: int, scenario_axis: Optional[int] = None):
    """(scenario, branch) sizes of an ``n_devices`` mesh, with the JAX
    package's arithmetic: the scenario axis is favoured and the branch axis
    stays 1 or 2 unless ``scenario_axis`` says otherwise."""
    if scenario_axis is None:
        scenario_axis = n_devices if n_devices % 2 else n_devices // 2
    branch_axis = n_devices // scenario_axis
    if scenario_axis * branch_axis != n_devices:
        raise ValueError(f"scenario axis {scenario_axis} does not divide "
                         f"{n_devices} devices")
    return scenario_axis, branch_axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group as a named mesh.

    ``shape`` maps axis names to sizes (``{"scenario": s, "branch": b}``
    from :func:`make_mesh`); ranks lie on it row-major.  ``size`` is the
    rank count (the JAX package's ``mesh.devices.size``), ``device`` the
    rank's compute device and ``backend`` the group's ("nccl" or "gloo").
    ``group`` is the ``torch.distributed`` group, None for the default."""

    shape: dict
    rank: int
    device: torch.device
    backend: str
    group: object = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: Optional[int] = None) -> dict:
        """Row-major coordinates of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}


def make_mesh(n_devices: Optional[int] = None,
              scenario_axis: Optional[int] = None) -> Mesh:
    """The (scenario, branch) mesh over the ranks of the default process
    group.  ``n_devices`` (default: the world size) must equal the world
    size: this raises when no process group of that size is up, and starts
    none (``multihost.init`` and ``launch.spawn`` do)."""
    import torch.distributed as dist
    from ..config import numeric_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is up; start one "
            "with qpn_tpu_torch.parallel.multihost.init or "
            "qpn_tpu_torch.parallel.launch.spawn")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise RuntimeError(f"make_mesh: {n_devices} devices asked for, the "
                           f"process group has {world} ranks")
    s, b = mesh_axes(n_devices, scenario_axis)
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = numeric_device()
    return Mesh(shape={"scenario": s, "branch": b}, rank=dist.get_rank(),
                device=device, backend=backend)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Axis 0 of an array split into contiguous blocks over the mesh axes
    in ``axes`` (row-major) and replicated over the others: the port's
    ``NamedSharding(mesh, P(axes))``."""

    mesh: Mesh
    axes: tuple

    @property
    def blocks(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def block_index(self, rank: Optional[int] = None) -> int:
        c = self.mesh.coords(rank)
        idx = 0
        for a in self.axes:
            idx = idx * self.mesh.shape[a] + c[a]
        return idx


def scenario_sharding(mesh: Mesh) -> Sharding:
    """Batch axis split over every mesh axis (pure data parallel)."""
    return Sharding(mesh, AXES)


def branch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("branch",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _as_sharding(s) -> Sharding:
    """A Sharding as it is; a Mesh as its scenario sharding."""
    if isinstance(s, Sharding):
        return s
    if isinstance(s, Mesh):
        return scenario_sharding(s)
    raise TypeError(f"expected a parallel.mesh Sharding or Mesh, got "
                    f"{type(s).__name__}")


def block_rows(sharding, total: int) -> slice:
    """This rank's contiguous rows of an axis of ``total`` rows: blocks of
    ceil(total / blocks) rows, the last ones short (or empty)."""
    sh = _as_sharding(sharding)
    bs = -(-total // sh.blocks)
    start = min(sh.block_index() * bs, total)
    return slice(start, min(start + bs, total))


# --------------------------------------------------------------------------
#  collectives, staged through the host under gloo
# --------------------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can move it: on the host under gloo, on the
    rank's card under NCCL.  Bools travel as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return t.to(dev).contiguous()


def _like(src, wire: torch.Tensor):
    """``wire`` back in the kind, dtype and device of ``src``."""
    if isinstance(src, np.ndarray):
        return wire.cpu().numpy().astype(src.dtype, copy=False)
    return wire.to(device=src.device, dtype=src.dtype)


def _count(nbytes: int) -> None:
    from ..utils.metrics import METRICS
    METRICS.bump("dist_bytes", nbytes)


def gather(sharding, block, total: Optional[int] = None):
    """The full array from each rank's block of axis 0 (numpy or tensor, as
    given; a tensor comes back on its own device).  ``total`` rows in all
    (default: blocks × this block's rows); short blocks (:func:`block_rows`)
    are padded for the collective and the padding dropped.  On a one-rank
    mesh, and for a replicated sharding, the block is returned as it is."""
    sh = _as_sharding(sharding)
    mesh = sh.mesh
    if mesh.size == 1 or sh.blocks == 1:
        return block
    import torch.distributed as dist
    rows = block.shape[0]
    bs = rows if total is None else -(-total // sh.blocks)
    t = torch.as_tensor(block)
    if rows < bs:
        t = torch.cat([t, t.new_zeros((bs - rows,) + tuple(t.shape[1:]))])
    w = _wire(mesh, t)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    _count(w.numel() * w.element_size() * (mesh.size - 1))
    first = {}
    for r, p in enumerate(parts):        # one copy of each block
        first.setdefault(sh.block_index(r), p)
    full = torch.cat([first[i] for i in range(sh.blocks)])
    if total is not None:
        full = full[:total]
    return _like(block, full)


def rotate(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """One step around the ring of ranks (the JAX package's ``ppermute``
    with ``i → i+1``; a row-major 2-D mesh is one ring over the ranks in
    order): send ``t`` to rank+1, return what rank−1 sent.  One rank: the
    identity, with no send to itself."""
    if mesh.size == 1:
        return t
    import torch.distributed as dist
    w = _wire(mesh, t)
    out = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (mesh.rank + 1) % mesh.size,
                      group=mesh.group),
           dist.P2POp(dist.irecv, out, (mesh.rank - 1) % mesh.size,
                      group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count(w.numel() * w.element_size())
    return _like(t, out)


def all_reduce(mesh: Mesh, values: Sequence[float], op: str) -> list:
    """Element-wise ``op`` ("max" or "sum") of small host numbers over the
    ranks, in f64."""
    if mesh.size == 1:
        return list(values)
    import torch.distributed as dist
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op], group=mesh.group)
    return t.tolist()


# --------------------------------------------------------------------------
#  a batched call split over the ranks
# --------------------------------------------------------------------------

def call_sharded(sharding, fn: Callable, args: Sequence,
                 inert: Callable[[int], Sequence], min_batch: int = 1):
    """``fn(*args)`` with axis 0 split over ``sharding``: the batch padded
    to a multiple of the block count (at least ``min_batch`` lanes) with
    ``inert(k)``'s k lanes (one array for each of ``args``, each lane's
    result known and unused), this rank's block solved, every field of the
    result (a named tuple of per-lane arrays or tensors) gathered and the
    padding sliced off.  Every rank gets the full result."""
    sh = _as_sharding(sharding)
    B = args[0].shape[0]
    Bp = -(-max(B, min_batch) // sh.blocks) * sh.blocks
    if Bp > B:
        pads = inert(Bp - B)
        args = [torch.cat([a, p]) if isinstance(a, torch.Tensor)
                else np.concatenate([np.asarray(a), p])
                for a, p in zip(args, pads)]
    rows = block_rows(sh, Bp)
    out = fn(*(a[rows] for a in args))
    return type(out)(*(gather(sh, v)[:B] for v in out))
