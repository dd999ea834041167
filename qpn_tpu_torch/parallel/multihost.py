"""Process-group start-up: the communication backend of the multi-device
layer (PyTorch port of ``qpn_tpu/parallel/multihost.py``).

Each process calls :func:`init` once, before any collective; the
(scenario × branch) mesh of ``parallel.mesh`` then spans every rank of every
host, and the sharded functions of ``parallel.sharded`` and
``parallel.ring`` work unchanged.  The JAX package's processes drive several
devices each; here each rank drives one device.

The backend follows from the rank count and the cards: NCCL when
``CONFIG.device`` is a card and every rank of a host has a card of its own,
gloo otherwise (on the CPU, and with more ranks than cards, as two ranks on
one card).  It is no fallback: the rank's device is never changed, and under
gloo the collectives stage through host copies (``mesh._wire``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

#: every process group gets this timeout, so that a collective whose peer
#: died raises instead of waiting forever
TIMEOUT_S = 120.0


def backend_for(local_ranks: int) -> str:
    """"nccl" when ``CONFIG.device`` is a card and each of the host's
    ``local_ranks`` ranks has a card of its own, else "gloo".  Raises as
    ``config.numeric_device()`` does when the device names a card and none
    is present."""
    from ..config import numeric_device
    dev = numeric_device()
    if dev.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> str:
    """Start this process's rank of the default process group, from
    explicit arguments or from the standard ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where several hosts take part, as
    ``torchrun`` sets them).

    ``coordinator_address`` is ``host:port`` (TCP) or an ``init_method``
    URL (``tcp://...``, ``file://...``).  Under NCCL the rank's device is
    ``cuda:{local_rank}`` (``torch.cuda.set_device``); under gloo it is
    ``CONFIG.device``.  Returns the backend."""
    import torch.distributed as dist
    if coordinator_address is None:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("init: a coordinator address needs "
                             "num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    backend = backend_for(local_world)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


def global_mesh(scenario_axis: Optional[int] = None):
    """(scenario × branch) mesh over every rank of every host."""
    from .mesh import make_mesh
    return make_mesh(scenario_axis=scenario_axis)


def process_info() -> dict:
    """The JAX package's four keys; each rank drives one device."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return dict(process_index=dist.get_rank() if up else 0,
                process_count=world, local_devices=1, global_devices=world)
