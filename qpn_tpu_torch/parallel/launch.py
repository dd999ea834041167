"""Spawning the ranks of a process group on one machine: the one place
where the port starts ``torch.distributed`` processes for its dry run
(``entry.dryrun_multichip``), its tests and ``chip_smoke.py``.

:func:`spawn` starts ``n`` processes with the ``spawn`` method (a CUDA
context does not survive ``fork``), joins them through a ``file://``
rendezvous in a temporary directory (no TCP port to race for), runs
``fn(mesh, *args)`` on every rank and returns each rank's result, read back
from a file the rank wrote.  Each rank takes the parent's ``CONFIG`` and one
PyTorch intra-op thread (as ``procpool``'s workers do) and the backend rule
of ``multihost.backend_for``.

Nothing hangs: every process group has ``multihost.TIMEOUT_S``, a rank that
raises writes its traceback and exits non-zero, and the parent kills every
rank and raises as soon as one fails or the join timeout passes.  ``fn`` and
``args`` are pickled by reference, so ``fn`` lives at the top level of a
module that imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Sequence


def _rank_main(fn, rank: int, world: int, init_method: str, args,
               config: dict, out_dir: str) -> None:
    try:
        import torch
        import torch.distributed as dist
        from ..config import CONFIG
        from . import multihost
        torch.set_num_threads(1)
        for name, value in config.items():
            setattr(CONFIG, name, value)
        multihost.init(init_method, world, rank)
        out = fn(multihost.global_mesh(), *args)
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001
        # the parent reads this and kills the other ranks, which may be
        # waiting in a collective for this one
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def spawn(fn: Callable, n: int, args: Sequence = (),
          timeout_s: float = 900.0) -> List:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks of one process group
    and return the ranks' results in rank order.  Raises RuntimeError with
    the failing rank's traceback when a rank fails, TimeoutError when the
    ranks have not all finished within ``timeout_s``; either way every rank
    is killed first."""
    import multiprocessing as mp
    from ..config import CONFIG
    from .multihost import backend_for
    backend_for(n)          # raises here, not in n ranks, without a card
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qpn_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    config = dataclasses.asdict(CONFIG)
    procs = [ctx.Process(target=_rank_main, name=f"qpn-rank-{r}",
                         args=(fn, r, n, init_method, tuple(args), config,
                               tmp))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                err = os.path.join(tmp, f"rank{r}.err")
                text = (open(err).read() if os.path.exists(err)
                        else f"exit code {codes[r]}")
                raise RuntimeError(f"rank {r} of {n} failed:\n{text}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{n} ranks did not finish within {timeout_s} s "
                    f"(exit codes {codes})")
            time.sleep(0.05)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
