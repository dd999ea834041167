"""Process-parallel full-solve ensembles: host-core scaling of ``solve()``
(PyTorch port of ``qpn_tpu/parallel/procpool.py``).

The equilibrium outer loop (levels, piece enumeration, geometry pruning,
cycling checks) is host-side Python by nature.  The lockstep broker
(``lockstep.py``) fuses an ensemble's batched calls but runs the host logic
in threads, which the interpreter lock serializes; ``algorithm.solve_many``
is the plain serial loop.  This module is the third leg: one OS process per
worker, each solving whole scenarios end to end.  No interpreter lock, no
shared state, results bit-identical to a serial loop on the same device (the
same code path per scenario; scenarios are independent).

Each worker takes the parent's ``CONFIG`` (its device included: a parent
on the card gives workers on the card, each with its own CUDA context) and
one PyTorch intra-op thread.  The JAX package's workers always select JAX's
CPU platform; the port's run on the CPU only when the caller asks for it
with ``CONFIG.device = "cpu"``.  Workers start with the ``spawn`` method,
because a CUDA context does not survive ``fork``; so ``fn`` and its
arguments must be picklable, and a script that starts a pool keeps its work
under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

__all__ = ["solve_many_processes", "map_processes"]


def _pool(ctx, n_workers: int, pin: bool):
    from ..config import CONFIG
    return ctx.Pool(processes=n_workers, initializer=_proc_init,
                    initargs=(dataclasses.asdict(CONFIG), ctx.Value("i", 0),
                              pin))


def _proc_init(config: dict, counter=None, pin: bool = False):
    # runs in the child before the solver's modules are imported
    if pin and counter is not None:
        # one core per worker: each worker's BLAS/OpenMP pools would
        # otherwise spread over every core and oversubscribe the machine
        with counter.get_lock():
            idx = counter.value
            counter.value += 1
        ncores = os.cpu_count() or 1
        try:
            os.sched_setaffinity(0, {idx % ncores})
        except (AttributeError, OSError):  # pragma: no cover - non-Linux
            pass
        for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ[var] = "1"
    import torch
    from ..config import CONFIG
    # the parent's configuration and one intra-op thread (module docstring)
    torch.set_num_threads(1)
    for name, value in config.items():
        setattr(CONFIG, name, value)


def _proc_solve(job):
    qpn, x0, seed = job
    from ..algorithm import solve
    return solve(qpn, x0, seed=seed)


def solve_many_processes(qpns: Sequence, x_inits: Optional[Sequence] = None,
                         seed: int = 1,
                         n_workers: Optional[int] = None) -> List:
    """Solve a scenario ensemble with one process per worker.

    Same contract as :func:`qpn_tpu_torch.algorithm.solve_many` (list of
    per-scenario solve() payloads, input order preserved); scenarios are
    distributed over ``n_workers`` (default: the machine's core count,
    capped at the ensemble size) spawned processes, each on this process's
    ``CONFIG.device`` with one intra-op thread and pinned to one core.  A
    single worker or a single scenario runs the serial loop in this process
    instead."""
    import multiprocessing as mp

    qpns = list(qpns)
    if x_inits is None:
        x_inits = [None] * len(qpns)
    x_inits = list(x_inits)
    if len(x_inits) != len(qpns):
        raise ValueError("x_inits length must match qpns")
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, len(qpns))
    n_workers = max(1, min(n_workers, len(qpns)))
    if n_workers == 1 or len(qpns) <= 1:
        from ..algorithm import solve_many
        return solve_many(qpns, x_inits, seed=seed)

    jobs = [(qpn, x0, seed) for qpn, x0 in zip(qpns, x_inits)]
    with _pool(mp.get_context("spawn"), n_workers, True) as pool:
        return pool.map(_proc_solve, jobs, chunksize=1)


def _call_job(job):
    fn, args = job
    return fn(*args)


def map_processes(fn, jobs: Sequence, n_workers: Optional[int] = None,
                  pin: bool = True) -> List:
    """Process-parallel map for host-side solver work.

    ``fn`` must be a module-level (picklable-by-reference) callable; each
    element of ``jobs`` is an argument tuple; results come back in job
    order.  Workers are spawned processes with this process's ``CONFIG``
    and one intra-op thread (module docstring), each pinned to one core
    when ``pin``.

    ``n_workers=1`` runs in this process only
    with ``pin=False``.  With ``pin=True`` (the default) a single worker
    still runs in one spawned, pinned child, so that a 1-against-W ladder
    compares equal cores per worker (pinning this process would leave its
    thread pools on every core).  The JAX package's docstring says that
    ``n_workers=1`` runs in process; its code behaves as described here,
    and so does the port."""
    import multiprocessing as mp

    jobs = [(fn, tuple(a)) for a in jobs]
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, len(jobs))
    n_workers = max(1, min(n_workers, len(jobs)))
    if n_workers == 1 and not pin:
        return [_call_job(j) for j in jobs]
    with _pool(mp.get_context("spawn"), n_workers, pin) as pool:
        return pool.map(_call_job, jobs, chunksize=1)
