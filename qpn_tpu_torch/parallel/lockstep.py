"""Lockstep scenario ensembles (PyTorch port of
``qpn_tpu/parallel/lockstep.py``): the whole equilibrium loop of an ensemble
of QPNets, with their batched calls fused.

* each scenario's ``solve()`` runs unmodified in a worker thread — host-side
  control flow (levels, piece enumeration, cycling checks) stays per-scenario
  because it genuinely diverges across scenarios;
* every batched call a scenario makes through ``solve_qp_batch_padded``
  (QPs and LPs), ``solve_avi_batch_padded`` (AVI solves) and
  ``solve_lp_host_batch`` (native geometry LPs) is intercepted and parked at
  a :class:`LockstepBroker`;
* when every live scenario is parked, the broker fuses the accumulated
  requests by shape into ONE batched call per shape and wakes the workers
  with their slices.

On the card this turns N scenarios' small launches into one batch's: the
ADMM loop of a fused call runs as many blocks as its slowest lane, once,
instead of once per scenario.  Each lane's iterates depend on its own data
only, so a scenario receives the numbers of the serial path as far as the
batched kernels sum in the same order whatever the batch size (the CPU
tests hold it to 1e-9; ``PERF.md`` records what the card shows).

The broker's wave barrier is the superstep boundary; scenarios that finish
early stop submitting and the waves shrink.

With a ``mesh`` (``parallel/mesh.py``) every rank runs the same ensemble
(SPMD): each fused AVI and QP dispatch is split over the ranks
(``_sharding``, padded to at least the rank count) and every rank gets the
full result back.  The waves are dispatched in the canonical order of
:class:`_Request` (worker index, sequence number), so every rank issues the
same collectives in the same order.  The host-LP waves run on the host and
are never split.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

class _Request:
    __slots__ = ("kind", "args", "kw", "result", "error", "event", "order")

    def __init__(self, kind, args, kw, order=(0, 0)):
        self.kind = kind
        self.args = args
        self.kw = kw
        self.result = None
        self.error = None
        self.event = threading.Event()
        # (worker index, per-worker sequence number): canonical ordering so
        # wave composition is independent of thread scheduling, which SPMD
        # ranks need: each must issue the same fused dispatches in the same
        # order, or the collectives deadlock
        self.order = order


def _shape_key(a):
    """Shape past the batch axis, with the dtype and device of a tensor
    (tensors of two dtypes or devices must not be concatenated)."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape[1:]), str(a.dtype), str(a.device)
    return np.shape(a)[1:]


def _concat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, 0)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def _batch_size(a) -> int:
    return a.shape[0] if hasattr(a, "shape") else np.shape(a)[0]


class LockstepBroker:
    """Wave-synchronous batching of solver requests from scenario threads;
    with a ``mesh``, each fused AVI and QP dispatch is split over its ranks
    (module docstring)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._lock = threading.Lock()
        self._wave = threading.Condition(self._lock)
        self._pending: List[_Request] = []
        self._live = 0          # workers not yet finished
        self._parked = 0        # workers blocked on a request
        self.waves = 0          # superstep counter (for tests/metrics)
        # host-clock seconds inside the fused engine calls (for the split of
        # an ensemble's wall between them and the scenarios' own host work)
        self.dispatch_s = 0.0

    # ---- worker side -----------------------------------------------------
    def submit(self, kind: str, *args, **kw):
        widx = getattr(_BROKER_TLS, "worker", 0)
        seq = getattr(_BROKER_TLS, "seq", 0)
        _BROKER_TLS.seq = seq + 1
        req = _Request(kind, args, kw, order=(widx, seq))
        with self._lock:
            self._pending.append(req)
            self._parked += 1
            self._wave.notify_all()
        req.event.wait()
        # _parked is decremented by the dispatcher when it CONSUMES the
        # request (not here on wake): a stale +1 from a worker still
        # scheduled-out in event.wait would otherwise let the dispatcher
        # fire premature under-filled waves, eroding the fusion this
        # module exists to provide
        if req.error is not None:
            raise req.error
        return req.result

    def _worker_done(self):
        with self._lock:
            self._live -= 1
            self._wave.notify_all()

    # ---- dispatcher side -------------------------------------------------
    def _dispatch_wave(self, requests: Sequence[_Request]):
        from ..ops import avi, batch_qp
        from ..ops.lemke import solve_lp_host_batch
        from ..utils.metrics import METRICS
        # canonical order (see _Request.order): grouping below uses dict
        # insertion order, so sorting here makes both the group order and
        # the lane order inside each fused batch deterministic
        requests = sorted(requests, key=lambda r: r.order)
        self.waves += 1
        split = {}
        if self.mesh is not None:
            from .mesh import scenario_sharding
            split = dict(_sharding=scenario_sharding(self.mesh),
                         _min_batch=self.mesh.size)
        by_shape = {}
        for r in requests:
            # pure LPs (P == 0) must not fuse with QPs of identical shapes:
            # the exact Lemke LP route gates on the CONCATENATED batch being
            # all-LP, and a single QP batchmate would silently demote every
            # LP lane to approximate ADMM — breaking the serial-parity
            # contract downstream geometry decisions consume
            is_lp = (r.kind == "qp"
                     and not np.asarray(r.args[0]).any())
            key = (r.kind, is_lp,
                   tuple(_shape_key(a) for a in r.args),
                   tuple(sorted(r.kw.items())))
            by_shape.setdefault(key, []).append(r)
        for (kind, _, _, _), group in by_shape.items():
            t0 = time.perf_counter()
            try:
                # stack each positional array arg along the batch axis
                cat = [_concat([r.args[i] for r in group])
                       for i in range(len(group[0].args))]
                kw = group[0].kw
                if kind == "avi":
                    out = avi.solve_avi_batch_padded(*cat, _no_broker=True,
                                                     **split, **kw)
                elif kind == "qp":
                    out = batch_qp.solve_qp_batch_padded(
                        *cat, _no_broker=True, **split, **kw)
                elif kind == "lp_host":
                    # host-engine geometry LPs: one fused exact-shape OpenMP
                    # batch instead of per-scenario native calls contending
                    # for the same cores; never split (host execution)
                    out = solve_lp_host_batch(*cat, _no_broker=True, **kw)
                    METRICS.bump("broker_lp_host_waves")
                    METRICS.bump("broker_lp_host_fused", len(group))
                else:           # pragma: no cover
                    raise ValueError(kind)
            except Exception as e:              # noqa: BLE001
                # a failed fused dispatch must not strand its workers in
                # event.wait forever: hand each its error and wake it
                for r in group:
                    r.error = e
                    r.event.set()
                continue
            finally:
                self.dispatch_s += time.perf_counter() - t0
            # each worker gets its rows of the fused result, where the serial
            # call returns them: the QP and LP wrappers return numpy (one
            # host copy of the fused batch), the AVI solve tensors on the
            # device of its inputs
            ofs = 0
            for r in group:
                b = _batch_size(r.args[0])
                r.result = type(out)(*(v[ofs:ofs + b] for v in out))
                ofs += b
                r.event.set()

    def run(self, jobs: Sequence[Callable[[], object]]):
        """Run the scenario jobs to completion; returns their results in
        order.  Exceptions in a job are re-raised after all jobs settle."""
        results = [None] * len(jobs)
        errors = [None] * len(jobs)
        self._live = len(jobs)

        def wrap(i, job):
            _BROKER_TLS.broker = self
            _BROKER_TLS.worker = i
            _BROKER_TLS.seq = 0
            try:
                results[i] = job()
            except BaseException as e:          # noqa: BLE001
                errors[i] = e
            finally:
                _BROKER_TLS.broker = None
                self._worker_done()

        threads = [threading.Thread(target=wrap, args=(i, j), daemon=True)
                   for i, j in enumerate(jobs)]
        for t in threads:
            t.start()
        while True:
            with self._lock:
                self._wave.wait_for(
                    lambda: self._live == 0
                    or (self._pending and self._parked >= self._live))
                if self._live == 0 and not self._pending:
                    break
                wave, self._pending = self._pending, []
                self._parked -= len(wave)
            if wave:
                self._dispatch_wave(wave)
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results


_BROKER_TLS = threading.local()


def active_broker() -> Optional[LockstepBroker]:
    return getattr(_BROKER_TLS, "broker", None)


def solve_many_lockstep(qpns, x_inits=None, seed: int = 1, mesh=None):
    """Lockstep ensemble counterpart of ``algorithm.solve_many``.

    All scenarios advance together; their batched calls fuse into shared
    dispatches on ``CONFIG.device``.  Returns ``(results, broker)``;
    ``broker.waves`` counts the fused waves.  With ``mesh`` every rank runs
    the same ensemble and each fused dispatch is split over the ranks
    (module docstring); each scenario's result comes back where its serial
    call returns it (numpy from the QP and LP wrappers, device tensors from
    the AVI solve)."""
    from ..algorithm import solve
    qpns = list(qpns)
    if x_inits is None:
        x_inits = [None] * len(qpns)
    broker = LockstepBroker(mesh=mesh)
    jobs = [
        (lambda qpn=qpn, x0=x0: solve(qpn, x0, seed=seed))
        for qpn, x0 in zip(qpns, x_inits)
    ]
    out = broker.run(jobs)
    return out, broker
