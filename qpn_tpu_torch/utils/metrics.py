"""First-class observability counters (copy of ``qpn_tpu/utils/metrics.py``).

Every phase of the solver bumps named counters (straggler lanes, uncertified
lanes, ...) so benchmarks and regressions are measurable.  ``METRICS`` is a
process-global registry.

The port adds, on the same registry:

- one count per hand-written device kernel: its wrapper calls
  :meth:`Metrics.launched` right where it launches the kernel and nowhere
  else, so a run can show that its main path went through the kernel;
- spans, :meth:`Metrics.timer`: each adds its host seconds to the counter
  ``time/<name>``, and while a ``torch.profiler`` records it also opens a
  ``record_function`` range of that name, so the span lies in the same
  trace as the card's kernels, on the profiler's clock;
- host syncs, :meth:`Metrics.sync`: every blocking device-to-host read of the
  ensemble routes goes through it, counted in ``host_syncs`` and timed in
  ``time/qpn.sync``;
- counts on the device: :meth:`Metrics.bump` takes a tensor too and adds it
  where it lies, with no host read, into an f64 tensor of its shape (one
  elementwise launch); the sums are read into ``counters`` when ``counters``
  or :meth:`Metrics.snapshot` is read.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

SYNCS = "host_syncs"
SYNC_TIME = "time/qpn.sync"


class _Span:
    """One span of :meth:`Metrics.timer`.  After the block, ``seconds``
    holds the host seconds it added to its counter, for a caller that
    reports the same block elsewhere from the same clock reading."""

    __slots__ = ("_metrics", "_name", "_range", "_t0", "seconds")

    def __init__(self, metrics: "Metrics", name: str):
        self._metrics = metrics
        self._name = name
        self._range = None
        self.seconds = 0.0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._metrics.bump("time/" + self._name, dt)
        return False


class Metrics:
    """Counter updates are lock-guarded: scenario threads may bump the
    shared registry concurrently, and an unguarded ``+=`` on the
    defaultdict drops updates."""

    def __init__(self):
        self._counters: Dict[str, float] = defaultdict(float)
        self.launches: Dict[str, int] = defaultdict(int)
        # (name, device, shape) -> the f64 sum of the tensors bumped there
        self._pending: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def counters(self) -> Dict[str, float]:
        """The counters, the device-side sums read in first."""
        if self._pending:
            with self._lock:
                pending, self._pending = self._pending, {}
                for key, acc in pending.items():
                    self._counters[key[0]] += float(acc.sum())
        return self._counters

    def bump(self, name: str, amount=1.0) -> None:
        """Add ``amount`` to the counter ``name``.  A tensor ``amount`` is
        added, all its elements, on its own device with no host read."""
        if isinstance(amount, torch.Tensor):
            amount = amount.detach()
            key = (name, amount.device, amount.shape)
            with self._lock:
                acc = self._pending.get(key)
                self._pending[key] = (amount.to(torch.float64, copy=True)
                                      if acc is None else acc + amount)
            return
        with self._lock:
            self._counters[name] += amount

    def launched(self, kernel: str) -> None:
        """Count one launch of a hand-written device kernel."""
        with self._lock:
            self.launches[kernel] += 1

    def timer(self, name: str) -> _Span:
        """A span: ``with METRICS.timer(name): ...`` adds the block's host
        seconds to ``time/<name>``, and marks it in a running profiler's
        trace under ``name``."""
        return _Span(self, name)

    def sync(self, read, *args):
        """``read(*args)``, a blocking device-to-host read (``bool``,
        ``int``, ``torch.nonzero``, ...): counted in ``host_syncs``, its
        seconds in ``time/qpn.sync``."""
        t0 = time.perf_counter()
        out = read(*args)
        dt = time.perf_counter() - t0
        with self._lock:
            self._counters[SYNCS] += 1
            self._counters[SYNC_TIME] += dt
        return out

    def reset(self, launches: bool = True) -> None:
        """Clear the counters (span times included), and the launch counts
        unless ``launches`` is False."""
        with self._lock:
            self._counters.clear()
            self._pending = {}
            if launches:
                self.launches.clear()

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.counters)
        out.update({f"launches/{k}": v for k, v in self.launches.items()})
        return out

    def __repr__(self):
        items = ", ".join(f"{k}={v:g}" for k, v in sorted(self.snapshot().items()))
        return f"Metrics({items})"


METRICS = Metrics()


def lanes_where(mask: torch.Tensor) -> torch.Tensor:
    """The indices of a 1-D mask's True entries, read through
    :meth:`Metrics.sync` (``torch.nonzero`` waits on the card)."""
    return METRICS.sync(torch.nonzero, mask)[:, 0]
