"""First-class observability counters (copy of ``qpn_tpu/utils/metrics.py``).

Every phase of the solver bumps named counters (straggler lanes, uncertified
lanes, ...) so benchmarks and regressions are measurable.  ``METRICS`` is a
process-global registry.

The port adds one count per hand-written device kernel: its wrapper calls
:meth:`Metrics.launched` right where it launches the kernel and nowhere else,
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class Metrics:
    """Counter updates are lock-guarded: scenario threads may bump the
    shared registry concurrently, and an unguarded ``+=`` on the
    defaultdict drops updates."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, float] = defaultdict(float)
        self.launches: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def bump(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += amount

    def launched(self, kernel: str) -> None:
        """Count one launch of a hand-written device kernel."""
        with self._lock:
            self.launches[kernel] += 1

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timers[name] += dt

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timers.clear()
            self.launches.clear()

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.counters)
        out.update({f"time/{k}": v for k, v in self.timers.items()})
        out.update({f"launches/{k}": v for k, v in self.launches.items()})
        return out

    def __repr__(self):
        items = ", ".join(f"{k}={v:g}" for k, v in sorted(self.snapshot().items()))
        return f"Metrics({items})"


METRICS = Metrics()
