"""Profiler integration: ``torch.profiler`` traces for the solver phases
(the port's counterpart of ``qpn_tpu/utils/profiling.py``).

``trace`` records host and CUDA activity over a block and writes one Chrome
trace (``chrome://tracing`` or Perfetto) on exit; ``annotate`` adds a named
range that shows beside the kernels in that trace.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block::

        from qpn_tpu_torch.utils.profiling import trace
        with trace("traces") as prof:
            qt.solve(qpn)
        print(prof.key_averages().table(sort_by="cuda_time_total"))

    Yields the ``torch.profiler.profile`` object; its Chrome trace is written
    to ``<log_dir>/trace.json`` when the block ends.  CUDA activity is
    recorded when a CUDA device is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside an active trace."""
    from torch.profiler import record_function
    with record_function(name):
        yield
