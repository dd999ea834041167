"""Numeric configuration of the PyTorch port.

Counterpart of ``qpn_tpu/config.py`` without its TPU-only parts: no x64
switch (PyTorch takes the dtype from each tensor), no XLA compile cache, and
no dispatch-device overrides (the device is the one the input tensors are
on).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NumericConfig:
    # Batch-size buckets for padded ensemble calls (the padded routes of
    # ROADMAP slice 2 use them; the KKT-AVI solve runs at exact shapes).
    batch_buckets: tuple = (1, 8, 64, 512, 2048)
    # Shared-matrix scenario ensembles (structure tag shared_M) at or above
    # this AVI dimension belong to the shared-matrix route (ROADMAP slice 3),
    # whose per-iteration work is GEMMs against one resident matrix instead
    # of one (n, 3n+2) pivot tableau per lane.
    shared_kkt_min_n: int = 192
    # Pivot loop of the batched Lemke engine: "auto" = the hand-written CUDA
    # kernel (ops/lemke_cuda.py) for CUDA tensors and the plain PyTorch loop
    # (ops/lemke.lemke_pivot_torch) for CPU tensors; "cuda" = the kernel
    # always (raises on CPU tensors); "torch" = the plain loop always.
    lemke_kernel: str = "auto"


CONFIG = NumericConfig()
