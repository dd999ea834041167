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
    # Row-count bucket sizes of the padded routes; the port pads nothing to
    # them, but the Lemke pivot budget of ``lemke.solve_lemke_batch_padded``
    # is sized from the bucket of n, as the JAX package sizes it.
    row_buckets: tuple = (16, 64, 256, 1024)
    # Batch-size buckets for padded ensemble calls (the KKT-AVI solve and the
    # generic adaptive solve run at exact shapes).
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
    # Fused extragradient steps of the warm start (ops/eg.py), with the same
    # meaning: "auto" = the CUDA kernel (ops/eg_cuda.py) for CUDA tensors and
    # the plain PyTorch loop (ops/eg.eg_steps_torch) for CPU tensors.
    eg_kernel: str = "auto"


CONFIG = NumericConfig()


def bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (last bucket grows by doubling if exceeded)."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b
