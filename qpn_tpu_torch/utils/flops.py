"""FLOP and byte accounting for the solver kernels (roofline reporting),
the port's copy of ``qpn_tpu/utils/flops.py``.

Counts are analytic per-iteration formulas (multiply+add = 2 flops), using
the iteration counts the solvers report.  They count the *useful* algorithm
flops (no padding lanes or rows), so a share of peak reads as useful work
extracted from the card.

Peaks are the published rates of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet, dense, no sparsity).  A card set to a lower power
limit runs below them: report a share with the card's limit beside it.
"""

from __future__ import annotations

import numpy as np

# float32 outside the tensor cores (the rate the hand-written f32 kernels
# and the f32 GEMVs can use)
H100_PEAK_F32 = 67e12
# float64 outside the tensor cores (the f64 tensor-core rate, 67 TFLOP/s,
# needs DMMA tiles the ADMM and pivot loops do not form)
H100_PEAK_F64 = 34e12
# HBM3 rate
H100_HBM_BYTES_S = 3.35e12


def admm_flops(n: int, m: int, iters, *, ruiz_iters: int = 10,
               check_every: int = 25, adapt_every: int = 100,
               polish: bool = True) -> float:
    """FLOPs of one ADMM QP solve (ops/batch_qp.solve_qp_batch) of n vars,
    m rows, running ``iters`` iterations. ``iters`` may be an array (batch).
    """
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = (4 * m * n            # rhs assembly A'(Rz-y) and A x
                + 2 * n * n          # two triangular solves
                + 8 * (m + n))       # vector updates
    per_check = 2 * n * n + 4 * m * n
    per_adapt = 2 * m * n * n + n ** 3 / 3
    setup = (ruiz_iters * (2 * n * n + 2 * m * n)   # equilibration sweeps
             + 2 * m * n * n + n ** 3 / 3)          # A'RA + initial Cholesky
    polish_cost = (8.0 / 3.0) * (n + m) ** 3 if polish else 0.0
    return float(np.sum(setup + polish_cost
                        + iters * per_iter
                        + (iters / check_every) * per_check
                        + (iters / adapt_every) * per_adapt))


def newton_flops(n: int, iters, *, line_search: int = 8) -> float:
    """FLOPs of the semismooth-Newton polish (ops/avi._newton_phase): per
    iteration a ridge solve (normal equations + Cholesky) plus a batched
    line search of matvecs."""
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = (2 * n ** 3           # A'A for the ridge normal equations
                + n ** 3 / 3         # Cholesky
                + 2 * n * n          # Jacobian assembly
                + line_search * 2 * n * n)
    return float(np.sum(iters * per_iter))


def lemke_flops(n: int, pivots) -> float:
    """FLOPs of the Lemke pivot loop: each pivot is a rank-1 update of the
    (n, 3n+2) tableau plus the basic-value matvec and ratio test."""
    pivots = np.asarray(pivots, dtype=np.float64)
    per_pivot = (2 * n * (3 * n + 2)      # rank-1 tableau update
                 + 2 * n * (3 * n + 1)    # basic-value recomputation
                 + n * n                  # lexicographic refinement bound
                 + 6 * n)
    return float(np.sum(pivots * per_pivot))


def admm_bytes(n: int, m: int, iters, dtype_bytes: int = 8) -> float:
    """Approximate device-memory traffic of the ADMM loop: per iteration
    the A matrix is streamed twice (A'v and Ax) and the Cholesky factor
    once; vectors are negligible.  Caching in L2 or shared memory makes
    this an upper bound for small shapes."""
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = dtype_bytes * (2 * m * n + n * n)
    return float(np.sum(iters * per_iter))
