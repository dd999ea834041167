"""Operations and bytes of the hand-written kernels, counted from shapes and
from work fixed in the benchmark, and the least time the card could take.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
float32 outside the tensor cores 67 TFLOP/s (what the pivot and
extragradient loops can use), HBM3 3.35 TB/s.  A card set to a lower power
limit runs below them; the run prints the card's limit beside its numbers.
"""

from __future__ import annotations

PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12
F32 = 4
I32 = 4


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the f32 peak or
    bytes over the memory rate, whichever is longer."""
    return max(flops / PEAK_F32, nbytes / HBM_BYTES_S)


def k1_flops(n: int, lanes: int, pivots_per_lane: float) -> float:
    """K1, the pivot loop: a pivot recomputes the basic values from the
    (n, 3n+2) tableau, 2·n·(3n+1) operations, and updates the tableau by a
    rank-1 step, 2·n·(3n+2)."""
    return pivots_per_lane * lanes * (2 * n * (3 * n + 1)
                                      + 2 * n * (3 * n + 2))


def k1_bytes(n: int, lanes: int) -> float:
    """K1's inputs read once and outputs written once, f32: the tableau
    (n, 3n+2), the basis (n), the nonbasic values and both variable bounds
    (3n+1 each), the boxed bounds (n each) and four scalars in; the basic
    values (n), the basis (n), the values (3n+1), the pivots and the status
    out."""
    per_in = F32 * (n * (3 * n + 2) + 3 * (3 * n + 1) + 2 * n + 4) + I32 * n
    per_out = F32 * (n + 3 * n + 1) + I32 * (n + 2)
    return lanes * (per_in + per_out)


def k2_flops(n: int, lanes: int, steps: int) -> float:
    """K2, the extragradient steps: two half-steps a step, each n rows of n
    multiply-adds plus 5 operations a row (add q, scale, subtract, two
    clips)."""
    return lanes * steps * 2.0 * (2 * n * n + 5 * n)


def k2_bytes(n: int, lanes: int) -> float:
    """K2's inputs read once and output written once, f32: M (n, n), q, l,
    u, z0 (n each) and the step size in; z (n) out."""
    return lanes * F32 * (n * n + 4 * n + 1 + n)
