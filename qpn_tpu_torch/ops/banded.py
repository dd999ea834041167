"""Block-tridiagonal KKT solver by cyclic reduction (PyTorch port of
``qpn_tpu/ops/banded.py``).

Trajectory-horizon KKT systems (robust_avoid's T-step dynamics,
deprecated/robust_avoid.jl:72-83) factor as block-banded matrices.  A serial
Thomas sweep is O(T) sequential; cyclic reduction runs in ⌈log₂T⌉ levels,
each one set of batched k×k solves and products over all T blocks at once,
in the dtype and on the device of its inputs.

System:  A_t x_{t-1} + B_t x_t + C_t x_{t+1} = b_t,  t = 0..T-1
(A_0 = C_{T-1} = 0).  Blocks are general: the JAX package solves them by QR
(its TPU has no f64 LU), the port by LU (``torch.linalg.solve``).

Every function takes optional leading batch dimensions before the block
axis: (..., T, k, k) blocks and (..., T, k) right-hand sides.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _levels(T: int) -> int:
    return max(1, int(np.ceil(np.log2(max(T, 2)))))


def _level_ops(A, B, C, stride, T):
    """One cyclic-reduction level on the matrix data: eliminate neighbours at
    distance ``stride``, as a full masked update (indices without a neighbour
    this level pass through).  Returns the elimination operators
    (Gm, Gp, im, ip), enough to replay the level on any RHS, and the reduced
    (A, B, C)."""
    idx = torch.arange(T, device=B.device)
    im = (idx - stride).clamp(0, T - 1)
    ip = (idx + stride).clamp(0, T - 1)
    has_m = (idx - stride >= 0)[:, None, None]
    has_p = (idx + stride <= T - 1)[:, None, None]
    # G_m = A_t B_{t-s}^{-1},  G_p = C_t B_{t+s}^{-1}
    Gm = torch.linalg.solve(B[..., im, :, :].mT, A.mT).mT
    Gp = torch.linalg.solve(B[..., ip, :, :].mT, C.mT).mT
    Gm = torch.where(has_m, Gm, 0.0)
    Gp = torch.where(has_p, Gp, 0.0)
    B_new = B - Gm @ C[..., im, :, :] - Gp @ A[..., ip, :, :]
    A_new = -Gm @ A[..., im, :, :]
    C_new = -Gp @ C[..., ip, :, :]
    return (Gm, Gp, im, ip), A_new, B_new, C_new


def _rhs_reduce(b, Gm, Gp, im, ip):
    """Replay one elimination level on a RHS (..., T, k)."""
    return (b - (Gm @ b[..., im, :, None])[..., 0]
            - (Gp @ b[..., ip, :, None])[..., 0])


def solve_block_tridiag(A, B, C, b):
    """Solve the block-tridiagonal system by full cyclic reduction.

    Shapes: A, B, C (..., T, k, k); b (..., T, k).  After ⌈log₂T⌉ doubling
    levels every equation is decoupled (its off-diagonal blocks vanish) and
    one batched block solve finishes."""
    T = B.shape[-3]
    stride = 1
    for _ in range(_levels(T)):
        (Gm, Gp, im, ip), A, B, C = _level_ops(A, B, C, stride, T)
        b = _rhs_reduce(b, Gm, Gp, im, ip)
        stride *= 2
    return torch.linalg.solve(B, b)


# --------------------------------------------------------------------------
#  factor / solve split — reuse the reduction operators across many RHS
#  (the production pattern: one factorization per ADMM rho value, one
#  O(log T) solve per iteration)
# --------------------------------------------------------------------------

class CRFactor:
    """Cyclic-reduction operators of a batch of block-tridiagonal systems:
    per level (Gm, Gp) of shape (..., T, k, k) and the index maps (im, ip),
    then the inverses of the decoupled diagonal blocks.  ``take`` and
    ``assign`` act on a lane subset of the leading batch axis of every
    tensor at once (the ADMM x-update refactors only the lanes whose ρ
    moved)."""

    def __init__(self, Gm: List[torch.Tensor], Gp: List[torch.Tensor],
                 im: List[torch.Tensor], ip: List[torch.Tensor],
                 B_inv: torch.Tensor):
        self.Gm, self.Gp, self.im, self.ip, self.B_inv = Gm, Gp, im, ip, B_inv

    def take(self, idx) -> "CRFactor":
        return CRFactor([g[idx] for g in self.Gm], [g[idx] for g in self.Gp],
                        self.im, self.ip, self.B_inv[idx])

    def assign(self, idx, other: "CRFactor") -> None:
        for dst, src in zip(self.Gm + self.Gp + [self.B_inv],
                            other.Gm + other.Gp + [other.B_inv]):
            dst[idx] = src


def cr_factor(A, B, C) -> CRFactor:
    """Precompute the cyclic-reduction operators (matrix-only work, no
    RHS), consumed by :func:`cr_solve`."""
    T, k = B.shape[-3], B.shape[-1]
    Gm, Gp, im, ip = [], [], [], []
    stride = 1
    for _ in range(_levels(T)):
        (gm, gp, i_m, i_p), A, B, C = _level_ops(A, B, C, stride, T)
        Gm.append(gm)
        Gp.append(gp)
        im.append(i_m)
        ip.append(i_p)
        stride *= 2
    # fold the final block solves into the factorization: per-solve work is
    # then batched matvecs only
    eye = torch.eye(k, dtype=B.dtype, device=B.device).expand(B.shape)
    return CRFactor(Gm, Gp, im, ip, torch.linalg.solve(B, eye))


def cr_solve(factor: CRFactor, b):
    """Apply a precomputed factorization to a RHS (..., T, k): ⌈log₂T⌉
    levels of batched small matvecs."""
    for Gm, Gp, im, ip in zip(factor.Gm, factor.Gp, factor.im, factor.ip):
        b = _rhs_reduce(b, Gm, Gp, im, ip)
    return (factor.B_inv @ b[..., None])[..., 0]


def kkt_blocks(K, k: int):
    """Split (..., n, n) matrices that are block-tridiagonal with k×k blocks
    into the (A, B, C) block lists of :func:`cr_factor` (n = T·k)."""
    n = K.shape[-1]
    Tb = n // k
    Kb = K.reshape(*K.shape[:-2], Tb, k, Tb, k)
    idx = torch.arange(Tb, device=K.device)
    Bd = Kb[..., idx, :, idx, :]
    Ad = Kb[..., idx, :, (idx - 1).clamp(0, Tb - 1), :].clone()
    Cd = Kb[..., idx, :, (idx + 1).clamp(0, Tb - 1), :].clone()
    # advanced indexing over two separated axes puts the block axis first
    Bd, Ad, Cd = (t.movedim(0, -3) for t in (Bd, Ad, Cd))
    Ad[..., 0, :, :] = 0.0
    Cd[..., Tb - 1, :, :] = 0.0
    return Ad, Bd, Cd


def detect_banded_k(P, A, min_blocks: int = 8, max_k: int = 64) -> int:
    """Auto-detect block-tridiagonal structure of the ADMM KKT matrix
    ``P + σI + A'RA`` from the sparsity patterns of P and A.

    Returns the block size ``k`` (dividing n) with the MOST blocks
    ``Tb = n/k ≥ min_blocks`` such that both P and A'A are block-tridiagonal
    in the given variable ordering — the trajectory-horizon class the
    reference factors as banded dynamics (deprecated/robust_avoid.jl:72-83).
    Returns 0 when no qualifying block size exists (dense route).

    Accepts single (n,n)/(m,n) or batched (B,n,n)/(B,m,n) numpy inputs; for
    a batch the detected structure must hold for the pattern union, so one
    ``banded_k`` is valid for every lane.  Cost: O(n²) boolean reductions."""
    P = np.asarray(P)
    A = np.asarray(A)
    n = P.shape[-1]
    patP = (np.abs(P) > 0)
    if patP.ndim == 3:
        patP = patP.any(axis=0)
    patA = (np.abs(A) > 0)
    if patA.ndim == 3:
        patA = patA.reshape(-1, n)
    for k in range(1, min(max_k, n // min_blocks) + 1):
        if n % k:
            continue
        Tb = n // k
        # block-level patterns: P blocks and A'A blocks via per-row block
        # incidence (avoids forming the n×n product)
        blkP = patP.reshape(Tb, k, Tb, k).any(axis=(1, 3))
        inc = patA.reshape(-1, Tb, k).any(axis=2)          # (m, Tb)
        coupled = blkP | (inc.T @ inc)                      # (Tb, Tb)
        off = np.abs(np.arange(Tb)[:, None] - np.arange(Tb)[None, :]) > 1
        if not coupled[off].any():
            return k            # smallest k = most blocks = biggest win
    return 0


def horizon_kkt_blocks(T: int, k: int, rng: np.random.Generator = None,
                       rho: float = 1.0):
    """Build a T-step tracking-with-dynamics KKT in block-tridiagonal form:

        min Σ_t ½ x_t' Q_t x_t − g_t' x_t  s.t.  x_{t+1} = F x_t + c_t

    condensed by dual elimination with penalty ρ — giving diagonal blocks
    B_t = Q_t + ρ(I + F'F) and couplings A_t = −ρF, C_t = −ρF'.  numpy, the
    same draws as the JAX package's; used by tests and benchmarks."""
    rng = rng or np.random.default_rng(0)
    F = 0.5 * rng.standard_normal((k, k)) / np.sqrt(k)
    Q = []
    g = rng.standard_normal((T, k))
    for _ in range(T):
        G = rng.standard_normal((k, k))
        Q.append(G @ G.T / k + np.eye(k))
    Q = np.stack(Q)
    eye = np.eye(k)
    B = Q + rho * (eye + F.T @ F)[None]
    A = np.repeat((-rho * F)[None], T, axis=0)
    C = np.repeat((-rho * F.T)[None], T, axis=0)
    A[0] = 0.0
    C[-1] = 0.0
    return A, B, C, g


def dense_from_blocks(A, B, C):
    """Assemble the dense matrix (numpy; for verification only)."""
    T, k, _ = B.shape
    M = np.zeros((T * k, T * k))
    for t in range(T):
        M[t * k:(t + 1) * k, t * k:(t + 1) * k] = B[t]
        if t > 0:
            M[t * k:(t + 1) * k, (t - 1) * k:t * k] = A[t]
        if t < T - 1:
            M[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = C[t]
    return M
