"""Batched dense linear-algebra building blocks (counterpart of
``qpn_tpu/ops/linalg.py``).

The JAX package routes every solve through Cholesky or QR because the TPU
has no f64 LU; PyTorch has batched f64 LU on the CPU and the GPU, so the
port uses ``torch.linalg.solve_ex`` where a general square system is solved
(``ops/lemke.refactor_batch``) and keeps Cholesky only where the system is
SPD by construction.
"""

from __future__ import annotations

import torch

from ..utils.metrics import METRICS


def chol_solve(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``K x = b`` (``b``: (..., n)) via Cholesky, batched.

    A factorization that fails (K not numerically positive definite) gives
    NaN for that system, as ``jnp.linalg.cholesky`` does, instead of raising
    for the whole batch."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    return cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def cholesky_solve(b: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``torch.cholesky_solve(b, L)``.  On the card PyTorch hands a batch of
    more than one system to MAGMA, which waits on the card inside the call
    (its own allocations and a stream synchronization); a single system goes
    to cuSOLVER, which does not.  The waiting call is counted as a host sync
    (``METRICS.sync``)."""
    if L.shape[:-2].numel() > 1:
        return METRICS.sync(torch.cholesky_solve, b, L)
    return torch.cholesky_solve(b, L)


def ridge_solve(A: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-10) -> torch.Tensor:
    """Least-squares/least-norm solve via regularized normal equations:
    ``x = (A'A + eps I)^{-1} A' b``, batched over leading dims."""
    n = A.shape[-1]
    At = A.transpose(-1, -2)
    K = At @ A + eps * torch.eye(n, dtype=A.dtype, device=A.device)
    return chol_solve(K, (At @ b.unsqueeze(-1)).squeeze(-1))
