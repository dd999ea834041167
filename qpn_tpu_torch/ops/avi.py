"""Batched KKT-AVI ensemble solve — the PyTorch port of ``qpn_tpu/ops/avi.py``
(slice 1: the structures, the natural residual, the Newton polish and the
Lemke route of ``solve_kkt_avi_batch``).

The box mixed complementarity problem

    find z :  M z + q ⟂ l ≤ z ≤ u        (componentwise)

is solved for a batch of scenario lanes by complementary pivoting: the f32
pivot path picks the terminal complementary basis, one batched f64 LU
(``lemke.refactor_batch``) lands machine-precision values, and stragglers
get an f64 semismooth-Newton polish, then an f64 re-pivot.  Every result is
audited against the natural residual ``Φ(z) = z − clip(z − (Mz + q), l, u)``.

All device work follows the input tensors' device; the pivot loop runs in
the hand-written CUDA kernel for CUDA tensors (``CONFIG.lemke_kernel``).

GAVI structures and the slack-augmentation conversion mirror avi.jl:18-39 and
avi.jl:113-128.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG
from ..utils.metrics import METRICS
from . import lemke
from .linalg import ridge_solve


class Status(enum.IntEnum):  # avi.jl:1-6
    SUCCESS = 1
    RAY_TERM = 2
    MAX_ITERS = 3
    FAILURE = 4


@dataclasses.dataclass
class AVI:
    """``Mz + Nw + o ⟂ l ≤ z ≤ u`` (avi.jl:10-16). Host-side numpy struct."""
    M: np.ndarray
    N: np.ndarray
    o: np.ndarray
    l: np.ndarray
    u: np.ndarray


@dataclasses.dataclass
class GAVI:
    """Generalized AVI, two condition blocks (avi.jl:18-39)::

        (M z + N w + o) ⟂ (l1 ≤ z1 ≤ u1)
        (      z2     ) ⟂ (l2 ≤ A z + B w ≤ u2),   z = [z1; z2]
    """
    M: np.ndarray
    N: np.ndarray
    o: np.ndarray
    l1: np.ndarray
    u1: np.ndarray
    A: np.ndarray
    B: np.ndarray
    l2: np.ndarray
    u2: np.ndarray

    @property
    def d1(self):
        return len(self.l1)

    @property
    def d2(self):
        return len(self.l2)


@dataclasses.dataclass
class GLCP:
    """General linear complementarity problem ``Mz + q ⟂ l ≤ Az ≤ u``
    (avi.jl:41-53; defined-but-unused in the reference, kept for API parity —
    z need not match the dimension of q/l/u)."""
    M: np.ndarray
    q: np.ndarray
    A: np.ndarray
    l: np.ndarray
    u: np.ndarray


def convert_gavi(gavi: GAVI) -> AVI:
    """Slack augmentation GAVI → box AVI (avi.jl:113-128).

    AVI unknowns ``[z1; z2; s]`` with rows::

        [M   0] z            ⟂ l1 ≤ z1 ≤ u1
        [A  -I] z + B w      = 0          (z2 rows: free s defn)
        [0 I 0] z            ⟂ l2 ≤ s ≤ u2
    """
    d1, d2 = gavi.d1, gavi.d2
    m = gavi.N.shape[1]
    M = np.zeros((d1 + 2 * d2, d1 + 2 * d2))
    M[:d1, :d1 + d2] = gavi.M
    M[d1:d1 + d2, :d1 + d2] = gavi.A
    M[d1:d1 + d2, d1 + d2:] = -np.eye(d2)
    M[d1 + d2:, d1:d1 + d2] = np.eye(d2)
    N = np.vstack([gavi.N, gavi.B, np.zeros((d2, m))])
    o = np.concatenate([gavi.o, np.zeros(d2), np.zeros(d2)])
    l = np.concatenate([gavi.l1, np.full(d2, -np.inf), gavi.l2])
    u = np.concatenate([gavi.u1, np.full(d2, np.inf), gavi.u2])
    return AVI(M, N, o, l, u)


# --------------------------------------------------------------------------
#  Batched solve
# --------------------------------------------------------------------------

class AVIResult(NamedTuple):
    z: torch.Tensor          # (B, n)
    resid: torch.Tensor      # (B,) ‖Φ(z)‖∞
    iters: torch.Tensor      # (B,)
    converged: torch.Tensor  # (B,) bool


def batch_from_numpy(batch: dict, device="cpu") -> dict:
    """The JAX package's ensemble dict (numpy ``M, q, l, u, z0, mask`` plus
    ``structure``, as ``models.robust_avoid.scenario_batch_gavis`` returns
    it) as the port's tensors on ``device``: f64 data, bool mask."""
    out = {k: torch.as_tensor(np.asarray(batch[k], dtype=np.float64),
                              device=device)
           for k in ("M", "q", "l", "u", "z0")}
    out["mask"] = torch.as_tensor(np.asarray(batch["mask"], dtype=bool),
                                  device=device)
    if "structure" in batch:
        out["structure"] = dict(batch["structure"])
    return out


def _masked(M, q, l, u, var_mask):
    """Padded variables become pinned-at-zero identity rows."""
    n = q.shape[1]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    vm = var_mask.to(torch.bool)
    return (torch.where(vm[:, :, None] & vm[:, None, :], M, eye),
            torch.where(vm, q, zero), torch.where(vm, l, zero),
            torch.where(vm, u, zero))


def _phi(M, q, l, u, z):
    """Natural residual vector Φ(z) = z − clip(z − (Mz + q), l, u)."""
    F = (M @ z[:, :, None])[:, :, 0] + q
    return z - torch.clamp(z - F, l, u)


def natural_residual(M, q, l, u, z, var_mask=None):
    """Batched ‖Φ(z)‖∞, (B, n) → (B,); padded variables count 0."""
    Phi = _phi(M, q, l, u, z)
    if var_mask is not None:
        Phi = torch.where(var_mask.to(torch.bool), Phi, 0.0)
    return Phi.abs().amax(1)


def solve_avi_batch_polish(M, q, l, u, z0, var_mask, tol=1e-10,
                           max_iter=60) -> AVIResult:
    """Plain semismooth-Newton polish (no proximal/extragradient rounds) for
    warm starts already near the solution, batched: each lane iterates
    while it is under ``max_iter`` steps, above the merit tolerance and has
    stalled fewer than 4 times (``qpn_tpu/ops/avi.py::_newton_polish_only``,
    with the lanes written out where the JAX package vmaps)."""
    Mm, qm, l, u = _masked(M, q, l, u, var_mask)
    B, n = qm.shape
    dt, dev = qm.dtype, qm.device
    eye = torch.eye(n, dtype=dt, device=dev)
    ts = 0.5 ** torch.arange(8, dtype=dt, device=dev)
    tol_m = 0.5 * tol * tol

    def merit(sel, z):
        Phi = _phi(Mm[sel], qm[sel], l[sel], u[sel], z)
        return 0.5 * (Phi * Phi).sum(1), Phi

    z = torch.where(var_mask.to(torch.bool), z0, 0.0)
    best_z = z.clone()
    best_m, _ = merit(slice(None), z)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    stall = torch.zeros_like(k)
    for _ in range(max_iter):
        sel = torch.nonzero((best_m > tol_m) & (stall < 4))[:, 0]
        if sel.numel() == 0:
            break
        zs, Ms, ls, us = z[sel], Mm[sel], l[sel], u[sel]
        m0, Phi = merit(sel, zs)
        s = zs - ((Ms @ zs[:, :, None])[:, :, 0] + qm[sel])
        D = ((s > ls) & (s < us)).to(dt)
        J = D[:, :, None] * Ms + (1.0 - D)[:, :, None] * eye
        dz = ridge_solve(J, -Phi, 1e-12)
        # Armijo line search over 8 halvings, all trial points at once
        Ztry = zs[:, None, :] + ts[None, :, None] * dz[:, None, :]
        Ftry = Ztry @ Ms.transpose(1, 2) + qm[sel][:, None, :]
        Phitry = Ztry - torch.clamp(Ztry - Ftry, ls[:, None, :],
                                    us[:, None, :])
        mtry = 0.5 * (Phitry * Phitry).sum(2)
        ok = mtry <= (1.0 - 1e-4 * ts)[None, :] * m0[:, None]
        accepted = ok.any(1)
        first = lemke._first_true(ok)
        r = torch.arange(sel.numel(), device=dev)
        z_next = torch.where(accepted[:, None], Ztry[r, first], zs)
        m_next, _ = merit(sel, z_next)
        best_z[sel] = torch.where((m_next < best_m[sel])[:, None], z_next,
                                  best_z[sel])
        best_m[sel] = torch.minimum(m_next, best_m[sel])
        z[sel] = z_next
        stall[sel] = torch.where(accepted, 0, stall[sel] + 1)
        k[sel] += 1
    resid = _phi(Mm, qm, l, u, best_z).abs().amax(1)
    return AVIResult(z=best_z, resid=resid, iters=k, converged=resid <= tol)


def solve_kkt_avi_batch(M, q, l, u, var_mask, structure, tol=1e-10,
                        method: str = "lemke") -> AVIResult:
    """Structured solve for stacked-KKT AVI ensembles, Lemke route.

    Batched complementary pivoting on the KKT AVI directly: the f32 pivot
    path terminates on an exact complementary basis in ~n pivots, the f64
    refactorization of that basis lands machine-precision values, and the
    natural-residual audit decides each lane.  Stragglers get a short f64
    Newton polish, then an f64 re-pivot (the same engine in f64).

    Tensors: M (B,n,n), q/l/u (B,n) of any float dtype (the solve is f64),
    var_mask (B,n) bool, all on one device.  Not ported yet, and raising
    ``NotImplementedError``: ``method="admm"`` and the shared-matrix route
    for large ``shared_M`` ensembles.  Lanes still uncertified after the
    re-pivot (the JAX package hands them to ADMM) come back with
    ``converged=False`` and are counted in
    ``METRICS["kkt_uncertified_lanes"]``."""
    if method != "lemke":
        raise NotImplementedError(
            f"method={method!r}: the batched ADMM route (qpn_tpu/ops/"
            "batch_qp.py) is not ported yet — ROADMAP queue 1, 'ADMM route'")
    f64, f32 = torch.float64, torch.float32
    M, q, l, u = (a.to(f64) for a in (M, q, l, u))
    vm = var_mask.to(torch.bool)
    B, n, _ = M.shape
    if (structure.get("shared_M") and n >= CONFIG.shared_kkt_min_n
            and bool(vm.all()) and bool((M == M[:1]).all())):
        raise NotImplementedError(
            f"shared-matrix ensemble with n={n} >= shared_kkt_min_n="
            f"{CONFIG.shared_kkt_min_n}: the shared-matrix route "
            "(qpn_tpu/ops/shared_kkt.py) is not ported yet — ROADMAP slice 3")
    # power-of-two pivot budget, as the JAX package sizes it
    max_pivots = 256
    while max_pivots < min(4096, 16 * n + 256):
        max_pivots *= 2
    zeros = torch.zeros(B, n, dtype=f32, device=M.device)

    # f32 pivot path: it only has to pick the right complementary basis
    z32, _, pivL, basis32, val32 = lemke.solve_lemke_batch_state_auto(
        M.to(f32), q.to(f32), l.to(f32), u.to(f32), zeros, vm,
        tol=1e-6, piv_tol=1e-5, max_pivots=max_pivots)
    zL, okR = lemke.refactor_batch(M, q, l, u, basis32, val32, vm)
    zL = torch.where(okR[:, None], zL, z32.to(f64))
    residL = natural_residual(M, q, l, u, zL, vm)
    pivL = pivL.to(torch.int64)
    okL = residL <= tol

    if not bool(okL.all()):
        # short f64 Newton polish only for the residual stragglers
        idx = torch.nonzero(~okL)[:, 0]
        METRICS.bump("kkt_polish_lanes", idx.numel())
        pol = solve_avi_batch_polish(M[idx], q[idx], l[idx], u[idx],
                                     zL[idx], vm[idx], tol=tol, max_iter=8)
        rP = natural_residual(M[idx], q[idx], l[idx], u[idx], pol.z,
                              vm[idx])
        better = rP < residL[idx]
        zL[idx[better]] = pol.z[better]
        residL[idx[better]] = rP[better]
        okL = residL <= tol
    if not bool(okL.all()):
        # f64 re-pivot: the same engine in f64, then the refactorization
        idx = torch.nonzero(~okL)[:, 0]
        METRICS.bump("kkt_repivot_lanes", idx.numel())
        z64, _, piv64, basis64, val64 = lemke.solve_lemke_batch_state_auto(
            M[idx], q[idx], l[idx], u[idx], zeros[idx].to(f64), vm[idx],
            tol=1e-11, max_pivots=max_pivots)
        zR, okR64 = lemke.refactor_batch(M[idx], q[idx], l[idx], u[idx],
                                         basis64, val64, vm[idx])
        z64 = torch.where(okR64[:, None], zR, z64)
        r64 = natural_residual(M[idx], q[idx], l[idx], u[idx], z64, vm[idx])
        better = r64 < residL[idx]
        zL[idx[better]] = z64[better]
        residL[idx[better]] = r64[better]
        pivL[idx] += piv64.to(torch.int64)
        okL = residL <= tol
    METRICS.bump("kkt_uncertified_lanes", int((~okL).sum()))
    return AVIResult(z=zL, resid=residL, iters=pivL, converged=okL)
