"""Batched AVI ensemble solves — the PyTorch port of ``qpn_tpu/ops/avi.py``:
the structures, the natural residual, the Newton polish, both routes of
``solve_kkt_avi_batch`` (Lemke, and ADMM on the recovered QP), the generic
hybrid solver with its adaptive, mixed-precision and padded wrappers, and the
host-level single-problem wrappers of the equilibrium algorithm
(``solve_avi``, ``solve_gavi`` and their helpers).

The box mixed complementarity problem

    find z :  M z + q ⟂ l ≤ z ≤ u        (componentwise)

is solved for a batch of scenario lanes on two routes.  The KKT route
pivots: the f32 pivot path picks the terminal complementary basis, one
batched f64 LU (``lemke.refactor_batch``) lands machine-precision values,
and stragglers get an f64 semismooth-Newton polish, then an f64 re-pivot.
The generic route (``solve_avi_batch_adaptive``) runs an f32 extragradient
warm start (``ops/eg.py``), then the hybrid semismooth-Newton / proximal /
extragradient solver in escalating budgets, then proximal Lemke pivoting
(``lemke.lemke_escalate``) on whatever is left.  Every result is audited
against the natural residual ``Φ(z) = z − clip(z − (Mz + q), l, u)``.

All batched device work follows the input tensors' device (the host
wrappers put it on ``CONFIG.device``); the pivot loop and the extragradient
steps run in hand-written CUDA kernels for CUDA tensors
(``CONFIG.lemke_kernel``, ``CONFIG.eg_kernel``).

GAVI structures and the slack-augmentation conversion mirror avi.jl:18-39 and
avi.jl:113-128.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG, bucket, numeric_device
from ..utils.metrics import METRICS
from . import batch_qp, lemke
from .eg import eg_step, eg_warmstart, ruiz
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


def batch_from_numpy(batch: dict, device=None) -> dict:
    """The JAX package's ensemble dict (numpy ``M, q, l, u, z0, mask`` plus
    ``structure``, as ``models.robust_avoid.scenario_batch_gavis`` returns
    it) as the port's tensors on ``device`` (None: ``CONFIG.device``): f64
    data, bool mask."""
    if device is None:
        device = numeric_device()
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
    stalled fewer than 4 times, with an 8-step Armijo search
    (``qpn_tpu/ops/avi.py::_newton_polish_only``, with the lanes written out
    where the JAX package vmaps)."""
    Mm, qm, l, u = _masked(M, q, l, u, var_mask)
    z = torch.where(var_mask.to(torch.bool), z0, 0.0)
    best_z, _, k = _newton_phase(Mm, qm, l, u, z, max_iter, 0.5 * tol * tol,
                                 stall_limit=4, halvings=8)
    resid = _phi(Mm, qm, l, u, best_z).abs().amax(1)
    return AVIResult(z=best_z, resid=resid, iters=k, converged=resid <= tol)


def solve_kkt_avi_batch(M, q, l, u, var_mask, structure, tol=1e-10,
                        method: str = "lemke") -> AVIResult:
    """Structured solve for stacked-KKT AVI ensembles.

    ``method="lemke"``: batched complementary pivoting on the KKT AVI
    directly: the f32 pivot path terminates on an exact complementary basis
    in ~n pivots, the f64 refactorization of that basis lands machine-
    precision values, and the natural-residual audit decides each lane.
    Stragglers get a short f64 Newton polish, then an f64 re-pivot (the same
    engine in f64); lanes still uncertified (counted in
    ``METRICS["kkt_uncertified_lanes"]``) re-solve on the ADMM route.

    ``method="admm"``: recover the QP from the KKT blocks (``structure``'s
    ``nd`` decisions and ``m`` rows), solve it with the batched ADMM engine,
    rebuild ``(λ, s)``, and Newton-polish the lanes above ``tol``.

    Ensembles tagged ``structure["shared_M"]`` (one matrix replicated over
    the lanes, no padding) at ``n >= CONFIG.shared_kkt_min_n`` go to the
    shared-matrix route (``ops/shared_kkt.solve_kkt_avi_shared``): at that
    size a pivot tableau per lane is bound by memory traffic.  Counted in
    ``METRICS["kkt_shared_route"]``.

    Tensors: M (B,n,n), q/l/u (B,n) of any float dtype (the solve is f64),
    var_mask (B,n) bool, all on one device."""
    if method == "admm":
        return _solve_kkt_avi_admm(M, q, l, u, var_mask, structure, tol)
    if method != "lemke":
        raise ValueError(f"unknown method {method!r} (expected 'lemke' or "
                         "'admm')")
    f64, f32 = torch.float64, torch.float32
    M, q, l, u = (a.to(f64) for a in (M, q, l, u))
    vm = var_mask.to(torch.bool)
    B, n, _ = M.shape
    if (structure.get("shared_M") and n >= CONFIG.shared_kkt_min_n
            and bool(vm.all()) and bool((M == M[:1]).all())):
        from .shared_kkt import solve_kkt_avi_shared
        METRICS.bump("kkt_shared_route", B)
        return solve_kkt_avi_shared(M[0], q, l, u, None, tol=tol,
                                    structure=structure)
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
    if bool(okL.all()):
        return AVIResult(z=zL, resid=residL, iters=pivL, converged=okL)
    # re-solve the uncertified lanes through the ADMM + polish route
    idx = torch.nonzero(~okL)[:, 0]
    sub = _solve_kkt_avi_admm(M[idx], q[idx], l[idx], u[idx], vm[idx],
                              structure, tol)
    zL[idx] = sub.z
    residL[idx] = sub.resid
    pivL[idx] += sub.iters
    return AVIResult(z=zL, resid=residL, iters=pivL, converged=residL <= tol)


def _solve_kkt_avi_admm(M, q, l, u, var_mask, structure, tol) -> AVIResult:
    """ADMM route of :func:`solve_kkt_avi_batch`.  The KKT blocks hold

        rows 0..nd:      Q x − A'λ + c = 0
        rows nd..nd+m:   A x − s + off = 0
        vars nd+m..:     s with bounds [l2, u2],

    so the QP is  min ½x'Qx + c'x  s.t.  l2 − off ≤ A x ≤ u2 − off."""
    f64 = torch.float64
    M, q, l, u = (a.to(f64) for a in (M, q, l, u))
    vm = var_mask.to(torch.bool)
    B, n, _ = M.shape
    nd, m = structure["nd"], structure["m"]
    assert n >= nd + 2 * m
    Q = M[:, :nd, :nd]
    A = M[:, nd:nd + m, :nd]
    c = q[:, :nd]
    off = q[:, nd:nd + m]
    l2 = l[:, nd + m:nd + 2 * m]
    u2 = u[:, nd + m:nd + 2 * m]
    sol = batch_qp.solve_qp_batch(
        Q, c, A, l2 - off, u2 - off,
        torch.ones(B, m, dtype=torch.bool, device=q.device), eps=1e-9)
    s = (A @ sol.x[:, :, None])[:, :, 0] + off
    z = torch.cat([sol.x, -sol.y, s], 1)
    if n > nd + 2 * m:             # padded tail
        z = torch.nn.functional.pad(z, (0, n - nd - 2 * m))
    resid = natural_residual(M, q, l, u, z, vm)
    # f64 Newton polish for lanes above tolerance: first the light Newton-
    # only pass, then the full hybrid solver only for whatever remains
    need = torch.nonzero(resid > tol)[:, 0]
    if need.numel():
        res = solve_avi_batch_polish(M[need], q[need], l[need], u[need],
                                     z[need], vm[need], tol=tol)
        z[need] = res.z
        resid[need] = res.resid
        need = torch.nonzero(resid > tol)[:, 0]
        if need.numel():
            res = solve_avi_batch_padded(M[need], q[need], l[need], u[need],
                                         z[need], vm[need], tol=tol,
                                         max_iter=780)
            z[need] = res.z
            resid[need] = res.resid
    return AVIResult(z=z, resid=resid, iters=sol.iters,
                     converged=resid <= tol)


# --------------------------------------------------------------------------
#  Generic hybrid solver (semismooth Newton / proximal point / extragradient)
# --------------------------------------------------------------------------

def _merit(M, q, l, u, z):
    """½‖Φ(z)‖² per lane, and Φ."""
    Phi = _phi(M, q, l, u, z)
    return 0.5 * (Phi * Phi).sum(1), Phi


def _newton_phase(Mx, qx, l, u, z, iters_left, tol_m, stall_limit=3,
                  halvings=16):
    """Semismooth Newton with an Armijo search over ``halvings`` step sizes
    on (Mx, qx), batched.

    Each lane iterates while it is under ``iters_left`` steps, above the
    merit tolerance and has stalled fewer than ``stall_limit`` times in a
    row (``newton_phase`` of ``qpn_tpu/ops/avi.py::_newton_solve``, and
    ``_newton_polish_only`` with 8 halvings and 4 stalls).  Every lane
    starts at step 0 and a lane that stops never restarts, so the lanes
    still iterating have all taken the same number of steps.  Returns (best
    z, best merit, steps) per lane."""
    b, n = z.shape
    dt, dev = z.dtype, z.device
    eye = torch.eye(n, dtype=dt, device=dev)
    ts = 0.5 ** torch.arange(halvings, dtype=dt, device=dev)
    z = z.clone()
    best_z = z.clone()
    best_m, _ = _merit(Mx, qx, l, u, z)
    k = torch.zeros(b, dtype=torch.int64, device=dev)
    stall = torch.zeros_like(k)
    for _ in range(iters_left):
        sel = torch.nonzero((best_m > tol_m) & (stall < stall_limit))[:, 0]
        if sel.numel() == 0:
            break
        zs, Ms, qs, ls, us = z[sel], Mx[sel], qx[sel], l[sel], u[sel]
        F = (Ms @ zs[:, :, None])[:, :, 0] + qs
        s = zs - F
        Phi = zs - torch.clamp(s, ls, us)
        m0 = 0.5 * (Phi * Phi).sum(1)
        D = ((s > ls) & (s < us)).to(dt)
        J = D[:, :, None] * Ms + (1.0 - D)[:, :, None] * eye
        # the ridge handles singular active-set Jacobians (ξ-consensus rows,
        # LP blocks)
        dz = ridge_solve(J, -Phi, 1e-12)
        Ztry = zs[:, None, :] + ts[None, :, None] * dz[:, None, :]
        Ftry = Ztry @ Ms.transpose(1, 2) + qs[:, None, :]
        Phitry = Ztry - torch.clamp(Ztry - Ftry, ls[:, None, :],
                                    us[:, None, :])
        mtry = 0.5 * (Phitry * Phitry).sum(2)
        ok = mtry <= (1.0 - 1e-4 * ts)[None, :] * m0[:, None]
        accepted = ok.any(1)
        first = lemke._first_true(ok)
        r = torch.arange(sel.numel(), device=dev)
        z_next = torch.where(accepted[:, None], Ztry[r, first], zs)
        m_next, _ = _merit(Ms, qs, ls, us, z_next)
        bm = best_m[sel]
        best_z[sel] = torch.where((m_next < bm)[:, None], z_next, best_z[sel])
        best_m[sel] = torch.minimum(m_next, bm)
        z[sel] = z_next
        stall[sel] = torch.where(accepted, 0, stall[sel] + 1)
        k[sel] += 1
    return best_z, best_m, k


def _eg_phase(M, q, l, u, tau, z, steps):
    """``steps`` extragradient steps on every lane, tracking each lane's
    best-merit iterate (``eg_phase`` of ``_newton_solve``).  Returns (last
    z, best z, best merit)."""
    t = tau[:, None]
    best_z = z
    best_m, _ = _merit(M, q, l, u, z)
    for _ in range(steps):
        z = eg_step(M, q, l, u, z, t)
        m, _ = _merit(M, q, l, u, z)
        best_z = torch.where((m < best_m)[:, None], z, best_z)
        best_m = torch.minimum(m, best_m)
    return z, best_z, best_m


def solve_avi_batch(M, q, l, u, z0, var_mask, tol=1e-10,
                    max_iter=4000) -> AVIResult:
    """Batched box-AVI solve by the hybrid semismooth-Newton / proximal /
    extragradient method (``qpn_tpu/ops/avi.py::_newton_solve``, with the
    lanes written out where the JAX package vmaps).

    Semismooth Newton on the natural residual converges superlinearly near a
    solution but can stall on merely-monotone problems (LP KKT blocks give
    skew M and singular active-set Jacobians); extragradient steps converge
    for monotone M, but only linearly.  Each round therefore runs a Newton
    phase on the proximal subproblem ``(M + δI) z + (q − δ z_ref)`` (strongly
    monotone), a Newton polish on the true problem, and 60 extragradient
    steps as a basin hop; δ shrinks ×0.25 from 1e-2, and the best iterate is
    kept across phases.  A final 30-step Newton polish starts from it.

    Every loop is a masked lockstep loop: a lane takes a step only while its
    own condition holds, so each lane's result and step count are those of
    the JAX package's vmapped ``while_loop``.  Shapes: M (B,n,n); q/l/u/z0
    (B,n); var_mask (B,n) bool, padded variables pinned at 0.  The working
    precision is q's dtype.  ``iters`` counts Newton steps plus 60 per
    round's extragradient hop."""
    dt, dev = q.dtype, q.device
    M, l, u, z0 = (a.to(dt) for a in (M, l, u, z0))
    vm = var_mask.to(torch.bool)
    M0, q0, l0, u0 = _masked(M, q, l, u, vm)
    B, n = q0.shape
    eye = torch.eye(n, dtype=dt, device=dev)

    # complementarity-preserving Ruiz equilibration: M' = D M E, q' = D q,
    # bounds scale by 1/e; complementarity of (row i, z_i) is preserved
    d_sc, e_sc = ruiz(M0)
    Mm = d_sc[:, :, None] * M0 * e_sc[:, None, :]
    qm = d_sc * q0
    ls = torch.where(torch.isfinite(l0), l0 / e_sc, l0)
    us = torch.where(torch.isfinite(u0), u0 / e_sc, u0)
    # extragradient step τ ≤ 0.9 / L with L ≈ ‖M‖∞
    tau = 0.9 / (1.0 + Mm.abs().sum(2).amax(1))
    tol_m = 0.5 * tol * tol

    z = torch.clamp(torch.where(vm, z0 / e_sc, 0.0), ls, us)
    best_z = z.clone()
    best_m, _ = _merit(Mm, qm, ls, us, z)
    z_ref = z.clone()
    delta = torch.full((B,), 1e-2, dtype=dt, device=dev)
    total_k = torch.zeros(B, dtype=torch.int64, device=dev)
    max_rounds = max(2, int(max_iter) // (40 + 30 + 60))
    for _ in range(max_rounds):
        act = torch.nonzero(best_m > tol_m)[:, 0]
        if act.numel() == 0:
            break
        Ma, qa, la, ua = Mm[act], qm[act], ls[act], us[act]
        da = delta[act]
        pz, _, k1 = _newton_phase(Ma + da[:, None, None] * eye,
                                  qa - da[:, None] * z_ref[act], la, ua,
                                  z[act], 40, tol_m)
        # polish on the true problem from the proximal iterate
        qz, qmer, k2 = _newton_phase(Ma, qa, la, ua, pz, 30, tol_m)
        bz, bm = best_z[act], best_m[act]
        bz = torch.where((qmer < bm)[:, None], qz, bz)
        bm = torch.minimum(qmer, bm)
        # extragradient hop out of repeated basins
        ez, ebz, ebm = _eg_phase(Ma, qa, la, ua, tau[act], qz, 60)
        bz = torch.where((ebm < bm)[:, None], ebz, bz)
        bm = torch.minimum(ebm, bm)
        z[act] = torch.where((bm <= tol_m)[:, None], bz, ez)
        z_ref[act] = pz
        delta[act] = torch.clamp_min(da * 0.25, 1e-12)
        best_z[act], best_m[act] = bz, bm
        total_k[act] += k1 + k2 + 60

    # final Newton polish from each lane's best iterate
    pz, pm, pk = _newton_phase(Mm, qm, ls, us, best_z, 30, tol_m)
    best_z = torch.where((pm < best_m)[:, None], pz, best_z)

    # report the residual of the UNSCALED problem
    z_out = e_sc * best_z
    resid = _phi(M0, q0, ls * e_sc, us * e_sc, z_out).abs().amax(1)
    return AVIResult(z=z_out, resid=resid, iters=total_k + pk,
                     converged=resid <= tol)


def solve_avi_batch_mixed(M, q, l, u, z0, var_mask, tol=1e-10,
                          max_iter=4000) -> AVIResult:
    """Mixed-precision batched solve: the hybrid iteration in f32 to 1e-5
    within ``max_iter``, then in f64 to ``tol`` within
    ``max(520, max_iter // 8)``, warm-started at the f32 solution
    (``qpn_tpu/ops/avi.py::solve_avi_batch_mixed``).  Returns the f64
    pass's result."""
    f32, f64 = torch.float32, torch.float64
    res32 = solve_avi_batch(*(a.to(f32) for a in (M, q, l, u, z0)),
                            var_mask, tol=1e-5, max_iter=max_iter)
    return solve_avi_batch(*(a.to(f64) for a in (M, q, l, u)),
                           res32.z.to(f64), var_mask, tol=tol,
                           max_iter=max(520, max_iter // 8))


def inert_avi_lanes(k: int, n: int, dtype, device):
    """``k`` padding lanes of an (M, q, l, u, z0, var_mask) batch: identity
    M, zero data, every variable masked off, so that each lane is solved at
    z = 0 before the first iteration and moves no batchmate's result."""
    zeros = torch.zeros(k, n, dtype=dtype, device=device)
    return (torch.eye(n, dtype=dtype, device=device).repeat(k, 1, 1), zeros,
            zeros, zeros, zeros,
            torch.zeros(k, n, dtype=torch.bool, device=device))


def solve_avi_batch_padded(M, q, l, u, z0, var_mask, _no_broker=False,
                           _sharding=None, _min_batch=1, **kw) -> AVIResult:
    """:func:`solve_avi_batch` with the variable dimension padded to its
    ``CONFIG.row_buckets`` bucket (identity rows pinned at 0), as
    ``qpn_tpu/ops/avi.py::solve_avi_batch_padded`` pads it.

    The padding changes the numbers and is kept: the padding rows enter the
    extragradient step's ‖M‖∞.  Without ``_sharding`` the batch is not
    padded, since each lane's result is independent of the others.  Under a
    lockstep broker (``parallel/lockstep.py``) the call parks and fuses with
    the other scenarios' requests; the broker's fused dispatch passes
    ``_no_broker=True``.

    ``_sharding`` (``parallel.mesh.scenario_sharding``; every rank makes the
    same call) splits the batch over the mesh's ranks: padded with inert
    lanes (:func:`inert_avi_lanes`) to a multiple of the rank count and at
    least ``_min_batch`` lanes, this rank's block solved, the results
    gathered and the padding sliced off, tensors on the inputs' device,
    full on every rank."""
    if not _no_broker:
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("avi", M, q, l, u, z0, var_mask, **kw)
    if _sharding is not None:
        from ..parallel.mesh import call_sharded
        return call_sharded(
            _sharding,
            lambda *a: solve_avi_batch_padded(*a, _no_broker=True, **kw),
            (M, q, l, u, z0, var_mask),
            lambda k: inert_avi_lanes(k, q.shape[1], q.dtype, q.device),
            _min_batch)
    B, n = q.shape
    pad = bucket(n, CONFIG.row_buckets) - n
    if pad == 0:
        return solve_avi_batch(M, q, l, u, z0, var_mask, **kw)
    dt, dev = q.dtype, q.device
    Mp = torch.eye(n + pad, dtype=dt, device=dev).repeat(B, 1, 1)
    Mp[:, :n, :n] = M
    vec = [torch.nn.functional.pad(a.to(dt), (0, pad)) for a in (q, l, u, z0)]
    mp = torch.nn.functional.pad(var_mask.to(torch.bool), (0, pad))
    res = solve_avi_batch(Mp, *vec, mp, **kw)
    return AVIResult(z=res.z[:, :n], resid=res.resid, iters=res.iters,
                     converged=res.converged)


def solve_avi_batch_adaptive(M, q, l, u, z0, var_mask, *, tol=1e-10,
                             budgets=(390, 1560, 6000), mixed=True,
                             onchip_eg_steps: int = 0) -> AVIResult:
    """Straggler-decoupled batched solve: the generic route for box-AVI
    scenario ensembles (``qpn_tpu/ops/avi.py::solve_avi_batch_adaptive``).

    1. With ``onchip_eg_steps > 0``, a fused f32 extragradient pre-pass
       (``eg.eg_warmstart``; the CUDA kernel for CUDA tensors), accepted per
       lane only where it lowers the natural residual: extragradient only
       converges for monotone M.
    2. The hybrid solver (mixed precision or f64) in escalating iteration
       budgets; each stage takes only the lanes not yet certified, and a
       stage's result is kept only where it improves the stored residual.
    3. Between stages, each straggler whose residual is above 1e-4 is seeded
       from the certified lane with the nearest q.
    4. Proximal Lemke pivoting (``lemke.lemke_escalate``) on the rest.

    Tensors as in :func:`solve_avi_batch`, on one device; the solve is f64.
    The stages run at exact shapes (the JAX package's batch padding only
    serves XLA's compile cache and changes no lane's result)."""
    f64 = torch.float64
    M, q, l, u, z0 = (a.to(f64) for a in (M, q, l, u, z0))
    vm = var_mask.to(torch.bool)
    B, n = q.shape
    dev = q.device
    solver = solve_avi_batch_mixed if mixed else solve_avi_batch
    z_out = z0.clone()
    resid_out = torch.full((B,), torch.inf, dtype=f64, device=dev)
    iters_out = torch.zeros(B, dtype=torch.int64, device=dev)
    conv_out = torch.zeros(B, dtype=torch.bool, device=dev)
    idx = torch.arange(B, device=dev)
    z_cur = z0
    if onchip_eg_steps > 0:
        z_eg = eg_warmstart(M, q, l, u, z_cur, vm, steps=onchip_eg_steps)
        r_eg = natural_residual(M, q, l, u, z_eg, vm)
        r_0 = natural_residual(M, q, l, u, z_cur, vm)
        better = torch.isfinite(r_eg) & (r_eg < r_0)
        METRICS.bump("eg_accepted_lanes", int(better.sum()))
        z_cur = torch.where(better[:, None], z_eg, z_cur)
    z_warm = z_out      # seed for the NEXT stage; may hold neighbour copies
    for bi, budget in enumerate(budgets):
        if idx.numel() == 0:
            break
        res = solver(M[idx], q[idx], l[idx], u[idx],
                     (z_cur if bi == 0 else z_warm)[idx], vm[idx], tol=tol,
                     max_iter=budget)
        # a straggler reseeded from a neighbour can diverge in a later stage:
        # keep its earlier best (resid_out starts at inf, so stage 0 lands)
        upd = res.resid < resid_out[idx]
        z_out[idx[upd]] = res.z[upd]
        resid_out[idx[upd]] = res.resid[upd]
        conv_out[idx] = res.converged
        iters_out[idx] += res.iters
        idx = idx[~res.converged]
        # cross-lane warm start: seed each straggler from the nearest (by
        # q-distance) certified lane, in a separate array so z_out keeps
        # each lane's own iterate beside its own residual
        z_warm = z_out
        if idx.numel() and bool(conv_out.any()):
            conv_idx = torch.nonzero(conv_out)[:, 0]
            dist = (q[conv_idx][None, :, :] - q[idx][:, None, :]).norm(dim=2)
            j = conv_idx[dist.argmin(1)]
            far = resid_out[idx] > 1e-4
            z_warm = z_out.clone()
            z_warm[idx[far]] = z_out[j[far]]
    if idx.numel():
        # final tier: proximal Lemke pivoting on the stragglers, which ends on
        # an exact complementary basis where the smooth hybrid chases
        # residuals
        METRICS.bump("escalated_lanes", idx.numel())
        zL, rL = lemke.lemke_escalate(M[idx], q[idx], l[idx], u[idx],
                                      z_warm[idx], vm[idx], tol=tol)
        better = rL < resid_out[idx]
        z_out[idx[better]] = zL[better]
        resid_out[idx[better]] = rL[better]
        conv_out[idx] = resid_out[idx] <= tol
    return AVIResult(z=z_out, resid=resid_out, iters=iters_out,
                     converged=conv_out)


# --------------------------------------------------------------------------
#  Host-level single-problem wrappers (the reference's call pattern)
# --------------------------------------------------------------------------

def check_avi_solution(avi: AVI, z, w, tol: float = 1e-6):
    """Residual audit of a proposed AVI solution (avi.jl:148-156)."""
    z = np.asarray(z, dtype=np.float64)
    r = avi.M @ z + avi.N @ np.asarray(w, dtype=np.float64) + avi.o
    r_pos = r > tol
    r_neg = r < -tol
    bad = (np.sum(np.abs(z[r_pos] - avi.l[r_pos]) > tol)
           + np.sum(np.abs(z[r_neg] - avi.u[r_neg]) > tol)
           + np.sum(z - avi.l < -tol) + np.sum(z - avi.u > tol))
    return bad == 0, int(bad), r


def solve_avi(avi: AVI, z0, w, convergence_tolerance: float = 1e-10,
              num_restarts: int = 4, seed: int = 0):
    """Solve one AVI instance (avi.jl:63-77 semantics).

    Robustness via multi-start: the warm start, the origin and scaled random
    points solve as ONE batch on ``CONFIG.device`` (restart_limits=5 in the
    reference's PATH call plays the same role); the best iterate wins, and
    an unconverged best goes through proximal Lemke escalation.  The choice
    among the starts is host glue in numpy.  Returns (z, status) with
    SUCCESS iff the natural residual meets the tolerance AND the
    check_avi_solution audit passes."""
    w = np.asarray(w, dtype=np.float64)
    q = avi.N @ w + avi.o
    n = q.shape[0]
    rng = np.random.default_rng(seed)
    starts = [np.asarray(z0, dtype=np.float64), np.zeros(n)]
    scale = 1.0 + np.abs(np.asarray(z0)).max()
    for _ in range(max(0, num_restarts - 2)):
        starts.append(rng.standard_normal(n) * scale)
    Z0 = np.stack(starts)
    B = Z0.shape[0]
    dev = numeric_device()

    def rep(a):
        return torch.as_tensor(np.repeat(np.asarray(a)[None], B, axis=0),
                               dtype=torch.float64, device=dev)

    res = solve_avi_batch_padded(
        rep(avi.M), rep(q), rep(avi.l), rep(avi.u),
        torch.as_tensor(Z0, device=dev),
        torch.ones(B, n, dtype=torch.bool, device=dev),
        tol=convergence_tolerance, max_iter=4000)
    resid = res.resid.cpu().numpy()
    best = int(np.argmin(resid))
    z = res.z[best].cpu().numpy()
    ok = bool(res.converged[best])
    if not ok:
        # escalation tier: proximal Lemke pivoting — the problem class where
        # smooth methods stall (degenerate multi-player LP-KKT QEPs) is
        # exactly what the reference's PATH pivoting handles (avi.jl:63-77)
        zL, rL = lemke.lemke_escalate(
            rep(avi.M)[:1], rep(q)[:1], rep(avi.l)[:1], rep(avi.u)[:1],
            torch.as_tensor(z[None], device=dev),
            torch.ones(1, n, dtype=torch.bool, device=dev),
            tol=convergence_tolerance)
        rL0 = float(rL[0])
        if rL0 < resid[best]:
            z, ok = zL[0].cpu().numpy(), bool(rL0 <= convergence_tolerance)
    sol_ok, degree, _ = check_avi_solution(avi, z, w, tol=1e-6)
    status = Status.SUCCESS if (ok and sol_ok) else Status.FAILURE
    return z, status


def find_closest_feasible(gavi: GAVI, z0, w):
    """Presolve: project z0 onto the GAVI's second-block feasible set
    (avi.jl:79-99): min ‖z−z0‖² s.t. l2 ≤ Az + Bw ≤ u2."""
    n = len(z0)
    c = gavi.B @ np.asarray(w, dtype=np.float64)
    sol = batch_qp.solve_qp_np(
        np.eye(n), -np.asarray(z0, dtype=np.float64),
        gavi.A, gavi.l2 - c, gavi.u2 - c)
    if sol.status in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
        return np.asarray(sol.x)
    return np.asarray(z0, dtype=np.float64)


def solve_gavi(gavi: GAVI, z0, w, presolve: bool = True,
               convergence_tolerance: float = 1e-10):
    """GAVI solve via slack augmentation (avi.jl:101-111)."""
    z0 = np.asarray(z0, dtype=np.float64)
    if presolve:
        z0 = find_closest_feasible(gavi, z0, w)
    avi = convert_gavi(gavi)
    d1, d2 = gavi.d1, gavi.d2
    s = gavi.A @ z0 + gavi.B @ np.asarray(w, dtype=np.float64)
    z0s = np.concatenate([z0, s])
    z, status = solve_avi(avi, z0s, w, convergence_tolerance)
    return z[:d1 + d2], status


def relax_gavi(gavi: GAVI, relaxable_inds) -> GAVI:
    """Promote chosen parameters to free decision variables (avi.jl:130-146)."""
    relaxable_inds = list(relaxable_inds)
    mw = gavi.N.shape[1]
    param_inds = [i for i in range(mw) if i not in set(relaxable_inds)]
    d1, d2 = gavi.d1, gavi.d2
    dr = len(relaxable_inds)
    M = np.vstack([
        np.zeros((dr, d1 + d2 + dr)),
        np.hstack([gavi.N[:, relaxable_inds], gavi.M]),
    ])
    N = np.vstack([np.zeros((dr, len(param_inds))), gavi.N[:, param_inds]])
    o = np.concatenate([np.zeros(dr), gavi.o])
    l1 = np.concatenate([np.full(dr, -np.inf), gavi.l1])
    u1 = np.concatenate([np.full(dr, np.inf), gavi.u1])
    A = np.hstack([gavi.B[:, relaxable_inds], gavi.A])
    B = gavi.B[:, param_inds]
    return GAVI(M, N, o, l1, u1, A, B, gavi.l2, gavi.u2)
