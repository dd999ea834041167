"""Batched dense QP/LP solver (PyTorch port of ``qpn_tpu/ops/batch_qp.py``).

Every polyhedral query of the framework is phrased as a batch of small dense
QPs

    min ½ x'Px + q'x   s.t.  l ≤ Ax ≤ u

and solved by one batched OSQP-style ADMM: Ruiz equilibration, a batched
Cholesky of ``P + σI + ρ·A'diag(r)A`` per lane, adaptive ρ, primal and dual
infeasibility certificates, and a terminal active-set polish that recovers
~1e-10 accuracy (the reference's ``eps_abs=eps_rel=1e-8, polish=true``,
sets.jl:616-618).

Layout:

* :func:`solve_qp_batch` — the engine, on f64 tensors on any device.  The
  JAX package's ``lax.while_loop`` under ``vmap`` becomes a masked loop: a
  lane runs while it is under ``max_iter`` iterations and has no terminal
  status, so each lane's iterates and count are those of the JAX package's
  lane.  The host reads the masks once per ``check_every`` iterations.
  ``banded_k`` factors the x-update by cyclic reduction (``ops/banded.py``)
  for block-tridiagonal trajectory KKTs.
* :func:`solve_qp_batch_padded` and :func:`solve_qp_np` — the host wrappers
  (numpy in, numpy out) with the two-tier straggler re-solve and the banded
  route's detection; the work runs on ``CONFIG.device``.  Under a lockstep
  broker (``parallel/lockstep.py``) the call parks and fuses with the other
  scenarios' requests.

Dropped from the JAX package, as ROADMAP's rules say: the split-f32 products
of ``mixed`` (the port computes in f64; per lane, the JAX package's mixed
epochs of four check blocks give the iterates of its non-mixed ones), the QR
detour of the polish (the port takes an LU), bucket padding of the shapes
(padded rows and variables change no lane's numbers), the AOT cache and
small-dispatch placement.

Status codes mirror the OSQP codes the reference branches on
(qp_processing.jl:7, sets.jl:683-701): 1 solved, 2 solved-inaccurate,
-3 primal infeasible, -4 dual infeasible, 0 max-iter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG, banded_min_blocks, numeric_device
from ..utils.metrics import METRICS, lanes_where
from .banded import cr_factor, cr_solve, detect_banded_k, kkt_blocks
from .linalg import cholesky_solve

SOLVED = 1
SOLVED_INACCURATE = 2
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4
MAX_ITER = 0

_BIG = 1e20


class QPSolution(NamedTuple):
    x: object          # (B, n) primal
    y: object          # (B, m) dual (y>0 pushes on upper bound, y<0 on lower)
    z: object          # (B, m) projected Ax
    obj: object        # (B,) objective value
    status: object     # (B,) int32 status code
    prim_res: object
    dual_res: object
    iters: object


def _maxabs(t: torch.Tensor) -> torch.Tensor:
    """max |t| over the last axis with 0 as the initial value (NaN kept, as
    ``jnp.max(..., initial=0.0)`` keeps it)."""
    if t.shape[-1] == 0:
        return torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    return t.abs().amax(-1).clamp_min(0.0)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[:, :, None])[:, :, 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M.transpose(1, 2) @ v[:, :, None])[:, :, 0]


def _ruiz_equilibrate(P, A, row_mask, iters=10):
    """Modified Ruiz equilibration of the KKT data: diagonal D (variables) and
    E (rows) such that columns of [DPD; EAD] and rows of EAD have ~unit
    inf-norm, batched."""
    B, m, n = A.shape
    D = torch.ones(B, n, dtype=A.dtype, device=A.device)
    E = torch.ones(B, m, dtype=A.dtype, device=A.device)
    rm = row_mask.to(A.dtype)
    for _ in range(iters):
        Pn = (D[:, :, None] * P * D[:, None, :]).abs()
        An = (E[:, :, None] * A * D[:, None, :]).abs() * rm[:, :, None]
        col = Pn.amax(1)
        if m:
            col = torch.maximum(col, An.amax(1))
            row = An.amax(2)
            de = torch.where(row_mask, 1.0 / row.clamp(1e-8, 1e8).sqrt(), 1.0)
            E = E * de
        D = D * (1.0 / col.clamp(1e-8, 1e8).sqrt())
    return D, E


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; a lane whose K is not numerically positive
    definite gets NaN, as ``jnp.linalg.cholesky`` gives it."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[:, None, None], L, torch.nan)


class _Lanes:
    """The scaled problem data of a batch, indexable by a lane subset."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def take(self, idx: torch.Tensor) -> "_Lanes":
        return _Lanes(**{k: v[idx] for k, v in self.__dict__.items()})


class _DenseFactor:
    """Cholesky factors of the x-update's K(ρ) = P + σI + ρG, per lane."""

    def __init__(self, L):
        self.L = L

    def take(self, idx) -> "_DenseFactor":
        return _DenseFactor(self.L[idx])

    def assign(self, idx, other: "_DenseFactor") -> None:
        self.L[idx] = other.L

    def solve(self, rhs):
        return cholesky_solve(rhs[:, :, None], self.L)[:, :, 0]


class _BandedFactor:
    """Cyclic-reduction factors of a block-tridiagonal K(ρ) with k×k blocks
    (``ops/banded.py``), per lane."""

    def __init__(self, cr, k: int):
        self.cr, self.k = cr, k

    def take(self, idx) -> "_BandedFactor":
        return _BandedFactor(self.cr.take(idx), self.k)

    def assign(self, idx, other: "_BandedFactor") -> None:
        self.cr.assign(idx, other.cr)

    def solve(self, rhs):
        B, n = rhs.shape
        return cr_solve(self.cr, rhs.reshape(B, n // self.k,
                                             self.k)).reshape(B, n)


def _factor(K, banded_k: int):
    if banded_k:
        return _BandedFactor(cr_factor(*kkt_blocks(K, banded_k)), banded_k)
    return _DenseFactor(_cholesky(K))


def _iterate(d: _Lanes, L, R, x, z, y, dx, dy, *, sigma, alpha):
    """One ADMM iteration on every lane of ``d`` (``iter_once``)."""
    rhs = sigma * x - d.q + _mtv(d.A, R * z - y)
    x_new = L.solve(rhs)
    Ax = _mv(d.A, x_new)
    z_relaxed = alpha * Ax + (1 - alpha) * z
    z_try = z_relaxed + y / R
    z_new = torch.where(d.loose, z_try, torch.clamp(z_try, d.lc, d.uc))
    y_new = y + R * (z_relaxed - z_new)
    x_new = alpha * x_new + (1 - alpha) * x
    return (x_new, z_new, y_new, dx * 0.5 + (x_new - x),
            dy * 0.5 + (y_new - y))


def _residuals(d: _Lanes, x, z, y):
    Ax = _mv(d.A, x)
    Px = _mv(d.P, x)
    Aty = _mtv(d.A, y)
    prim = _maxabs((Ax - z) * d.rmf)
    dual = _maxabs(Px + d.q + Aty)
    prim_rel = torch.maximum(_maxabs(Ax * d.rmf), _maxabs(z * d.rmf))
    dual_rel = torch.maximum(_maxabs(Px),
                             torch.maximum(_maxabs(Aty), _maxabs(d.q)))
    return prim, dual, prim_rel, dual_rel


def _check_status(d: _Lanes, x, z, y, dx, dy, eps):
    """Residuals, termination flag and infeasibility certificates of every
    lane (``check_status``)."""
    prim, dual, prim_rel, dual_rel = _residuals(d, x, z, y)
    solved = (prim <= eps + eps * prim_rel) & (dual <= eps + eps * dual_rel)

    # primal infeasibility certificate on accumulated dy
    ny = _maxabs(dy)
    dyv = dy / ny.clamp_min(1e-30)[:, None]
    Atdy = _maxabs(_mtv(d.A, dyv))
    sup = torch.where(d.rm, d.uc * dyv.clamp_min(0)
                      + d.lc * dyv.clamp_max(0), 0.0).sum(1)
    pinf = (ny > 1e-12) & (Atdy <= 1e-6) & (sup <= -1e-6)

    # dual infeasibility certificate on accumulated dx
    nx = _maxabs(dx)
    dxv = dx / nx.clamp_min(1e-30)[:, None]
    Pdx = _maxabs(_mv(d.P, dxv))
    qdx = (d.q * dxv).sum(1)
    Adx = _mv(d.A, dxv)
    lf, uf = d.l_fin, d.u_fin
    ok_row = torch.where(lf & uf, Adx.abs() <= 1e-6,
                         torch.where(lf, Adx >= -1e-6,
                                     torch.where(uf, Adx <= 1e-6, True)))
    cone_ok = torch.where(d.rm, ok_row, True).all(1)
    dinf = (nx > 1e-12) & (Pdx <= 1e-6) & (qdx <= -1e-6) & cone_ok

    status = torch.where(solved, SOLVED,
                         torch.where(pinf, PRIMAL_INFEASIBLE,
                                     torch.where(dinf, DUAL_INFEASIBLE,
                                                 MAX_ITER)))
    return (status.to(torch.int32),
            torch.stack([prim, dual, prim_rel, dual_rel], 1))


def _polish(d0: _Lanes, x, z, y):
    """Active-set KKT refinement on the ORIGINAL data: the regularized KKT
    of the equality-constrained QP on the active rows,

        [P+δI  Aact'] [x]   [-q ]
        [Aact   -δI ] [ν] = [bnd],

    by LU with one step of iterative refinement; kept per lane where it is
    feasible and lowers prim+dual."""
    B, m, n = d0.A.shape
    dt, dev = x.dtype, x.device
    Ax = _mv(d0.A, x)
    act_l = d0.rm & ((y < -1e-9) | (Ax <= d0.lc + 1e-7))
    act_u = d0.rm & ((y > 1e-9) | (Ax >= d0.uc - 1e-7))
    act = act_l | act_u
    bnd = torch.where(act_l, d0.lc, d0.uc)
    Aw = d0.A * act.to(dt)[:, :, None]
    delta = 1e-9
    K = torch.zeros(B, n + m, n + m, dtype=dt, device=dev)
    K[:, :n, :n] = d0.P + delta * torch.eye(n, dtype=dt, device=dev)
    K[:, :n, n:] = Aw.transpose(1, 2)
    K[:, n:, :n] = Aw
    K[:, n:, n:] = -delta * torch.eye(m, dtype=dt, device=dev)
    rhs = torch.cat([-d0.q, torch.where(act, bnd, 0.0)], 1)
    # the batched LU waits on the card inside itself: a host sync
    LU, piv, _ = METRICS.sync(torch.linalg.lu_factor_ex, K)
    sol = torch.linalg.lu_solve(LU, piv, rhs[:, :, None])[:, :, 0]
    r = rhs - _mv(K, sol)
    sol = sol + torch.linalg.lu_solve(LU, piv, r[:, :, None])[:, :, 0]
    x_p = sol[:, :n]
    y_p = torch.where(act, sol[:, n:], 0.0)
    # dual-sign sanity: lower-active duals ≤ 0, upper-active ≥ 0
    y_p = torch.where(act_l & ~act_u, y_p.clamp_max(0.0), y_p)
    y_p = torch.where(act_u & ~act_l, y_p.clamp_min(0.0), y_p)
    Axp = _mv(d0.A, x_p)
    z_p = torch.clamp(Axp, d0.lc, d0.uc)
    prim_p, dual_p = _residuals(d0, x_p, z_p, y_p)[:2]
    prim_o, dual_o = _residuals(d0, x, z, y)[:2]
    feas_p = torch.where(d0.rm, (Axp >= d0.lc - 1e-7) & (Axp <= d0.uc + 1e-7),
                         True).all(1)
    better = feas_p & (prim_p + dual_p <= prim_o + dual_o)
    x = torch.where(better[:, None], x_p, x)
    y = torch.where(better[:, None], y_p, y)
    z = torch.where(better[:, None], torch.clamp(_mv(d0.A, x), d0.lc, d0.uc),
                    z)
    return x, z, y


def solve_qp_batch(P, q, A, l, u, row_mask, *, max_iter=4000, eps=1e-9,
                   rho0=0.1, sigma=1e-6, alpha=1.6, check_every=25,
                   banded_k=0, x_init=None, y_init=None,
                   polish=True) -> QPSolution:
    """Solve a batch of box-constrained QPs by ADMM, in f64 on the device of
    the inputs.

    Args: P (B,n,n), q (B,n), A (B,m,n), l/u (B,m), row_mask (B,m) bool;
    masked rows need a=0 (their bounds are ignored).  Returns a QPSolution
    of tensors.

    ``x_init`` (B,n) / ``y_init`` (B,m) start the iteration from a primal /
    dual estimate in the caller's coordinates; as in the JAX package, giving
    either one also starts z at the projection of A·x onto the bounds, where
    a call without them starts z at 0.  ``polish=False`` skips the terminal
    active-set polish for callers that certify by their own means (the
    shared-matrix route's ADMM rung).  ``banded_k`` (dividing n) factors
    the x-update by cyclic reduction over n/banded_k blocks, for KKTs that
    are block-tridiagonal in the given variable order
    (``banded.detect_banded_k``); 0 takes the dense Cholesky.

    Counts ``admm_calls``, ``admm_lanes`` and ``admm_blocks`` (blocks of
    ``check_every`` iterations, each a host read of the masks) in
    ``METRICS``."""
    f64 = torch.float64
    P, q, A, l, u = (t.to(f64) for t in (P, q, A, l, u))
    rm = row_mask.to(torch.bool)
    B, m, n = A.shape
    if banded_k and n % banded_k:
        raise ValueError(f"banded_k={banded_k} does not divide n={n}")
    dev = q.device
    rmf = rm.to(f64)

    # -------- Ruiz equilibration (scaled problem solved, unscaled returned) --
    Dsc, Esc = _ruiz_equilibrate(P, A, rm)
    Ps = Dsc[:, :, None] * P * Dsc[:, None, :]
    qs = Dsc * q
    As = Esc[:, :, None] * A * Dsc[:, None, :]
    ls = torch.where(torch.isfinite(l), Esc * l, l)
    us = torch.where(torch.isfinite(u), Esc * u, u)
    ls = torch.where(rm, ls, -torch.inf)
    us = torch.where(rm, us, torch.inf)
    lc = ls.clamp(-_BIG, _BIG)
    uc = us.clamp(-_BIG, _BIG)
    l_fin, u_fin = torch.isfinite(ls), torch.isfinite(us)
    eq = rm & ((uc - lc).abs() < 1e-10)
    loose = ~rm | (~l_fin & ~u_fin)
    # ρ enters K only as a scalar multiple of the constant Gram matrix
    # G = A'·diag(base)·A: K(ρ) = P + σI + ρG
    base_r = torch.where(loose, 1e-6, torch.where(eq, 1e3, 1.0)).to(f64)
    G = (As.transpose(1, 2) * base_r[:, None, :]) @ As
    K0 = Ps + sigma * torch.eye(n, dtype=f64, device=dev)
    d = _Lanes(P=Ps, q=qs, A=As, rm=rm, rmf=rmf, lc=lc, uc=uc, l_fin=l_fin,
               u_fin=u_fin, loose=loose, base_r=base_r)

    x = torch.zeros(B, n, dtype=f64, device=dev)
    z = torch.zeros(B, m, dtype=f64, device=dev)
    y = torch.zeros(B, m, dtype=f64, device=dev)
    if x_init is not None or y_init is not None:
        # warm start in scaled coordinates (x = Dsc·x̂, y = Esc·ŷ)
        if x_init is not None:
            x = x_init.to(f64) / Dsc
        z = torch.clamp(_mv(As, x), lc, uc)
        if y_init is not None:
            y = y_init.to(f64) / torch.where(Esc == 0, 1.0, Esc)

    adapt_every = max(100 // check_every, 1) * check_every
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    rho = torch.full((B,), float(rho0), dtype=f64, device=dev)
    status = torch.full((B,), MAX_ITER, dtype=torch.int32, device=dev)
    dx = torch.zeros(B, n, dtype=f64, device=dev)
    dy = torch.zeros(B, m, dtype=f64, device=dev)
    # the factor depends on ρ alone: it is recomputed only for lanes whose
    # ρ moved (the same factor the JAX package recomputes every epoch)
    L = _factor(K0 + rho[:, None, None] * G, banded_k)
    METRICS.bump("admm_calls")
    METRICS.bump("admm_lanes", B)

    while True:
        lanes = lanes_where((k < max_iter) & (status == MAX_ITER))
        if lanes.numel() == 0:
            break
        # one block: check_every iterations and a status check
        METRICS.bump("admm_blocks")
        ds = d.take(lanes)
        Ls = L.take(lanes)
        R = rho[lanes][:, None] * ds.base_r
        xs, zs, ys, dxs, dys = x[lanes], z[lanes], y[lanes], dx[lanes], \
            dy[lanes]
        for _ in range(check_every):
            xs, zs, ys, dxs, dys = _iterate(ds, Ls, R, xs, zs, ys, dxs, dys,
                                            sigma=sigma, alpha=alpha)
        st, prs = _check_status(ds, xs, zs, ys, dxs, dys, eps)
        x[lanes], z[lanes], y[lanes], dx[lanes], dy[lanes] = (xs, zs, ys,
                                                              dxs, dys)
        status[lanes] = st
        k[lanes] += check_every
        # adaptive ρ on residual balance at the adapt boundary, applied only
        # when the ratio moved 5x
        prim, dual, prim_rel, dual_rel = prs.unbind(1)
        ratio = torch.sqrt((prim / prim_rel.clamp_min(1e-12))
                           / (dual / dual_rel.clamp_min(1e-12)).clamp_min(
                               1e-12))
        rl, kl = rho[lanes], k[lanes]
        rho_new = (rl * ratio).clamp(1e-6, 1e6)
        allowed = (kl % adapt_every == 0) & (kl - check_every
                                             < max_iter // 2)
        big_change = (rho_new > 5 * rl) | (rho_new < rl / 5)
        moved = lanes_where(allowed & big_change & (st == MAX_ITER))
        if moved.numel():
            mv = lanes[moved]
            rho[mv] = rho_new[moved]
            L.assign(mv, _factor(K0[mv] + rho[mv][:, None, None] * G[mv],
                                 banded_k))

    # -------- unscale back to the original problem ------------------------
    x = Dsc * x
    y = Esc * y
    lc0 = torch.where(rm, l, -torch.inf).clamp(-_BIG, _BIG)
    uc0 = torch.where(rm, u, torch.inf).clamp(-_BIG, _BIG)
    d0 = _Lanes(P=P, q=q, A=A, rm=rm, rmf=rmf, lc=lc0, uc=uc0)
    z = torch.clamp(_mv(A, x), lc0, uc0)
    prim, dual = _residuals(d0, x, z, y)[:2]
    do = lanes_where((status == SOLVED) | ((prim <= 1e-3) & (dual <= 1e-3)))
    if polish and do.numel():
        x[do], z[do], y[do] = _polish(d0.take(do), x[do], z[do], y[do])
    prim, dual = _residuals(d0, x, z, y)[:2]
    good = (prim <= 1e-6) & (dual <= 1e-6)
    okish = (prim <= 1e-4) & (dual <= 1e-4)
    # the in-loop check passes on SCALED residuals; reclassify every
    # solved-like lane against the unscaled ones.  Infeasibility
    # certificates are untouched.
    solved_like = (status == SOLVED) | (status == MAX_ITER)
    status = torch.where(solved_like & good, SOLVED,
                         torch.where(solved_like & okish, SOLVED_INACCURATE,
                                     torch.where(status == SOLVED, MAX_ITER,
                                                 status))).to(torch.int32)
    obj = 0.5 * (x * _mv(P, x)).sum(1) + (q * x).sum(1)
    return QPSolution(x=x, y=y, z=z, obj=obj, status=status, prim_res=prim,
                      dual_res=dual, iters=k)


def _solve_on_device(P, q, A, l, u, row_mask, **kw) -> QPSolution:
    """Move host arrays to ``CONFIG.device``, solve, return numpy."""
    dev = numeric_device()
    args = [torch.as_tensor(a, dtype=torch.float64, device=dev)
            for a in (P, q, A, l, u)]
    rm = torch.as_tensor(row_mask, dtype=torch.bool, device=dev)
    return QPSolution(*(v.cpu().numpy()
                        for v in solve_qp_batch(*args, rm, **kw)))


def solve_qp_batch_padded(P, q, A, l, u, row_mask, _no_lemke=False,
                          _no_broker=False, _sharding=None, _min_batch=1,
                          _prefer_lemke=False, **kw) -> QPSolution:
    """Host wrapper of :func:`solve_qp_batch`: numpy in, numpy out, the work
    on ``CONFIG.device``, at exact shapes.

    Under a lockstep broker (``parallel/lockstep.py``) the call parks and
    fuses with the other scenarios' requests; the broker's fused dispatch
    passes ``_no_broker=True``.

    Pure LPs (P = 0) route to the exact Lemke pivot engine when
    ``CONFIG.lp_engine`` is "lemke" or when ``_prefer_lemke``; uncertified
    lanes fall back to ADMM there.

    Two-tier straggler re-solve: unless the caller sets ``max_iter``, every
    lane first runs ``CONFIG.admm_tier1_iters`` iterations; lanes that used
    them all (including those the post-loop ladder upgraded on 1e-4/1e-6
    residuals) re-solve from scratch with the full 4000-iteration budget, so
    the outcome is that of one full-budget call.

    Trajectory structure: with ``CONFIG.banded_auto``, a QP batch of at
    least ``CONFIG.banded_auto_min_n`` variables whose P and A'A patterns
    are block-tridiagonal with at least ``config.banded_min_blocks()``
    blocks takes the cyclic-reduction x-update (counter ``banded_route``).
    The port runs at exact n always, which is what that route needs.

    ``_sharding`` (``parallel.mesh.scenario_sharding``; every rank makes the
    same call) splits the batch over the mesh's ranks after the whole
    batch's routing is decided (Lemke LP route, banded route): padded to a
    multiple of the rank count and at least ``_min_batch`` lanes with inert
    lanes (P = I, or 0 on the LP route; q = 0, A = 0, l = −∞, u = +∞, rows
    masked off), this rank's block solved (both tiers), the results
    gathered and the padding sliced off; numpy, full on every rank."""
    if not _no_broker:
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("qp", P, q, A, l, u, row_mask,
                             _no_lemke=_no_lemke,
                             _prefer_lemke=_prefer_lemke, **kw)
    P = np.asarray(P, dtype=np.float64)
    lemke = (not _no_lemke and (CONFIG.lp_engine == "lemke" or _prefer_lemke)
             and not kw and P.size and not P.any())
    if lemke and _sharding is None:
        from .lemke import solve_lp_lemke_batch
        return solve_lp_lemke_batch(q, A, l, u, row_mask)
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B, m, n = A.shape
    if (not lemke and CONFIG.banded_auto and "banded_k" not in kw
            and n >= CONFIG.banded_auto_min_n and P.any()):
        min_blocks = banded_min_blocks()
        bk = detect_banded_k(P, A, min_blocks=min_blocks) if min_blocks else 0
        if bk:
            kw["banded_k"] = bk
            METRICS.bump("banded_route", B)
    if _sharding is not None:
        from ..parallel.mesh import call_sharded

        def inert(k):
            eye = np.zeros((n, n)) if lemke else np.eye(n)
            return (np.repeat(eye[None], k, 0), np.zeros((k, n)),
                    np.zeros((k, m, n)), np.full((k, m), -np.inf),
                    np.full((k, m), np.inf), np.zeros((k, m), dtype=bool))

        return call_sharded(
            _sharding,
            lambda *a: solve_qp_batch_padded(
                *a, _no_lemke=not lemke, _no_broker=True,
                _prefer_lemke=_prefer_lemke, **kw),
            (P, q, A, l, u, row_mask), inert, _min_batch)
    tier1 = CONFIG.admm_tier1_iters
    if "max_iter" not in kw and tier1 > 0:
        # tier 1: short lockstep pass — most lanes converge well inside it
        sol = _solve_on_device(P, q, A, l, u, row_mask, max_iter=tier1, **kw)
        bad = np.nonzero(sol.iters >= tier1)[0]
        if bad.size == 0:
            return sol
        # tier 2: full budget for the stragglers only
        sub = solve_qp_batch_padded(
            P[bad], q[bad], A[bad], l[bad], u[bad], row_mask[bad],
            _no_lemke=_no_lemke, _no_broker=True, max_iter=4000, **kw)
        out = {f: getattr(sol, f).copy() for f in sol._fields}
        for f in sol._fields:
            out[f][bad] = getattr(sub, f)
        out["iters"][bad] += tier1
        return QPSolution(**out)
    return _solve_on_device(P, q, A, l, u, row_mask, **kw)


def solve_qp_np(P, q, A, l, u, row_mask=None, **kw) -> QPSolution:
    """Convenience single-problem host wrapper returning numpy results."""
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    if row_mask is None:
        row_mask = np.ones(l.shape[0], dtype=bool)
    sol = solve_qp_batch_padded(P[None], q[None], A[None], l[None], u[None],
                                np.asarray(row_mask)[None], **kw)
    return QPSolution(*(np.asarray(v[0]) for v in sol))
