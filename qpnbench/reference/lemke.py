"""Plain batched Lemke pivoting for box AVIs ``M z + q ⟂ l ≤ z ≤ u``, in
PyTorch, kept frozen with the benchmark.

It serves two ends, neither of them the program's: the fixed work of the
pivot kernel's roofline (the pivots it takes on a configuration's pool at
seed 0, counted once and written into the configuration's file), and the
control of the correctness check (this solve in float32 in the program's
place must come out not correct).

The method: every index i owns z_i, a lower slack and an upper slack, tied
by ``M z - u + v + c t = -q``; infinite bounds get synthetic boxes of
``1e4 · (1 + max |finite bound|)`` about the start; the artificial t enters
along the violated slack rows, and the complement of each exiting variable
enters next until t leaves (solved) or a ray appears.  Ties in the ratio
test are broken lexicographically over the tableau's -B⁻¹ block; an
entering variable that crosses its whole box flips bounds.  Lanes pivot in
lockstep, each until it finishes.
"""

from __future__ import annotations

import torch

SUCCESS, RAY, MAX_PIVOTS, SINGULAR = 1, 2, 3, 4
SYNTH_SCALE = 1e4
# the settings of a float32 pivot path (the KKT route's first stage), and
# of a float64 one
F32 = dict(tol=1e-6, piv_tol=1e-5)
F64 = dict(tol=1e-11, piv_tol=1e-11)


def max_pivots(n: int) -> int:
    """The pivot budget: the power of two from 256 up that reaches
    min(4096, 16 n + 256)."""
    b = 256
    while b < min(4096, 16 * n + 256):
        b *= 2
    return b


def _basic_values(T, basis, val):
    nb = val.scatter(1, basis, 0.0)
    return T[:, :, -1] - (T[:, :, :-1] @ nb[:, :, None])[:, :, 0]


def _pivot(T, row, col):
    r = torch.arange(T.shape[0], device=T.device)
    pr = T[r, row, :] / T[r, row, col][:, None]
    other = T[r, :, col].clone()
    other[r, row] = 0.0
    out = T - other[:, :, None] * pr[:, None, :]
    out[r, row, :] = pr
    return out


def _complement(exiting, exit_val, l, u, n):
    i = exiting % n
    lx = l.gather(1, i[:, None])[:, 0]
    ux = u.gather(1, i[:, None])[:, 0]
    is_z = exiting < n
    is_u = (exiting >= n) & (exiting < 2 * n)
    at_l = (exit_val - lx).abs() <= (exit_val - ux).abs()
    ent = torch.where(is_z, torch.where(at_l, n + i, 2 * n + i), i)
    one = torch.ones((), dtype=l.dtype, device=l.device)
    edir = torch.where(is_z | is_u, one, -one)
    ev = torch.where(is_z, 0.0, torch.where(is_u, lx, ux)).to(l.dtype)
    return ent, edir, ev


def _first_true(mask):
    n = mask.shape[1]
    idx = torch.where(mask, torch.arange(n, device=mask.device), n).amin(1)
    return torch.where(idx == n, 0, idx)


def _lex_refine(T, d, cand, need, piv_tol):
    n = T.shape[1]
    safe_d = torch.where(d.abs() > piv_tol, d, 1.0)
    for kk in range(n):
        if not bool(need.any()):
            break
        key = torch.where(cand, -T[:, :, n + kk] / safe_d, torch.inf)
        kmin = key.amin(1, keepdim=True)
        keep = cand & (key <= kmin + 1e-12 * (1.0 + kmin.abs()))
        cand = torch.where(need[:, None], keep, cand)
        need = need & (cand.sum(1) > 1)
    return cand


def solve(M, q, l, u, *, tol, piv_tol, max_pivots):
    """Pivot every lane from z = 0 in the dtype of ``q``.  M (B, n, n),
    q, l, u (B, n).  Returns (z, status, pivots), the pivots counting the
    covering one (0 for a lane solved at the start)."""
    B, n = q.shape
    dt, dev = q.dtype, q.device
    T_ID = 3 * n
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.full((), torch.inf, dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    M, l, u = M.to(dt), l.to(dt), u.to(dt)

    zc = torch.clamp(torch.zeros_like(q), l, u)
    fin_mag = torch.maximum(
        torch.where(torch.isfinite(l), l.abs(), zero).amax(1),
        torch.where(torch.isfinite(u), u.abs(), zero).amax(1))
    L = (SYNTH_SCALE * (1.0 + zc.abs().amax(1) + fin_mag))[:, None]
    l = torch.where(torch.isinf(l), zc - L, l)
    u = torch.where(torch.isinf(u), zc + L, u)
    pinned = (u - l) <= 0.0
    var_lb = torch.cat([l, torch.where(pinned, -inf, zero),
                        torch.zeros(B, n + 1, dtype=dt, device=dev)], 1)
    var_ub = torch.cat([u, inf.expand(B, 2 * n + 1)], 1)

    at_lower = (zc - l) <= (u - zc)
    ar = torch.arange(n, device=dev)
    basis = torch.where(at_lower, n + ar, 2 * n + ar)
    val = torch.cat([torch.where(at_lower, l, u),
                     torch.zeros(B, 2 * n + 1, dtype=dt, device=dev)], 1)
    sign = torch.where(at_lower, -1.0, 1.0).to(dt)
    T = sign[:, :, None] * torch.cat(
        [M, -eye.expand(B, n, n), eye.expand(B, n, n),
         torch.zeros(B, n, 1, dtype=dt, device=dev), -q[:, :, None]], 2)

    # the covering pivot: t enters along the violated rows
    xB = _basic_values(T, basis, val)
    viol = torch.clamp_min(var_lb.gather(1, basis) - xB, 0.0)
    thresh = tol * (1.0 + q.abs().amax(1) + xB.abs().amax(1))
    solved = viol.amax(1) <= thresh
    T[:, :, T_ID] = -(viol > thresh[:, None]).to(dt)
    j0 = viol.argmax(1)
    exiting = basis.gather(1, j0[:, None])
    exit_val = var_lb.gather(1, exiting)
    T1 = _pivot(T, j0, torch.full_like(j0, T_ID))
    val1 = val.scatter(1, exiting, exit_val)
    basis1 = basis.scatter(1, j0[:, None], T_ID)
    ent, edir, ev = _complement(exiting[:, 0], exit_val[:, 0], l, u, n)
    T[:, :, T_ID] = 0.0
    T = torch.where(solved[:, None, None], T, T1)
    basis = torch.where(solved[:, None], basis, basis1)
    val = torch.where(solved[:, None], val, val1)
    status = torch.where(solved, SUCCESS, 0)
    piv = torch.zeros(B, dtype=torch.int64, device=dev)

    for _ in range(1, max_pivots):
        lanes = torch.nonzero(status == 0)[:, 0]
        if lanes.numel() == 0:
            break
        r = torch.arange(lanes.numel(), device=dev)
        Ti, bi, ei = T[lanes], basis[lanes], ent[lanes]
        di, evi = edir[lanes], ev[lanes]
        vlb, vub = var_lb[lanes], var_ub[lanes]
        vi = val[lanes].index_put((r, ei), evi)
        xB = Ti[:, :, -1] - (Ti[:, :, :-1] @ vi[:, :, None])[:, :, 0]
        col = Ti[r, :, ei]
        d = di[:, None] * col
        theta = torch.where(
            d > piv_tol, (xB - vlb.gather(1, bi)) / d,
            torch.where(d < -piv_tol, (xB - vub.gather(1, bi)) / d, torch.inf))
        theta = torch.where(torch.isnan(theta), torch.inf,
                            theta).clamp_min(0.0)
        lb_e, ub_e = vlb[r, ei], vub[r, ei]
        theta_e = torch.where(di > 0, ub_e - evi, evi - lb_e)
        tstar = theta.amin(1)
        is_ray = ~torch.isfinite(tstar) & ~torch.isfinite(theta_e)
        flip = ~is_ray & (theta_e <= tstar)
        tie = theta <= (tstar + tol * (1.0 + tstar.abs()))[:, None]
        t_tie = tie & (bi == T_ID)
        pick_t = t_tie.any(1)
        cand = _lex_refine(Ti, d, tie,
                           ~pick_t & ~flip & ~is_ray & (tie.sum(1) > 1),
                           piv_tol)
        jstar = torch.where(pick_t, _first_true(t_tie), _first_true(cand))
        bad = col[r, jstar].abs() < piv_tol
        exiting = bi[r, jstar]
        exit_val = torch.where(d[r, jstar] > 0, vlb[r, exiting],
                               vub[r, exiting])
        pivot = ~is_ray & ~flip & ~bad
        p = torch.nonzero(pivot)[:, 0]
        if p.numel():
            T[lanes[p]] = _pivot(Ti[p], jstar[p], ei[p])
            basis[lanes[p], jstar[p]] = ei[p]
        v_flip = vi.index_put((r, ei), torch.where(di > 0, ub_e, lb_e))
        v_piv = vi.index_put((r, exiting), exit_val).index_put(
            (r, ei), torch.zeros_like(evi))
        val[lanes] = torch.where(pivot[:, None], v_piv,
                                 torch.where(flip[:, None], v_flip, vi))
        nent, ndir, nev = _complement(exiting, exit_val, l[lanes],
                                      u[lanes], n)
        ie = ei % n
        ent[lanes] = torch.where(pivot, nent, torch.where(
            flip, torch.where(di > 0, 2 * n + ie, n + ie), ei))
        edir[lanes] = torch.where(pivot, ndir,
                                  torch.where(flip, torch.ones_like(di), di))
        ev[lanes] = torch.where(pivot, nev,
                                torch.where(flip, torch.zeros_like(evi), evi))
        status[lanes] = torch.where(
            is_ray, RAY, torch.where(
                ~flip & bad, SINGULAR,
                torch.where(pivot & (exiting == T_ID), SUCCESS,
                            status[lanes])))
        piv[lanes] += (~is_ray & (flip | ~bad)).to(torch.int64)
    status = torch.where(status == 0, MAX_PIVOTS, status)
    xB = T[:, :, -1] - (T[:, :, :-1] @ val[:, :, None])[:, :, 0]
    z = torch.cat([val[:, :n], torch.zeros_like(val[:, :1])], 1)
    z.scatter_(1, torch.where(basis < n, basis, n), xB)
    pivots = torch.where(solved, 0, piv + 1)
    return z[:, :n], status, pivots
