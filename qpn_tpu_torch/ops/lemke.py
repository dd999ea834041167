"""Batched Lemke-style complementary pivoting for box AVIs (PyTorch port of
``qpn_tpu/ops/lemke.py``).

The box AVI  ``M z + q ⟂ l ≤ z ≤ u``  is pivoted directly: every index ``i``
owns three candidate variables — ``z_i`` (basic when strictly between
bounds), a lower slack ``u_i ≥ 0`` and an upper slack ``v_i ≥ 0`` — tied by
the tableau equation ``M z − u + v + c·t = −q``.  The artificial ``t``
enters first along a covering direction that lifts exactly the infeasible
slack rows; Lemke's almost-complementary path is then followed (the
complement of the exiting variable enters; entering variables that span
their whole box bound-flip to their opposite slack) until ``t`` exits
(SUCCESS) or a ray is found.  Degeneracy is resolved by the lexicographic
ratio test over the ``−B⁻¹`` block that the tableau carries in its
u-columns.

Layout of the port:

* :func:`solve_lemke_np` — the numpy single-instance oracle, copied.
* :func:`lemke_setup` — everything before the pivot loop, batched in torch
  on the tensors' device (masking, synthetic boxes, slack basis, covering
  pivot).
* The pivot loop, in two engines with one contract (:class:`LemkeInit` in,
  :class:`PivotResult` out): :func:`lemke_pivot_torch`, the plain batched
  PyTorch loop, and ``ops/lemke_cuda.lemke_pivot_cuda``, the hand-written
  Hopper kernel (one thread block per lane, tableau in shared memory).
* :func:`solve_lemke_batch_state` / :func:`solve_lemke_batch_state_auto` —
  setup, pivot loop, z extraction; ``_auto`` picks the engine from
  ``CONFIG.lemke_kernel`` and the tensors' device.
  :func:`solve_lemke_batch` is the public ``(z, status, pivots)`` view
  (:class:`LemkeResult`).
* :func:`refactor_batch` — the f64 terminal refactorization, batched on the
  tensors' device (the JAX package does it on the host in numpy).
* :func:`solve_lemke_batch_padded` and :func:`lemke_escalate` — the f64
  pivot solve and the proximal-Lemke escalation tier of the generic
  adaptive solver (``ops/avi.solve_avi_batch_adaptive``).
* The LP engines of the geometry layer, on the LP's KKT AVI (numpy in,
  ``batch_qp.QPSolution`` of numpy out): :func:`solve_lp_host_batch` (the
  native C++ pivot loop at exact shapes) and :func:`solve_lp_lemke_batch`
  (the batched engine above on ``CONFIG.device``, K1 for CUDA); both audit
  every lane (:func:`_classify_lp_pivot`) and hand uncertified lanes to
  the ADMM engine.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import CONFIG, bucket, numeric_device
from ..utils.metrics import METRICS, lanes_where

_INF = np.inf

LEMKE_SUCCESS = 1
LEMKE_RAY = 2
LEMKE_MAX = 3
LEMKE_SINGULAR = 4

# scale of the synthetic big-M boxes on infinite bounds (see synth_bounds);
# every caller of the JAX package's batched engines uses this value
SYNTH_SCALE = 1e4


# --------------------------------------------------------------------------
#  Host (numpy) reference implementation — the single-instance oracle
# --------------------------------------------------------------------------

def synth_bounds(l, u, z0, synth_scale):
    """Cap infinite bounds with synthetic big-M boxes centered at the start.

    With every variable boxed, the initial Lemke basis is pure slack (∓I,
    always invertible — the structurally singular free/free saddle blocks of
    equilibrium KKT systems never enter a factorization) and the PRIMAL
    iterates stay in a compact box.  Ray termination is still possible
    (rarely — measured ~3% on adversarial degenerate M): entering SLACKS
    keep an infinite upper bound, so an all-infinite ratio column can occur
    on rank-deficient/indefinite M even inside the box; callers must treat
    LEMKE_RAY as a normal failure status, never as unreachable.  A solution
    pressed against a synthetic bound is NOT a solution of the original AVI;
    callers audit against the true bounds and retry with a larger box (see
    lemke_escalate).
    """
    ref = np.clip(np.nan_to_num(np.clip(np.nan_to_num(z0), l, u)),
                  -1e12, 1e12)
    fin = np.concatenate([l[np.isfinite(l)], u[np.isfinite(u)]])
    L = synth_scale * (1.0 + np.abs(ref).max(initial=0.0)
                       + (np.abs(fin).max() if fin.size else 0.0))
    l_eff = np.where(np.isinf(l), ref - L, l)
    u_eff = np.where(np.isinf(u), ref + L, u)
    return l_eff, u_eff, L


def solve_lemke_np(M, q, l, u, z0=None, tol=1e-9, piv_tol=1e-11,
                   max_pivots=None, synth_scale=1e4, cover="viol",
                   at_lower=None):
    """Single-instance box-AVI complementary pivoting (host reference).

    Returns ``(z, status, pivots)``.  ``status == LEMKE_SUCCESS`` means an
    exact complementary basis was reached *for the synthetically boxed
    problem*; the caller should audit the natural residual against the true
    bounds (matching the reference's own ``check_avi_solution`` discipline,
    avi.jl:148-156) — a solution pressed against a synthetic bound fails it.
    """
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    l_orig = np.asarray(l, dtype=np.float64)
    u_orig = np.asarray(u, dtype=np.float64)
    n = q.shape[0]
    if max_pivots is None:
        max_pivots = max(400, 20 * n)
    if z0 is None:
        z0 = np.zeros(n)
    zc = np.clip(np.nan_to_num(np.asarray(z0, dtype=np.float64)),
                 l_orig, u_orig)
    zc = np.clip(np.nan_to_num(zc), -1e12, 1e12)

    l_eff, u_eff, _L = synth_bounds(l_orig, u_orig, zc, synth_scale)
    l, u = l_eff, u_eff
    pinned = (u - l) <= 0.0

    # variable id map: z_i = i, u_i = n+i, v_i = 2n+i, t = 3n
    T_ID = 3 * n
    var_lb = np.empty(3 * n + 1)
    var_ub = np.empty(3 * n + 1)
    var_lb[:n], var_ub[:n] = l, u
    var_lb[n:2 * n] = np.where(pinned, -_INF, 0.0)   # pinned slack sign-free
    var_ub[n:2 * n] = _INF
    var_lb[2 * n:3 * n] = 0.0
    var_ub[2 * n:3 * n] = _INF
    var_lb[T_ID], var_ub[T_ID] = 0.0, _INF

    # nonbasic z start at the bound nearest to z0; slack basic = ∓row
    if at_lower is None:
        at_lower = (zc - l) <= (u - zc)
    start_val = np.where(at_lower, l, u)

    basis = np.where(at_lower, n + np.arange(n), 2 * n + np.arange(n))
    val = np.zeros(3 * n + 1)
    val[:n] = start_val

    # initial basis is ∓I — premultiplication is a row sign flip, no solve
    sign = np.where(at_lower, -1.0, 1.0)
    T = sign[:, None] * np.concatenate(
        [M, -np.eye(n), np.eye(n), np.zeros((n, 1)), -q[:, None]], axis=1)

    def basic_values():
        nb = val.copy()
        nb[basis] = 0.0
        return T[:, -1] - T[:, :3 * n + 1] @ nb

    xB = basic_values()
    blb = var_lb[basis]
    viol = np.maximum(blb - xB, 0.0)
    scale = 1.0 + np.abs(q).max(initial=0.0) + np.abs(xB).max(initial=0.0)
    if viol.max(initial=0.0) <= tol * scale:
        return _extract_np(n, basis, val, xB), LEMKE_SUCCESS, 0

    # --- first pivot: t enters along the covering direction --------------
    if cover == "all":
        s = np.ones(n)            # classic Lemke covering (different path)
    else:
        s = (viol > tol * scale).astype(np.float64)
    T[:, T_ID] = -s
    jstar = int(np.argmax(viol))
    if abs(T[jstar, T_ID]) < piv_tol:
        return zc, LEMKE_SINGULAR, 0
    exiting = int(basis[jstar])
    val[exiting] = var_lb[exiting]        # exits at the bound it violated
    _pivot_np(T, jstar, T_ID)
    basis[jstar] = T_ID
    val[T_ID] = 0.0

    entering, ent_dir, ent_val = _complement_np(exiting, val, l, u, n)

    pivots = 1
    while pivots < max_pivots:
        val[entering] = ent_val
        nb = val.copy()
        nb[basis] = 0.0
        xB = T[:, -1] - T[:, :3 * n + 1] @ nb
        d = ent_dir * T[:, entering]
        blb = var_lb[basis]
        bub = var_ub[basis]
        with np.errstate(divide="ignore", invalid="ignore"):
            theta = np.where(d > piv_tol, (xB - blb) / d,
                             np.where(d < -piv_tol, (xB - bub) / d, _INF))
        theta = np.where(np.isnan(theta), _INF, np.maximum(theta, 0.0))
        # entering variable's own range (bound flip)
        if ent_dir > 0:
            theta_e = var_ub[entering] - ent_val
        else:
            theta_e = ent_val - var_lb[entering]
        tstar = theta.min(initial=_INF)

        if not np.isfinite(tstar) and not np.isfinite(theta_e):
            return (_extract_np(n, basis, val, xB), LEMKE_RAY, pivots)

        if theta_e <= tstar:                       # bound flip
            newv = (var_ub[entering] if ent_dir > 0 else var_lb[entering])
            val[entering] = newv
            i = entering % n
            if ent_dir > 0:        # z_i reached its upper bound
                entering, ent_dir, ent_val = 2 * n + i, 1.0, 0.0
            else:                  # z_i reached its lower bound
                entering, ent_dir, ent_val = n + i, 1.0, 0.0
            pivots += 1
            continue

        # lexicographic tie-break over -B^{-1} (the u-column block)
        ties = np.nonzero(theta <= tstar + tol * (1.0 + abs(tstar)))[0]
        if len(ties) > 1:
            trow = np.nonzero(basis == T_ID)[0]
            if len(trow) and trow[0] in ties:
                jstar = int(trow[0])               # let t exit: terminate
            else:
                cand = ties
                for k in range(n):
                    key = -T[cand, n + k] / d[cand]
                    kmin = key.min()
                    cand = cand[key <= kmin + 1e-12 * (1.0 + abs(kmin))]
                    if len(cand) == 1:
                        break
                jstar = int(cand[0])
        else:
            jstar = int(ties[0])

        if abs(T[jstar, entering]) < piv_tol:
            # numerically unusable pivot: treat as ray/abort
            return (_extract_np(n, basis, val, xB), LEMKE_SINGULAR, pivots)

        exiting = int(basis[jstar])
        hit_lower = d[jstar] > 0
        val[exiting] = var_lb[exiting] if hit_lower else var_ub[exiting]
        _pivot_np(T, jstar, entering)
        basis[jstar] = entering
        val[entering] = 0.0
        pivots += 1

        if exiting == T_ID:
            xB = _refactor_np(M, q, basis, val, n)
            if xB is None:
                nb = val.copy()
                nb[basis] = 0.0
                xB = T[:, -1] - T[:, :3 * n + 1] @ nb
            return (_extract_np(n, basis, val, xB), LEMKE_SUCCESS, pivots)

        entering, ent_dir, ent_val = _complement_np(exiting, val, l, u, n)

    nb = val.copy()
    nb[basis] = 0.0
    xB = T[:, -1] - T[:, :3 * n + 1] @ nb
    return _extract_np(n, basis, val, xB), LEMKE_MAX, pivots


def _refactor_np(M, q, basis, val, n):
    """Recompute basic values from the original data at the terminal basis
    (kills accumulated rank-1 pivot drift); None if the basis is singular."""
    Bmat = np.zeros((n, n))
    for j, var in enumerate(basis):
        if var < n:
            Bmat[:, j] = M[:, var]
        elif var < 2 * n:
            Bmat[var - n, j] = -1.0
        elif var < 3 * n:
            Bmat[var - 2 * n, j] = 1.0
        else:
            return None            # t still basic
    nb = val.copy()
    nb[basis] = 0.0
    rhs = -q - M @ nb[:n] + nb[n:2 * n] - nb[2 * n:3 * n]
    try:
        xB = np.linalg.solve(Bmat, rhs)
    except np.linalg.LinAlgError:
        return None
    return xB if np.all(np.isfinite(xB)) else None


def _pivot_np(T, row, col):
    T[row, :] = T[row, :] / T[row, col]
    other = T[:, col].copy()
    other[row] = 0.0
    T -= np.outer(other, T[row, :])


def _complement_np(exiting, val, l, u, n):
    """Lemke rule: the complement of the exiting variable drives next."""
    i = exiting % n
    if exiting < n:                      # z_i exited at a bound
        at_l = abs(val[exiting] - l[i]) <= abs(val[exiting] - u[i])
        return (n + i, 1.0, 0.0) if at_l else (2 * n + i, 1.0, 0.0)
    if exiting < 2 * n:                  # u_i exited → z_i rises from l_i
        return i, 1.0, l[i]
    return i, -1.0, u[i]                 # v_i exited → z_i falls from u_i


def _extract_np(n, basis, val, xB):
    z = val[:n].copy()
    rows = np.nonzero(basis < n)[0]
    z[basis[rows]] = xB[rows]
    return z


# --------------------------------------------------------------------------
#  Batched torch engine
# --------------------------------------------------------------------------

class LemkeInit(NamedTuple):
    """Start state of the pivot loop for a batch of B lanes of size n.

    Produced by :func:`lemke_setup`; both pivot engines take it, so they
    start every lane from the identical covering pivot."""
    T: torch.Tensor        # (B, n, 3n+2) tableau: columns z|u|v|t, then rhs
    basis: torch.Tensor    # (B, n) int32 basic variable of each row
    val: torch.Tensor      # (B, 3n+1) nonbasic values (0 at basic ids)
    ent: torch.Tensor      # (B,) int32 entering variable id
    edir: torch.Tensor     # (B,) entering direction, ±1
    ev: torch.Tensor       # (B,) entering start value
    status: torch.Tensor   # (B,) int32: 0 = pivot; LEMKE_SUCCESS = solved
    var_lb: torch.Tensor   # (B, 3n+1) variable bounds (±inf kept)
    var_ub: torch.Tensor   # (B, 3n+1)
    l_eff: torch.Tensor    # (B, n) synthetically boxed bounds
    u_eff: torch.Tensor    # (B, n)


class PivotResult(NamedTuple):
    """End state of the pivot loop, per lane."""
    xB: torch.Tensor       # (B, n) basic values from the final tableau
    basis: torch.Tensor    # (B, n) int32 terminal basis
    val: torch.Tensor      # (B, 3n+1) terminal nonbasic values
    piv: torch.Tensor      # (B,) int32 pivots in the loop (no covering one)
    status: torch.Tensor   # (B,) int32 LEMKE_*


def lemke_setup(M, q, l, u, z0, var_mask, *, tol, synth_scale=SYNTH_SCALE,
                cover: str = "viol") -> LemkeInit:
    """Everything before the pivot loop, batched: masking, synthetic boxes
    (``synth_scale``), slack basis, covering direction (the violated rows,
    or every row with ``cover="all"``, the classic Lemke covering), first
    pivot (t enters).

    Shapes: M (B,n,n); q/l/u/z0 (B,n) of one float dtype; var_mask (B,n)
    bool.  Lanes solved at the start keep the slack basis and the
    pre-pivot tableau (t column zeroed) with status LEMKE_SUCCESS."""
    B, n = q.shape
    dt, dev = q.dtype, q.device
    T_ID = 3 * n
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.full((), _INF, dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    vm = var_mask.to(torch.bool)

    # padded variables become pinned-at-zero rows with identity diagonal
    M = torch.where(vm[:, :, None] & vm[:, None, :], M, eye)
    q = torch.where(vm, q, zero)
    l = torch.where(vm, l, zero)
    u = torch.where(vm, u, zero)

    # synthetic big-M boxes on infinite bounds (see synth_bounds)
    zc = torch.nan_to_num(torch.clamp(torch.nan_to_num(z0), l, u))
    zc = zc.clamp(-1e12, 1e12)
    fin_mag = torch.maximum(
        torch.where(torch.isfinite(l), l.abs(), zero).amax(1),
        torch.where(torch.isfinite(u), u.abs(), zero).amax(1))
    L = (synth_scale * (1.0 + zc.abs().amax(1) + fin_mag))[:, None]
    l = torch.where(torch.isinf(l), zc - L, l)
    u = torch.where(torch.isinf(u), zc + L, u)
    pinned = (u - l) <= 0.0

    var_lb = torch.cat([l, torch.where(pinned, -inf, zero),
                        torch.zeros(B, n + 1, dtype=dt, device=dev)], 1)
    var_ub = torch.cat([u, inf.expand(B, 2 * n + 1)], 1)

    at_lower = (zc - l) <= (u - zc)
    ar = torch.arange(n, device=dev)
    basis0 = torch.where(at_lower, n + ar, 2 * n + ar)
    val0 = torch.cat([torch.where(at_lower, l, u),
                      torch.zeros(B, 2 * n + 1, dtype=dt, device=dev)], 1)

    # initial basis is ∓I — premultiplication is a row sign flip, no solve
    sign = torch.where(at_lower, -1.0, 1.0).to(dt)
    T0 = sign[:, :, None] * torch.cat(
        [M, -eye.expand(B, n, n), eye.expand(B, n, n),
         torch.zeros(B, n, 1, dtype=dt, device=dev), -q[:, :, None]], 2)

    xB0 = _basic_values(T0, basis0, val0)
    viol = torch.clamp_min(var_lb.gather(1, basis0) - xB0, 0.0)
    thresh = tol * (1.0 + q.abs().amax(1) + xB0.abs().amax(1))
    solved = viol.amax(1) <= thresh

    # --- first pivot: t enters along the covering direction --------------
    if cover == "all":
        T0[:, :, T_ID] = -1.0
    else:
        T0[:, :, T_ID] = -(viol > thresh[:, None]).to(dt)
    j0 = viol.argmax(1)
    exiting0 = basis0.gather(1, j0[:, None])
    exit_val0 = var_lb.gather(1, exiting0)
    val1 = val0.scatter(1, exiting0, exit_val0)
    T1 = _pivot_rows(T0, j0, torch.full_like(j0, T_ID))
    basis1 = basis0.scatter(1, j0[:, None], T_ID)
    ent0, dir0, ev0 = _complement(exiting0[:, 0], exit_val0[:, 0], l, u, n)

    # lanes solved at the start keep the pre-pivot tableau, t column zeroed
    T0[:, :, T_ID] = 0.0
    s2, s3 = solved[:, None], solved[:, None, None]
    return LemkeInit(
        T=torch.where(s3, T0, T1),
        basis=torch.where(s2, basis0, basis1).to(torch.int32),
        val=torch.where(s2, val0, val1),
        ent=ent0.to(torch.int32), edir=dir0, ev=ev0,
        status=torch.where(solved, LEMKE_SUCCESS, 0).to(torch.int32),
        var_lb=var_lb, var_ub=var_ub, l_eff=l, u_eff=u)


def _basic_values(T, basis, val):
    """xB = rhs − T[:, :, :3n+1] @ nb, nb = val with basic entries zeroed."""
    nb = val.scatter(1, basis.long(), 0.0)
    return T[:, :, -1] - (T[:, :, :-1] @ nb[:, :, None])[:, :, 0]


def _pivot_rows(T, row, col):
    """Batched pivot of lane b on (row[b], col[b]): a rank-1 update."""
    r = torch.arange(T.shape[0], device=T.device)
    pr = T[r, row, :] / T[r, row, col][:, None]
    # a zero on the device: a Python 0.0 is copied to the card, a host sync
    other = T[r, :, col].index_put((r, row), T.new_zeros(()))
    out = T - other[:, :, None] * pr[:, None, :]
    out[r, row, :] = pr
    return out


def _complement(exiting, exit_val, l, u, n):
    """Lemke rule, batched: the complement of the exiting variable enters.
    Returns (entering id, direction, start value) per lane."""
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
    """Index of the first True per row; 0 where there is none (the
    ``jnp.argmax`` convention of the JAX engine)."""
    n = mask.shape[1]
    idx = torch.where(mask, torch.arange(n, device=mask.device), n).amin(1)
    return torch.where(idx == n, 0, idx)


def _lex_refine(T, d, cand, need, piv_tol):
    """Lexicographic refinement of the tied rows over the −B⁻¹ block
    (u-columns), for the lanes flagged in ``need``; early exit once every
    such lane has a unique candidate."""
    n = T.shape[1]
    safe_d = torch.where(d.abs() > piv_tol, d, 1.0)
    for kk in range(n):
        if not METRICS.sync(bool, need.any()):
            break
        key = torch.where(cand, -T[:, :, n + kk] / safe_d, _INF)
        kmin = key.amin(1, keepdim=True)
        keep = cand & (key <= kmin + 1e-12 * (1.0 + kmin.abs()))
        cand = torch.where(need[:, None], keep, cand)
        need = need & (cand.sum(1) > 1)
    return cand


def lemke_pivot_torch(init: LemkeInit, *, tol, piv_tol,
                      max_pivots) -> PivotResult:
    """The pivot loop in plain batched PyTorch (the engine for CPU tensors,
    and the version the CUDA kernel is held against).

    A batched rewrite of the JAX lane body (``qpn_tpu/ops/lemke.py``
    ``_lemke_single``) with per-lane done masks: each iteration works on the
    lanes still pivoting.  The iteration counter starts at 1 and the loop
    runs while it is below ``max_pivots``; a terminating ray or singular
    step counts no pivot."""
    T = init.T.clone()
    B, n, W = T.shape
    T_ID = 3 * n
    dev = T.device
    basis = init.basis.long()
    val = init.val.clone()
    ent = init.ent.long()
    edir, ev = init.edir.clone(), init.ev.clone()
    status = init.status.clone()
    piv = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(1, max_pivots):
        lanes = lanes_where(status == 0)
        if lanes.numel() == 0:
            break
        r = torch.arange(lanes.numel(), device=dev)
        Ti, bi, ei = T[lanes], basis[lanes], ent[lanes]
        di, evi = edir[lanes], ev[lanes]
        vlb, vub = init.var_lb[lanes], init.var_ub[lanes]
        # the entering variable temporarily carries its start value
        vi = val[lanes].index_put((r, ei), evi)
        xB = Ti[:, :, -1] - (Ti[:, :, :-1] @ vi[:, :, None])[:, :, 0]
        col = Ti[r, :, ei]
        d = di[:, None] * col
        theta = torch.where(
            d > piv_tol, (xB - vlb.gather(1, bi)) / d,
            torch.where(d < -piv_tol, (xB - vub.gather(1, bi)) / d, _INF))
        theta = torch.where(torch.isnan(theta), _INF, theta).clamp_min(0.0)
        lb_e, ub_e = vlb[r, ei], vub[r, ei]
        theta_e = torch.where(di > 0, ub_e - evi, evi - lb_e)
        tstar = theta.amin(1)
        is_ray = ~torch.isfinite(tstar) & ~torch.isfinite(theta_e)
        flip = ~is_ray & (theta_e <= tstar)

        # pivot row: the t row when it ties, else lexicographic refinement
        tie = theta <= (tstar + tol * (1.0 + tstar.abs()))[:, None]
        t_tie = tie & (bi == T_ID)
        pick_t = t_tie.any(1)
        cand = _lex_refine(Ti, d, tie,
                           ~pick_t & ~flip & ~is_ray & (tie.sum(1) > 1),
                           piv_tol)
        jstar = torch.where(pick_t, _first_true(t_tie), _first_true(cand))
        piv_elt = col[r, jstar]
        bad = piv_elt.abs() < piv_tol
        exiting = bi[r, jstar]
        exit_val = torch.where(d[r, jstar] > 0, vlb[r, exiting],
                               vub[r, exiting])
        pivot = ~is_ray & ~flip & ~bad

        p = lanes_where(pivot)
        if p.numel():
            T[lanes[p]] = _pivot_rows(Ti[p], jstar[p], ei[p])
            basis[lanes[p], jstar[p]] = ei[p]
        v_flip = vi.index_put((r, ei), torch.where(di > 0, ub_e, lb_e))
        v_piv = vi.index_put((r, exiting), exit_val).index_put(
            (r, ei), torch.zeros_like(evi))
        val[lanes] = torch.where(pivot[:, None], v_piv,
                                 torch.where(flip[:, None], v_flip, vi))

        nent, ndir, nev = _complement(exiting, exit_val, init.l_eff[lanes],
                                      init.u_eff[lanes], n)
        ie = ei % n
        ent[lanes] = torch.where(pivot, nent, torch.where(
            flip, torch.where(di > 0, 2 * n + ie, n + ie), ei))
        edir[lanes] = torch.where(pivot, ndir,
                                  torch.where(flip, torch.ones_like(di), di))
        ev[lanes] = torch.where(pivot, nev,
                                torch.where(flip, torch.zeros_like(evi), evi))
        status[lanes] = torch.where(
            is_ray, LEMKE_RAY,
            torch.where(~flip & bad, LEMKE_SINGULAR,
                        torch.where(pivot & (exiting == T_ID), LEMKE_SUCCESS,
                                    status[lanes]))).to(torch.int32)
        piv[lanes] += (~is_ray & (flip | ~bad)).to(torch.int32)
    status = torch.where(status == 0, LEMKE_MAX, status).to(torch.int32)
    xB = T[:, :, -1] - (T[:, :, :-1] @ val[:, :, None])[:, :, 0]
    return PivotResult(xB=xB, basis=basis.to(torch.int32), val=val, piv=piv,
                       status=status)


PivotEngine = Callable[..., PivotResult]


def pivot_engine(device: torch.device) -> PivotEngine:
    """The pivot loop ``CONFIG.lemke_kernel`` selects for tensors on
    ``device``: "auto" takes the CUDA kernel for CUDA tensors and the plain
    loop for CPU tensors."""
    mode = CONFIG.lemke_kernel
    if mode == "torch" or (mode == "auto" and device.type == "cpu"):
        return lemke_pivot_torch
    if mode in ("auto", "cuda"):
        from .lemke_cuda import lemke_pivot_cuda
        return lemke_pivot_cuda
    raise ValueError(f"unknown CONFIG.lemke_kernel {mode!r} "
                     "(expected 'auto', 'cuda' or 'torch')")


def solve_lemke_batch_state(M, q, l, u, z0, var_mask, *, pivot: PivotEngine,
                            tol=1e-9, piv_tol=1e-11, max_pivots: int = 512,
                            synth_scale=SYNTH_SCALE, cover: str = "viol"):
    """Batched box-AVI Lemke solve with the given pivot engine.

    Shapes: M (B,n,n); q/l/u/z0/var_mask (B,n); the dtype of q is the
    working precision.  Returns ``(z, status, pivots, basis, val)``: the
    pivot count includes the covering pivot (0 for lanes solved at the
    start), and ``basis``/``val`` let the caller refactorize the terminal
    basis in f64 (:func:`refactor_batch`).  Every lane's pivots are summed
    on the device into ``METRICS["k1_pivots"]`` and the lanes counted in
    ``["k1_lanes"]``, whichever the engine."""
    init = lemke_setup(M, q, l, u, z0, var_mask, tol=tol,
                       synth_scale=synth_scale, cover=cover)
    res = pivot(init, tol=tol, piv_tol=piv_tol, max_pivots=max_pivots)
    z = _extract_z(res.xB, res.basis, res.val, var_mask.to(torch.bool))
    piv = torch.where(init.status == LEMKE_SUCCESS, 0, res.piv + 1)
    METRICS.bump("k1_pivots", piv)
    METRICS.bump("k1_lanes", piv.shape[0])
    return z, res.status, piv.to(torch.int32), res.basis, res.val


def solve_lemke_batch_state_auto(M, q, l, u, z0, var_mask, **kw):
    """:func:`solve_lemke_batch_state` with the engine that
    ``CONFIG.lemke_kernel`` picks for the tensors' device
    (:func:`pivot_engine`)."""
    return solve_lemke_batch_state(M, q, l, u, z0, var_mask,
                                   pivot=pivot_engine(q.device), **kw)


class LemkeResult(NamedTuple):
    """What :func:`solve_lemke_batch` returns, per lane."""
    z: torch.Tensor        # (B, n) solution estimate
    status: torch.Tensor   # (B,) LEMKE_SUCCESS, _RAY, _MAX or _SINGULAR
    pivots: torch.Tensor   # (B,) pivots, the covering one included


def solve_lemke_batch(M, q, l, u, z0, var_mask, tol=1e-9, piv_tol=1e-11,
                      max_pivots: int = 512, synth_scale=SYNTH_SCALE,
                      cover: str = "viol") -> LemkeResult:
    """Batched box-AVI Lemke solve.  Shapes: M (B,n,n); q/l/u/z0/var_mask
    (B,n).  Counterpart of ``qpn_tpu/ops/lemke.py::solve_lemke_batch``.

    A thin view over :func:`solve_lemke_batch_state_auto`: K1 on CUDA
    tensors, the plain loop on CPU tensors.  Numpy inputs go to
    ``config.numeric_device()`` (the card unless the caller asks for the
    CPU), keeping their dtype; the result lies on the inputs' device."""
    from ..config import numeric_device
    dev = q.device if isinstance(q, torch.Tensor) else numeric_device()
    M, q, l, u, z0, var_mask = (torch.as_tensor(a, device=dev)
                                for a in (M, q, l, u, z0, var_mask))
    z, status, piv, _, _ = solve_lemke_batch_state_auto(
        M, q, l, u, z0, var_mask.to(torch.bool), tol=tol, piv_tol=piv_tol,
        max_pivots=max_pivots, synth_scale=synth_scale, cover=cover)
    return LemkeResult(z, status, piv)


def _extract_z(xB, basis, val, var_mask):
    """z_i = the row value where z_i is basic, its nonbasic value otherwise;
    padded variables are 0."""
    B, n = xB.shape
    basis = basis.long()
    z = torch.cat([val[:, :n], torch.zeros_like(val[:, :1])], 1)
    # rows whose basic variable is a slack or t scatter into the spare slot
    z.scatter_(1, torch.where(basis < n, basis, n), xB)
    return torch.where(var_mask, z[:, :n], 0.0)


def refactor_batch(M, q, l, u, basis, val, var_mask):
    """f64 terminal refactorization for a batch of pivot outcomes, on the
    tensors' device.

    Rebuilds each lane's basic system from the ORIGINAL f64 data at the
    terminal complementary basis and solves it with one batched LU;
    nonbasic z values snap to the nearest true f64 bound.  Returns (z, ok) —
    lanes with t still basic or a singular basis get ok=False.  Counterpart
    of ``qpn_tpu/ops/lemke.py::refactor_batch_np``."""
    f64 = torch.float64
    M, q, l, u = (a.to(f64) for a in (M, q, l, u))
    vm = var_mask.to(torch.bool)
    B, n = q.shape
    dev = q.device
    zero = torch.zeros((), dtype=f64, device=dev)
    eye = torch.eye(n, dtype=f64, device=dev)
    Mm = torch.where(vm[:, None, :] & vm[:, :, None], M, eye)
    qm = torch.where(vm, q, zero)
    lm = torch.where(vm, l, zero)
    um = torch.where(vm, u, zero)

    # snap nonbasic z values to the true f64 bounds where they exist
    val = val.to(f64).clone()
    zval = val[:, :n]
    fin_l, fin_u = torch.isfinite(lm), torch.isfinite(um)
    dl = (zval - torch.where(fin_l, lm, _INF)).abs()
    du = (zval - torch.where(fin_u, um, _INF)).abs()
    near = 1e-2 * (1 + zval.abs())
    snap_l = fin_l & ((dl <= du) | ~fin_u) & (dl < near)
    snap_u = fin_u & (du < dl) & (du < near)
    val[:, :n] = torch.where(snap_l, lm, torch.where(snap_u, um, zval))

    basis = basis.long()
    bz = basis < n
    bu = (basis >= n) & (basis < 2 * n)
    t_ok = (basis != 3 * n).all(1)
    # basis matrix columns: z_i -> M[:, i]; u_i -> -e_i; v_i -> +e_i
    col_z = Mm.gather(2, torch.where(bz, basis, 0)[:, None, :].expand(B, n, n))
    slack_idx = torch.where(bu, basis - n, (basis - 2 * n).clamp(0, n - 1))
    e_cols = (torch.arange(n, device=dev)[None, :, None]
              == slack_idx[:, None, :]).to(f64)
    sgn = torch.where(bu, -1.0, 1.0).to(f64)
    Bmat = torch.where(bz[:, None, :], col_z, sgn[:, None, :] * e_cols)
    nb = val.scatter(1, basis, 0.0)
    rhs = (-qm - (Mm @ nb[:, :n, None])[:, :, 0]
           + nb[:, n:2 * n] - nb[:, 2 * n:3 * n])
    # the batched LU waits on the card inside itself (MAGMA's device and
    # stream synchronizations and frees, seen from 64 lanes on): a host sync
    xB, info = METRICS.sync(torch.linalg.solve_ex, Bmat, rhs[:, :, None])
    xB = xB[:, :, 0]
    ok = t_ok & (info == 0) & torch.isfinite(xB).all(1)
    # z_i = row value where basic, snapped nonbasic value otherwise
    z = torch.cat([nb[:, :n], torch.zeros_like(nb[:, :1])], 1)
    z.scatter_(1, torch.where(bz, basis, n), xB)
    return torch.where(vm, z[:, :n], 0.0), ok


def solve_lemke_batch_padded(M, q, l, u, z0, var_mask, tol=1e-9):
    """f64 Lemke solve of a batch of box AVIs: the pivot loop (the CUDA
    kernel's f64 instance for CUDA tensors), then :func:`refactor_batch`
    where the terminal basis is complementary.  Returns (z, status, pivots).

    The JAX package pads n to its ``row_buckets`` bucket for XLA's compile
    cache; padded variables are pinned rows that never enter the basis, so
    the port runs at the exact shape.  The pivot budget is still sized from
    the bucket, ``min(4096, 16·bucket(n) + 256)``, so that a lane that hits
    the cap ends as it does there."""
    f64 = torch.float64
    M, q, l, u, z0 = (a.to(f64) for a in (M, q, l, u, z0))
    vm = var_mask.to(torch.bool)
    max_pivots = int(min(4096, 16 * bucket(q.shape[1], CONFIG.row_buckets)
                         + 256))
    z, status, piv, basis, val = solve_lemke_batch_state_auto(
        M, q, l, u, z0, vm, tol=tol, max_pivots=max_pivots)
    zR, ok = refactor_batch(M, q, l, u, basis, val, vm)
    return torch.where(ok[:, None], zR, z), status, piv


def lemke_escalate(M, q, l, u, z0, var_mask, *, tol=1e-10,
                   deltas=(0.0, 1e-7, 1e-4), rounds=2):
    """Proximal-Lemke escalation tier for stubborn AVI lanes
    (``qpn_tpu/ops/lemke.py::lemke_escalate``).

    For each lane still above ``tol``: pivot on ``(M + δI, q − δ z_ref)`` for
    an escalating δ schedule (δ=0 is the raw problem; positive δ makes the
    subproblem strongly monotone), Newton-polish the pivot solution on the
    TRUE problem, and accept whatever lowers the natural residual.  A second
    round re-centers ``z_ref`` at the incumbent — the proximal-point
    iteration.  Tensors on one device; returns ``(z, resid)`` in f64."""
    from .avi import natural_residual, solve_avi_batch_polish
    f64 = torch.float64
    M, q, l, u, z0 = (a.to(f64) for a in (M, q, l, u, z0))
    vm = var_mask.to(torch.bool)
    eye = torch.eye(q.shape[1], dtype=f64, device=q.device)
    z_best = z0.clone()
    r_best = natural_residual(M, q, l, u, z0, vm)
    z_ref = z0.clone()
    for _ in range(rounds):
        for delta in deltas:
            idx = lanes_where(r_best > tol)
            if idx.numel() == 0:
                return z_best, r_best
            Mi, qi, li, ui, vi = M[idx], q[idx], l[idx], u[idx], vm[idx]
            z_piv, _, _ = solve_lemke_batch_padded(
                Mi + delta * eye, qi - delta * z_ref[idx], li, ui,
                z_ref[idx], vi, tol=max(tol, 1e-11))
            # polish the pivot solution on the unregularized problem
            res = solve_avi_batch_polish(Mi, qi, li, ui, z_piv, vi, tol=tol,
                                         max_iter=40)
            r_new = natural_residual(Mi, qi, li, ui, res.z, vi)
            # the raw pivot output may itself be the better point
            r_piv = natural_residual(Mi, qi, li, ui, z_piv, vi)
            z_new = torch.where((r_piv < r_new)[:, None], z_piv, res.z)
            r_new = torch.minimum(r_new, r_piv)
            better = r_new < r_best[idx]
            z_best[idx] = torch.where(better[:, None], z_new, z_best[idx])
            r_best[idx] = torch.where(better, r_new, r_best[idx])
        z_ref = z_best.clone()
    return z_best, r_best


# --------------------------------------------------------------------------
#  LP engines of the geometry layer
# --------------------------------------------------------------------------

def _classify_lp_pivot(c, x, Ax, l, u, resid, status, tol, row_mask=None):
    """Shared trust-ladder classification for both LP pivot routes.

    Only certificates we can trust: SOLVED needs the audited natural
    residual; DUAL_INFEASIBLE (unbounded) needs a primal-feasible point
    pressed far into the synthetic box with a correspondingly huge
    objective.  Everything else — including apparent primal violation,
    which may just be pivot-path numerical degradation — is MAX_ITER and
    falls back to the ADMM engine with its certificates.

    NaN violations (inf-cancellation on a garbage fallback point) map to
    +inf so they FAIL the feasibility gate: a positive certificate must
    never be granted on an unverifiable point."""
    from . import batch_qp
    with np.errstate(invalid="ignore"):
        viol = np.maximum(np.maximum(
            np.where(np.isfinite(l), l, -_INF) - Ax,
            Ax - np.where(np.isfinite(u), u, _INF)), 0.0)
    viol = np.nan_to_num(viol, nan=np.inf, posinf=np.inf)
    if row_mask is not None:
        viol = np.where(row_mask, viol, 0.0)
    pviol = viol.max(axis=1, initial=0.0)
    clean = status == LEMKE_SUCCESS
    solved = clean & (resid <= tol)
    obj = np.einsum("bn,bn->b", c, x)
    huge = 1e3 * (1.0 + np.abs(np.where(np.isfinite(l), l, 0.0)).max(
        axis=1, initial=0.0)
        + np.abs(np.where(np.isfinite(u), u, 0.0)).max(axis=1, initial=0.0)
        + np.abs(c).sum(axis=1))
    unbounded = clean & ~solved & (pviol <= 1e-6) & (obj < -huge)
    st = np.where(solved, batch_qp.SOLVED,
                  np.where(unbounded, batch_qp.DUAL_INFEASIBLE,
                           batch_qp.MAX_ITER)).astype(np.int32)
    return st, pviol, obj


def _lp_kkt(c, A, l, u, row_mask):
    """The LP ``min c'x s.t. l ≤ Ax ≤ u`` as the box AVI over z = [x; λ; s]:

        rows x (free):  c − A'λ = 0
        rows λ (free):  A x − s = 0
        rows s:         λ  ⟂  l ≤ s ≤ u

    Returns (M, q, lA, uA) for numpy c (B,n), A (B,m,n), l/u (B,m); masked
    rows get zero bounds (their variables are masked out by the caller)."""
    B, m, n = A.shape
    N = n + 2 * m
    M = np.zeros((B, N, N))
    M[:, :n, n:n + m] = -A.transpose(0, 2, 1)
    M[:, n:n + m, :n] = A
    if m:
        M[:, n:n + m, n + m:] = -np.eye(m)[None]
        M[:, n + m:, n:n + m] = np.eye(m)[None]
    q = np.concatenate([c, np.zeros((B, 2 * m))], axis=1)
    lA = np.concatenate([np.full((B, n + m), -_INF),
                         np.where(row_mask, l, 0.0)], axis=1)
    uA = np.concatenate([np.full((B, n + m), _INF),
                         np.where(row_mask, u, 0.0)], axis=1)
    return M, q, lA, uA


def _admm_fallback(sol_fields, bad, c, A, l, u, row_mask):
    """Re-solve the ``bad`` lanes of an LP batch with the ADMM engine and
    write x, y, z, obj and status into ``sol_fields``."""
    from . import batch_qp
    idx = np.nonzero(bad)[0]
    n0 = A.shape[2]
    sol = batch_qp.solve_qp_batch_padded(
        np.zeros((len(idx), n0, n0)), c[idx], A[idx], l[idx], u[idx],
        row_mask[idx], _no_lemke=True)
    for f in ("x", "y", "z", "obj", "status"):
        sol_fields[f][idx] = getattr(sol, f)


def solve_lp_host_batch(c, A, l, u, row_mask, *, tol=1e-7,
                        _no_broker=False):
    """Native exact-shape pivot solve for a batch of small dense LPs.

    Same KKT-AVI formulation and status discipline as
    :func:`solve_lp_lemke_batch`, run by the C++ port of the host pivot
    oracle (``utils/native.lemke_batch``) on EXACT shapes, each lane with
    its own active rows.  For the ≤64-row LPs behind geometry support and
    emptiness queries each solve takes a fraction of a millisecond.  Lanes
    whose pivot run is uncertified fall back to the ADMM engine.  Returns a
    ``batch_qp.QPSolution`` of numpy arrays; a library that fails to build
    or load raises.

    Under a lockstep broker the geometry LPs park and fuse with the other
    scenarios' requests into one OpenMP batch (counters
    ``broker_lp_host_waves`` and ``broker_lp_host_fused``)."""
    from . import batch_qp
    from ..utils import native
    if not _no_broker:
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("lp_host", c, A, l, u, row_mask, tol=tol)
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B0, m0, n0 = A.shape
    out = dict(x=np.zeros((B0, n0)), y=np.zeros((B0, m0)), obj=np.zeros(B0),
               status=np.full(B0, batch_qp.MAX_ITER, dtype=np.int32))
    piv = np.zeros(B0, dtype=np.int64)
    pviol_out = np.zeros(B0)
    resid_out = np.zeros(B0)
    acts = [np.nonzero(row_mask[b])[0] for b in range(B0)]
    groups: dict = {}
    for b in range(B0):
        groups.setdefault(len(acts[b]), []).append(b)
    for m, idxs in groups.items():
        k = len(idxs)
        act = np.stack([acts[b] for b in idxs]).reshape(k, m)
        Ab = np.take_along_axis(A[idxs], act[:, :, None], axis=1)
        lb = np.take_along_axis(l[idxs], act, axis=1)
        ub = np.take_along_axis(u[idxs], act, axis=1)
        M, q, lA, uA = _lp_kkt(c[idxs], Ab, lb, ub, np.ones((k, m), bool))
        z, stg, pg = native.lemke_batch(M, q, lA, uA, tol=1e-11,
                                        max_pivots=max(400, 20 * M.shape[1]))
        xg = z[:, :n0]
        lam = z[:, n0:n0 + m]
        # audit: natural residual of the TRUE (un-boxed) KKT AVI; every row
        # is real at these exact shapes, so it is unmasked
        F = np.einsum("bij,bj->bi", M, z) + q
        with np.errstate(invalid="ignore"):
            proj = np.clip(z - F, lA, uA)
        resid = np.abs(z - proj).max(axis=1, initial=0.0)
        Ax = np.einsum("bmn,bn->bm", Ab, xg)
        stl, pviol, obj_g = _classify_lp_pivot(c[idxs], xg, Ax, lb, ub,
                                               resid, stg, tol)
        bidx = np.asarray(idxs)
        out["x"][bidx] = xg
        y_tmp = np.zeros((k, m0))
        np.put_along_axis(y_tmp, act, -lam, axis=1)
        out["y"][bidx] = y_tmp
        out["obj"][bidx] = obj_g
        out["status"][bidx] = stl
        piv[bidx] = pg
        pviol_out[bidx] = pviol
        resid_out[bidx] = resid
    METRICS.bump("lp_host", B0)
    bad = out["status"] == batch_qp.MAX_ITER
    zproj = np.einsum("bmn,bn->bm", A, out["x"])
    with np.errstate(invalid="ignore"):
        out["z"] = np.clip(zproj, np.where(np.isfinite(l), l, -1e20),
                           np.where(np.isfinite(u), u, 1e20))
    if bad.any():
        METRICS.bump("lp_host_fallback", int(bad.sum()))
        _admm_fallback(out, bad, c, A, l, u, row_mask)
    return batch_qp.QPSolution(prim_res=pviol_out, dual_res=resid_out,
                               iters=piv, **out)


def solve_lp_lemke_batch(c, A, l, u, row_mask, *, tol=1e-7):
    """Exact batched LP solve by complementary pivoting on the LP's KKT AVI
    (:func:`_lp_kkt`), in f64 on ``CONFIG.device`` (the pivot loop in K1's
    f64 instance for CUDA).

    ``min c'x s.t. l ≤ A x ≤ u`` with free variables: the shape of every
    support / emptiness / membership LP of the geometry layer.  Pivoting
    ends on an exact complementary basis in tens of pivots, with exact
    duals.  Returns a ``batch_qp.QPSolution`` of numpy arrays with the same
    sign conventions (``y = −λ``, so y>0 pushes on the upper bound).

    Status (see :func:`_classify_lp_pivot`): a certified natural residual
    ⇒ SOLVED; a primal-feasible point pressed into the synthetic box ⇒
    DUAL_INFEASIBLE; everything else is MAX_ITER and falls back to the ADMM
    engine, which owns the PRIMAL_INFEASIBLE certificates.  The JAX package
    pads every axis to its buckets for XLA's compile cache; padded
    variables are pinned and never pivot, so the port runs at exact shapes
    and sizes only the pivot budget from the buckets."""
    from . import batch_qp
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B0, m0, n0 = A.shape
    M, q, lA, uA = _lp_kkt(c, A, l, u, row_mask)
    vm = np.concatenate([np.ones((B0, n0), bool), row_mask, row_mask], axis=1)
    Np = (bucket(max(n0, 1), CONFIG.dim_buckets)
          + 2 * bucket(max(m0, 1), CONFIG.row_buckets))
    max_pivots = 256
    while max_pivots < min(4096, 12 * Np + 128):
        max_pivots *= 2
    dev = numeric_device()
    f64 = torch.float64
    t = [torch.as_tensor(a, dtype=f64, device=dev) for a in (M, q, lA, uA)]
    zt, st_t, piv_t, _, _ = solve_lemke_batch_state_auto(
        *t, torch.zeros_like(t[1]), torch.as_tensor(vm, device=dev),
        tol=1e-11, max_pivots=max_pivots)
    z, status, piv = (a.cpu().numpy() for a in (zt, st_t, piv_t))
    x = z[:, :n0]
    lam = np.where(row_mask, z[:, n0:n0 + m0], 0.0)
    F = np.einsum("bij,bj->bi", M, z) + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(z - F, lA, uA)
    resid = np.abs(np.where(vm, z - proj, 0.0)).max(axis=1, initial=0.0)
    Ax = np.einsum("bmn,bn->bm", A, x)
    st, pviol, _ = _classify_lp_pivot(c, x, Ax, l, u, resid, status, tol,
                                      row_mask=row_mask)
    with np.errstate(invalid="ignore"):
        zproj = np.clip(Ax, np.where(np.isfinite(l), l, -1e20),
                        np.where(np.isfinite(u), u, 1e20))
    out = dict(x=np.array(x), y=-lam, z=zproj,
               obj=np.einsum("bn,bn->b", c, x), status=st)
    METRICS.bump("lp_lemke", B0)
    bad = st == batch_qp.MAX_ITER
    if bad.any():
        METRICS.bump("lp_lemke_fallback", int(bad.sum()))
        _admm_fallback(out, bad, c, A, l, u, row_mask)
    return batch_qp.QPSolution(prim_res=pviol, dual_res=resid,
                               iters=piv.astype(np.int64), **out)
