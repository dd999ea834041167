"""Shared-matrix scenario-ensemble AVI solver (PyTorch port of
``qpn_tpu/ops/shared_kkt.py``).

Scenario uncertainty ensembles (robust_avoid's T-step trajectory class) share
ONE KKT matrix M across all S scenarios: the uncertainty enters only through
``q = N w + o`` and the separation offsets in the bounds
(``models/robust_avoid.scenario_batch_gavis``).  The batched Lemke route
(``ops/lemke.py``) replicates M per lane, which at trajectory scale (n = 608
at T=8, 1216 at T=16) is an (S, n, 3n+2) tableau whose rank-1 pivot updates
are bound by memory traffic.  This module treats the ensemble as one matrix
problem:

1. **f32 extragradient pre-pass as (S, n) @ (n, n) GEMMs** against the one
   shared M (:func:`_eg_steps`, :func:`_eg_run`).  Korpelevich extragradient
   converges on monotone AVIs (the stacked KKT systems are skew + PSD), and
   the pre-pass needs only a stable active set, not a tight residual.  The
   host reads the stopping rule (residual, label stability, plateau) once
   per chunk of ``eg_chunk`` steps and nothing inside a chunk.
2. **Fused δ=0 first policy round on the device** (:func:`_round0_solve`):
   the labels become masks and bound values on the device, then one batched
   f32 LU, f64 iterative refinement against the f64 data, the f64
   natural-residual audit and a per-lane label hash.
3. **Host-driven proximal-δ policy rounds** (Josephy-Newton / LCP policy
   iteration) for the lanes round 0 leaves: classify from the natural map,
   solve the complementary basis (:func:`_basis_solve_refine` on the device
   above 24 lanes, :func:`_host_basis_solve` in LAPACK below), escalate a
   per-lane proximal-δ ladder on a singular basis or a cycling
   classification (detected by the label hashes), with a stall detector
   that hands chronic non-certifiers to the rungs.
4. **Structured-QP escalation**: round-0-singular lanes are the
   dual-degenerate class and skip the ladder; :func:`_chip_admm_rung` solves
   their underlying QPs with the batched ADMM (``ops/batch_qp``) on the
   device and certifies them through the small active-set host polish
   (:func:`_structured_polish`).  What is left goes to the ADMM route of
   ``avi.solve_kkt_avi_batch``, a host min-norm solve, the optional
   proximal-point rung (:func:`_prox_eg_rung`) and the generic adaptive
   solver (:func:`_escalate_generic`).

Every acceptance is the f64 natural-residual audit.  ``stats`` returns the
analytic operation and byte counts of the device phases and the wall time of
each phase (``phase_t``).

Observability (``utils/metrics.py``), inside the entry's ``qpn.kkt.shared``
span: spans ``qpn.shared.eg`` (the pre-pass, its per-chunk reads and the
fetch of Z), ``.round0``, ``.ladder`` (the δ-ladder rounds), ``.rungs``
(everything after the ladder before the final audit; inside it ``.admm``,
the ADMM rung's device calls, and ``.polish``, :func:`_structured_polish`)
and ``.audit``; every blocking device-to-host read through
``METRICS.sync``, the batched LU too (MAGMA waits inside it); counters
``shared_eg_steps`` (pre-pass steps, ``stats["eg_iters"]``),
``shared_eg_gemms`` (the pre-pass's (lanes, n) @ (n, n) products),
``shared_round0_left`` (lanes round 0 left uncertified),
``shared_polish_lanes`` (lanes of each :func:`_structured_polish` call) and
``shared_host_solves`` (``stats["host_solves"]``), beside the rung counters
``shared_kkt_*``.  Each ``phase_t`` entry is a span of its own (``eg`` is
``qpn.shared.eg.steps``, ``chip_admm_rung`` ``qpn.shared.rungs.chip_admm``,
and so on, :func:`_phase`), and ``chip_admm_t`` reads ``.admm`` and
``.polish``: the route has one clock.

Against the JAX package, as the rules of the port say: all device work runs
on one device (that of the inputs, or ``CONFIG.device`` for numpy inputs);
the JAX package's 128-lane chunks and lane buckets of the ADMM rung, the
lane buckets of the later policy rounds and of the proximal rung, the CPU
pinning of the escalation rungs and the deferred host copies of round 0 are
not carried over (padding with copies of lane 0 changes no lane's numbers;
the ADMM is f64, ``ops/batch_qp``).  The extragradient GEMMs are plain f32
(``eg_prec="highest"``); ``"tf32"`` allows TF32 for the pre-pass alone, in a
scope that is restored.

With a ``mesh`` (``parallel/mesh.py``; every rank makes the same call) the
scenario axis is split over the ranks for the pre-pass and round 0, the
JAX package's rules: each rank runs the pre-pass on its S/size lanes (the
stopping rule reads the ensemble-wide residual and label count, reduced over
the ranks) and round 0 in one call over them, and the results are gathered;
the δ-ladder rounds and the escalation rungs then run replicated on every
rank, on its own copy of M, so that every rank takes the same host
decisions.  The mesh is ignored when S is not a multiple of its size.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import numpy as np
import torch

from ..config import numeric_device
from ..utils.metrics import METRICS
from .avi import AVIResult


# --------------------------------------------------------------------------
#  EG pre-pass: chunks of (S,n)@(n,n) GEMM steps
# --------------------------------------------------------------------------

def _eg_steps(Mt, Q, L, U, Z, tau, steps, band, method="eg"):
    """``steps`` first-order iterations from Z, then the classification.

    ``method="eg"`` is Korpelevich extragradient (two GEMMs a step,
    τ < 1/L); ``"popov"`` is Popov's optimistic method (one GEMM a step at
    the leading point, τ < 1/(2L)).  Mt is Mᵀ (n, n); Q, L, U, Z are (S, n);
    all f32 on one device.  Returns (Z, natural residual r per lane, at_l,
    at_u).  No host read inside."""
    tau = float(tau)
    Z = Z.clone()
    F = torch.empty_like(Z)
    if method == "popov":
        Zb = Z.clone()
        for _ in range(steps):
            torch.addmm(Q, Zb, Mt, out=F)
            torch.add(Z, F, alpha=-tau, out=Z)
            torch.clamp(Z, L, U, out=Z)
            torch.add(Z, F, alpha=-tau, out=Zb)
            torch.clamp(Zb, L, U, out=Zb)
    else:
        Zh = torch.empty_like(Z)
        for _ in range(steps):
            torch.addmm(Q, Z, Mt, out=F)
            torch.add(Z, F, alpha=-tau, out=Zh)
            torch.clamp(Zh, L, U, out=Zh)
            torch.addmm(Q, Zh, Mt, out=F)
            torch.add(Z, F, alpha=-tau, out=Z)
            torch.clamp(Z, L, U, out=Z)
    torch.addmm(Q, Z, Mt, out=F)
    s = Z - F
    r = (Z - torch.clamp(s, L, U)).abs().amax(1)
    at_l = torch.isfinite(L) & (s <= L + band)
    at_u = torch.isfinite(U) & (s >= U - band) & ~at_l
    return Z, r, at_l, at_u


def _eg_chunk(Mt, Q, L, U, Z, tau, steps, band, prev_l, prev_u, method="eg"):
    """One chunk: ``steps`` iterations, the residual, the classification
    and the number of labels that changed since the previous chunk."""
    Z, r, at_l, at_u = _eg_steps(Mt, Q, L, U, Z, tau, steps, band, method)
    changed = ((at_l != prev_l) | (at_u != prev_u)).sum()
    return Z, r, at_l, at_u, changed


def _eg_run(Mt, Q, L, U, Z0, tau, steps, max_chunks, band, switch,
            stable_tol, method="eg", mesh=None):
    """The whole extragradient pre-pass: chunks of ``steps`` iterations
    until a stopping rule holds or ``max_chunks`` are done.  The rules, read
    on the host once per chunk: the largest residual below ``switch``; from
    the second chunk, at most ``stable_tol`` labels changed ensemble-wide
    (the policy rounds reclassify those lanes from their own basis
    solutions); from the fourth, a residual plateau (less than 10 %
    improvement over three chunks: degenerate-heavy ensembles never
    stabilise their labels, and more steps buy the terminal solve nothing).
    With a ``mesh`` the lanes are this rank's block and the residual and the
    label count are reduced over the ranks (max and sum: exact), so every
    rank stops at the same chunk.  Returns (Z, r, at_l, at_u, chunks
    done)."""
    f32 = np.float32
    Z = Z0
    r = torch.full((Q.shape[0],), torch.inf, dtype=Z0.dtype, device=Q.device)
    at_l = torch.zeros(Q.shape, dtype=torch.bool, device=Q.device)
    at_u = at_l
    rh = [f32(np.inf)] * 3
    k = 0
    while k < max_chunks:
        Z, r, at_l, at_u, changed = _eg_chunk(Mt, Q, L, U, Z, tau, steps,
                                              band, at_l, at_u, method)
        rmax, changed = METRICS.sync(torch.stack([r.max().double(),
                                                  changed.double()]).tolist)
        if mesh is not None:
            from ..parallel.mesh import all_reduce
            rmax = all_reduce(mesh, [rmax], "max")[0]
            changed = all_reduce(mesh, [changed], "sum")[0]
        rmax = f32(rmax)
        plateau = k >= 3 and rmax > f32(0.9) * rh[0]
        stop = (rmax < f32(switch) or (k >= 1 and changed <= stable_tol)
                or plateau)
        rh = [rh[1], rh[2], rmax]
        k += 1
        if stop:
            break
    return Z, r, at_l, at_u, k


def _nat_resid(z, F, l, u):
    """max |z − clip(z − F, l, u)| per lane, +inf where z is not finite."""
    rn = (z - torch.clamp(z - F, l, u)).abs().amax(1)
    return torch.where(torch.isfinite(z).all(1), rn, torch.inf)


def _prox_eg_rung(M32, M64, Q64, L64, U64, Z0, delta, tau, tol, inner_steps,
                  max_outer):
    """Batched proximal-point rung for degenerate lanes, on the device.

    Outer loop (Rockafellar proximal point, convergent for monotone M):
    around the incumbent ``z_ref``, solve the strongly monotone prox
    subproblem ``(M + δI) d + (M z_ref + q) ⟂ (l − z_ref) ≤ d ≤
    (u − z_ref)`` in the correction d with a fixed-step f32 extragradient
    inner loop, then recenter ``z_ref += d``.  The f32 inner's absolute
    error scales with ‖d‖, which shrinks as z_ref converges, so the f64
    z_ref can certify at 1e-8 though every inner GEMM is f32.  The host
    reads the f64 audit once per outer round.  Returns (z, rn, rounds)."""
    f32, f64 = torch.float32, torch.float64
    Mt32, Mt64 = M32.T.contiguous(), M64.T.contiguous()
    delta, tau = float(delta), float(tau)
    zref = torch.clamp(Z0, L64, U64)         # d = 0 must be feasible
    rn = torch.full((Q64.shape[0],), torch.inf, dtype=f64, device=Q64.device)
    k = 0
    while k < max_outer:
        r32 = (zref @ Mt64 + Q64).to(f32)
        lm = (L64 - zref).to(f32)
        um = (U64 - zref).to(f32)
        d = torch.zeros_like(r32)
        for _ in range(inner_steps):
            Fd = torch.addmm(r32, d, Mt32) + delta * d
            dh = torch.clamp(d - tau * Fd, lm, um)
            Fh = torch.addmm(r32, dh, Mt32) + delta * dh
            d = torch.clamp(d - tau * Fh, lm, um)
        zref = zref + d.to(f64)
        F = zref @ Mt64 + Q64
        rn = (zref - torch.clamp(zref - F, L64, U64)).abs().amax(1)
        k += 1
        if METRICS.sync(float, rn.max()) <= tol:
            break
    return zref, rn, k


_CPU_THREADS_LOCK = threading.Lock()


@contextlib.contextmanager
def _one_cpu_thread(device: torch.device):
    """One intra-op thread for the batched LU on the CPU, the caller's count
    restored after it.  With an explicitly set count above one, PyTorch's
    CPU build (MKL LAPACK) was seen not to return from a batched
    ``lu_factor_ex`` of 32 matrices of 608 x 608 (or 4 of 256 x 256) in
    minutes, printing "SLASWP parameter 6" errors; with one thread it takes
    a fraction of a second (``tests/test_torch_shared.py``,
    ``test_lu_returns_with_several_cpu_threads``)."""
    if device.type != "cpu":
        yield
        return
    # the count is process-wide: scenario threads (parallel/lockstep.py)
    # take turns, so that none restores it under another's factorization
    with _CPU_THREADS_LOCK:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(prev)


def _lu_refine(buf, rhs0, residual, refines):
    """Factor the batch of basis matrices held transposed in ``buf`` (S, n,
    n) in f32, in place, solve for ``rhs0`` and run ``refines`` passes of
    f64 iterative refinement: ``residual(z)`` is the f64 residual of the
    system at z, and a correction that is not finite is skipped lane by
    lane, so one singular basis cannot poison its batch.  A lane whose
    factorization met an exactly zero pivot comes back non-finite.  On the
    CPU the LU work runs on one thread (:func:`_one_cpu_thread`)."""
    with _one_cpu_thread(buf.device):
        f32, f64 = torch.float32, torch.float64
        A = buf.mT                          # column-major, as LAPACK wants
        S, n = rhs0.shape
        piv = torch.empty(S, n, dtype=torch.int32, device=buf.device)
        info = torch.empty(S, dtype=torch.int32, device=buf.device)
        # MAGMA's batched factorization waits on the card inside itself
        lu, piv, info = METRICS.sync(functools.partial(
            torch.linalg.lu_factor_ex, out=(A, piv, info)), A)
        # after an exactly zero pivot the rest of a lane's factors and pivot
        # indices may be anything: give the solves a valid permutation there
        # and report the lane non-finite
        sound = (info == 0)[:, None]
        piv = torch.where(sound, piv, torch.arange(
            1, n + 1, dtype=torch.int32, device=buf.device))

        def solve(r):
            return torch.linalg.lu_solve(lu, piv, r.to(f32)[:, :, None])[
                :, :, 0].to(f64)

        z = torch.where(sound, solve(rhs0), torch.nan)
        for _ in range(refines):
            dz = solve(residual(z))
            good = torch.isfinite(dz).all(1)
            z = torch.where(good[:, None], z + dz, z)
        return z


def _round0_solve(M32, M64, at_l, at_u, Q64, L64, U64, refines):
    """Fused δ=0 first policy round on the device: the extragradient labels
    become free/bound masks and bound values, one batched f32 LU of the
    complementary-basis matrices (free rows from M, bound rows identity),
    f64 refinement and audit.  Same mathematics as
    :func:`_basis_solve_refine` at δ = 0.  Returns (z, rn, label hash)."""
    n = M32.shape[0]
    free = ~(at_l | at_u)
    l_fin = torch.where(torch.isfinite(L64), L64, 0.0)
    u_fin = torch.where(torch.isfinite(U64), U64, 0.0)
    bval = torch.where(at_l, l_fin, u_fin)
    eye32 = torch.eye(n, dtype=M32.dtype, device=M32.device)
    # Aᵀ of every lane, written straight into the buffer the LU overwrites:
    # column i of Aᵀ is row i of M where variable i is free, else e_i
    buf = torch.empty(free.shape[0], n, n, dtype=M32.dtype, device=M32.device)
    torch.where(free[:, None, :], M32.T[None], eye32, out=buf)
    Mt64 = M64.T

    def residual(z):
        return torch.where(free, -(z @ Mt64 + Q64), bval - z)

    z = _lu_refine(buf, torch.where(free, -Q64, bval), residual, refines)
    rn = _nat_resid(z, z @ Mt64 + Q64, L64, U64)
    return z, rn, _label_hash_dev(at_l, at_u)


def _basis_solve_refine(M32, M64, free, bval, q64, l64, u64, delta, zref,
                        refines):
    """Per-lane proximal complementary-basis solve: f32 LU and f64 iterative
    refinement on the device.

    Solves each lane's complementary-basis system of the proximal problem
    ``(M + δI) z + (q − δ z_ref) ⟂ l ≤ z ≤ u``: free rows from M + δ·I, bound
    rows identity.  δ is per lane: 0 for well-conditioned lanes (the raw
    Newton/policy step), positive for lanes whose raw basis is singular
    (degenerate active sets).  M + δI is strongly monotone, so every
    principal basis matrix is nonsingular, and shrinking δ with ``z_ref``
    recentred at the incumbent is the proximal-point iteration.  Returns the
    refined f64 solution, the original natural map F = Mz + q (the next
    round classifies from it), the f64 natural residual of the original
    problem (the acceptance gate) and of the prox subproblem (the inner
    iteration's own convergence signal), +inf where z is not finite."""
    n = M32.shape[0]
    eye32 = torch.eye(n, dtype=M32.dtype, device=M32.device)
    d32 = delta.to(M32.dtype)
    buf = torch.where(free[:, None, :],
                      M32.T[None] + d32[:, None, None] * eye32, eye32)
    q_eff = q64 - delta[:, None] * zref
    Mt64 = M64.T

    def residual(z):
        Fp = z @ Mt64 + q_eff + delta[:, None] * z
        return torch.where(free, -Fp, bval - z)

    z = _lu_refine(buf, torch.where(free, -q_eff, bval), residual, refines)
    F = z @ Mt64 + q64
    rn = _nat_resid(z, F, l64, u64)
    rp = _nat_resid(z, F + delta[:, None] * (z - zref), l64, u64)
    return z, F, rn, rp


def _host_basis_solve(M0, free, bval, qs, ls, us, delta, zref):
    """Host f64 LAPACK version of the proximal basis solve, for the
    straggler tail (a handful of degenerate lanes cycling through the δ
    ladder): exact f64 factorization needs no refinement passes.  Same
    contract as :func:`_basis_solve_refine`: (z, F, rn, rp)."""
    n = M0.shape[0]
    eye = np.eye(n)
    A = np.where(free[:, :, None],
                 M0[None] + delta[:, None, None] * eye[None], eye[None])
    rhs = np.where(free, -(qs - delta[:, None] * zref), bval)
    C = free.shape[0]
    z = np.empty((C, n))
    for i in range(C):
        try:
            z[i] = np.linalg.solve(A[i], rhs[i])
        except np.linalg.LinAlgError:
            # exactly singular basis: report non-finite so the caller's δ
            # ladder escalates (the min-norm rung after the loop covers the
            # consistent-singular case once, not once per round)
            z[i] = np.nan
    with np.errstate(invalid="ignore", over="ignore"):
        F = z @ M0.T + qs
        fin = np.isfinite(z).all(axis=1) & np.isfinite(F).all(axis=1)
        rn = np.where(
            fin, np.abs(z - np.clip(z - F, ls, us)).max(axis=1), np.inf)
        Fp = F + delta[:, None] * (z - zref)
        rp = np.where(
            fin, np.abs(z - np.clip(z - Fp, ls, us)).max(axis=1), np.inf)
    return z, F, rn, rp


def _classify(Z, F, l, u, band):
    """Active set from the natural map s = z − F."""
    s = Z - F
    at_l = np.isfinite(l) & (s <= l + band)
    at_u = np.isfinite(u) & (s >= u - band) & ~at_l
    return at_l, at_u


def _label_hash_dev(at_l, at_u):
    """Device-side per-lane label fingerprint (int32 wrap-around linear
    hash).  :func:`_label_hash` is its bit-equal host mirror: both feed the
    same cycling-fingerprint stream."""
    n = at_l.shape[-1]
    i32 = torch.int32
    w = (torch.arange(n, dtype=i32, device=at_l.device) * -1640531527) \
        ^ 0x5BD1E995
    return ((at_l.to(i32) * w).sum(-1, dtype=i32)
            + (at_u.to(i32) * (w * 40503)).sum(-1, dtype=i32))


def _wrap32(x):
    """Wrap int64 values to int32 two's complement (mod 2³²)."""
    return (((np.asarray(x, dtype=np.int64) + 2**31) % 2**32)
            - 2**31).astype(np.int32)


def _hash_weights(n):
    """Host copy of the per-row hash weights of :func:`_label_hash_dev`
    (int32 wrap-around arithmetic mirrored via int64 and a modulus), so a
    classification hashed on the device and the same classification hashed
    on the host give the same fingerprint."""
    w64 = np.arange(n, dtype=np.int64) * np.int64(-1640531527)
    return _wrap32(w64) ^ np.int32(0x5BD1E995)


def _label_hash(at_l, at_u, w):
    """Batched label fingerprint, bit-equal to the device hash: int32
    accumulation wraps mod 2³², which an exact int64 sum wrapped once at the
    end reproduces."""
    w = w.astype(np.int64)
    h = (at_l.astype(np.int64) @ w
         + at_u.astype(np.int64) @ _wrap32(w * 40503).astype(np.int64))
    return _wrap32(h)


def _nat_resid_shared(M0, q, l, u, Z):
    F = Z @ M0.T + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(Z - F, l, u)
    return np.abs(Z - proj).max(axis=1), F


def _structured_polish(M0, nd, m, q, l64, u64, x0, tol, scale):
    """Active-set KKT polish in the QP's own coordinates (lanes, host f64).

    The shared-KKT lanes are QPs with ``nd`` primal variables and ``m`` rows
    (``z = [x; λ; s]``, ``scenario_batch_gavis``); once a solver has located
    ``x`` to ~1e-5 the active set of the s-block is known, and the
    stationarity system on that active set is only ``(nd + a)²``.  Solves it
    min-norm (gelsy: degenerate duals give consistent singular systems),
    drops wrong-signed multipliers for up to 3 sign-refinement rounds, and
    audits the full reconstructed z against the original AVI natural
    residual: acceptance is the f64 audit, never the polish itself.

    Returns (z, rn) with rn = +inf where no band/refinement certified."""
    import scipy.linalg as sla
    Q = M0[:nd, :nd]
    A = M0[nd:nd + m, :nd]
    C = x0.shape[0]
    n = M0.shape[0]
    z_out = np.zeros((C, n))
    rn_out = np.full(C, np.inf)
    l2 = l64[:, nd + m:]
    u2 = u64[:, nd + m:]
    fin_l, fin_u = np.isfinite(l2), np.isfinite(u2)
    eqr = fin_l & fin_u & (u2 - l2 < 1e-12)
    stol = max(tol, 1e-9 * scale)
    for i in range(C):
        c = q[i, :nd]
        off = q[i, nd:nd + m]
        s0 = A @ x0[i] + off
        best_rn, best_z = np.inf, None
        for band in (1e-5 * scale, 1e-4 * scale, 1e-3 * scale):
            act_l = fin_l[i] & (s0 <= l2[i] + band)
            act_u = fin_u[i] & (s0 >= u2[i] - band) & ~act_l
            for _ in range(3):
                act = act_l | act_u | eqr[i]
                idx = np.flatnonzero(act)
                a = idx.size
                E = A[idx]
                b = np.where(act_l[idx] | eqr[i][idx], l2[i][idx],
                             u2[i][idx])
                K = np.zeros((nd + a, nd + a))
                K[:nd, :nd] = Q
                K[:nd, nd:] = -E.T
                K[nd:, :nd] = E
                rhs = np.concatenate([-c, b - off[idx]])
                sol = sla.lstsq(K, rhs, lapack_driver="gelsy",
                                check_finite=False)[0]
                xh, mu = sol[:nd], sol[nd:]
                lam = np.zeros(m)
                lam[idx] = mu
                bad = ((act_l & ~eqr[i] & (lam < -stol))
                       | (act_u & ~eqr[i] & (lam > stol)))
                if not bad.any():
                    break
                act_l, act_u = act_l & ~bad, act_u & ~bad
            sh = A @ xh + off
            z = np.concatenate([xh, lam, sh])
            F = M0 @ z + q[i]
            rn = np.abs(z - np.clip(z - F, l64[i], u64[i])).max()
            if np.isfinite(rn) and rn < best_rn:
                best_rn, best_z = rn, z
            if best_rn <= tol:
                break
        if best_z is not None:
            z_out[i], rn_out[i] = best_z, best_rn
    return z_out, rn_out


def _admm_shared_call(Q, A, c, lo, hi, x0, y0, eps, max_iter):
    """The shared QP blocks Q (nd, nd) and A (m, nd), broadcast over the
    lanes of c, into the batched ADMM (see :func:`_chip_admm_rung`), started
    at (x0, y0), without the engine's polish: the rung certifies through
    :func:`_structured_polish` on the host, and the engine's (nd+m)² polish
    would run for every lane."""
    from . import batch_qp
    C, m = lo.shape
    mask = torch.ones(C, m, dtype=torch.bool, device=c.device)
    return batch_qp.solve_qp_batch(
        Q[None].expand(C, -1, -1), c, A[None].expand(C, -1, -1), lo, hi,
        mask, eps=eps, max_iter=max_iter, x_init=x0, y_init=y0, polish=False)


def _chip_admm_rung(M0, q, l64, u64, todo, structure, tol, scale,
                    stats_iters, device, seconds=None):
    """Structured-QP rung with the bulk on the device: batched f64 ADMM on
    the underlying QPs of all pending lanes in one call, then the small
    active-set host polish (:func:`_structured_polish`).

    Returns (z, ok, device_flops) for the ``todo`` lanes; ok lanes certified
    at the f64 natural-residual audit, device_flops the nominal operation
    count of the ADMM work on the device.  ``seconds`` (a dict, if given)
    gains the wall time of the ADMM calls ("admm", device work and its
    fetch; span ``qpn.shared.admm``) and of the host polish ("polish";
    span ``qpn.shared.polish``, its lanes counted in
    ``shared_polish_lanes``)."""
    nd, m = structure["nd"], structure["m"]
    C = todo.size
    f64 = torch.float64

    def dev(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    Qd, Ad = dev(M0[:nd, :nd]), dev(M0[nd:nd + m, :nd])
    z_out = np.zeros((C, M0.shape[0]))
    rn_out = np.full(C, np.inf)
    pend = np.arange(C)
    dev_fl = 0.0
    # eps ladder, coarse first: most lanes' active sets identify at 1e-4
    # (half the iterations of 1e-6); polish failures retry tighter
    for eps, mi in ((1e-4, 4000), (1e-6, 4000)):
        if pend.size == 0:
            break
        idx = todo[pend]
        off = q[idx, nd:nd + m]
        # started at x = 0, y = 0 (which also starts z at the projection of
        # 0 onto the bounds): the JAX package measured a start from the
        # extragradient iterate worse, so the rung runs cold
        with METRICS.timer("qpn.shared.admm") as admm:
            sol = _admm_shared_call(
                Qd, Ad, dev(q[idx, :nd]),
                dev(l64[idx, nd + m:nd + 2 * m] - off),
                dev(u64[idx, nd + m:nd + 2 * m] - off),
                torch.zeros(idx.size, nd, dtype=f64, device=device),
                torch.zeros(idx.size, m, dtype=f64, device=device), eps, mi)
            x = METRICS.sync(sol.x.cpu).numpy()
            it_l = METRICS.sync(sol.iters.cpu).numpy().astype(np.int64)
        stats_iters[idx] += it_l
        # nominal operations: per iteration two (m, nd) matvecs and the
        # solve (~5 nd² multiply-adds), per 25-iteration block one
        # factorization
        its = float(it_l.sum())
        dev_fl += (its * (4.0 * m * nd + 10.0 * nd * nd)
                   + its / 25.0 * (4.0 / 3.0) * nd ** 3)
        METRICS.bump("shared_polish_lanes", idx.size)
        with METRICS.timer("qpn.shared.polish") as polish:
            z, rn = _structured_polish(M0, nd, m, q[idx], l64[idx],
                                       u64[idx], x, tol, scale)
        if seconds is not None:
            seconds["admm"] = seconds.get("admm", 0.0) + admm.seconds
            seconds["polish"] = seconds.get("polish", 0.0) + polish.seconds
        better = rn < rn_out[pend]
        z_out[pend[better]] = z[better]
        rn_out[pend[better]] = rn[better]
        pend = pend[~(np.isfinite(rn) & (rn <= tol))]
    ok = np.isfinite(rn_out) & (rn_out <= tol)
    return z_out, ok, dev_fl


def _escalate_generic(M0, q, l, u, z0, tol, device):
    """Generic adaptive escalation for shared-route straggler lanes, on
    ``device``.  Returns (z, converged mask, per-lane iterations)."""
    from .avi import solve_avi_batch_adaptive
    B, n = q.shape

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    res = solve_avi_batch_adaptive(
        dev(M0)[None].expand(B, -1, -1), dev(q), dev(l), dev(u), dev(z0),
        torch.ones(B, n, dtype=torch.bool, device=device), tol=tol)
    rg, conv, z, it = (METRICS.sync(a.cpu).numpy() for a in (
        res.resid, res.converged, res.z, res.iters))
    return z, conv & np.isfinite(rg), it.astype(np.int64)


def _host64(a):
    """numpy f64 copy of a tensor (a counted read) or array."""
    if isinstance(a, torch.Tensor):
        a = METRICS.sync(a.detach().cpu).numpy()
    return np.asarray(a, dtype=np.float64)


@contextlib.contextmanager
def _phase(phase_t, key, name):
    """Span ``name`` (``METRICS.timer``) whose seconds also add to
    ``phase_t[key]``: one clock reading serves both."""
    with METRICS.timer(name) as span:
        yield
    phase_t[key] = phase_t.get(key, 0.0) + span.seconds


@contextlib.contextmanager
def _matmul_precision(eg_prec):
    """f32 matrix products as ``eg_prec`` asks for inside the scope:
    "highest" (plain f32) or "tf32"; the process's setting comes back."""
    if eg_prec not in ("highest", "tf32"):
        raise ValueError(f"unknown eg_prec {eg_prec!r} (expected 'highest' "
                         "or 'tf32')")
    old = torch.backends.cuda.matmul.allow_tf32
    want = eg_prec == "tf32"
    if want == old:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = want
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def solve_kkt_avi_shared(M, q, l, u, var_mask, tol: float = 1e-8, *,
                         eg_budget: int = 20000, eg_chunk: int = 2000,
                         eg_stable_tol: Optional[int] = None,
                         eg_prec: str = "highest",
                         eg_method: str = "eg",
                         enable_prox_eg: bool = False,
                         lane_chunk: int = 1024, newton_rounds: int = 12,
                         refine_passes: int = 1,
                         structure: Optional[dict] = None,
                         mesh=None,
                         stats: Optional[dict] = None) -> AVIResult:
    """Solve a shared-matrix AVI ensemble ``M z + q ⟂ l ≤ z ≤ u``.

    ``M`` may be (n, n) or (S, n, n) with identical lanes (the caller
    asserts it); q, l, u are (S, n); tensors or numpy arrays.  The device
    work runs on q's device when q is a tensor, else on ``CONFIG.device``.
    Requires an all-true ``var_mask`` (scenario ensembles are emitted
    unpadded); callers with padding use the generic route.  Returns an
    audited :class:`AVIResult` of tensors on that device; ``stats`` (if
    given) is filled with the device operation and byte counts, the phase
    counts, the seconds of each phase (``phase_t``) and the ADMM rung's
    seconds split into ADMM and host polish (``chip_admm_t``).

    ``eg_prec``: "highest" runs the pre-pass GEMMs in plain f32; "tf32"
    allows TF32 for them (the pre-pass only needs a stable active set, and
    every acceptance is gated by the f64 audit).

    ``mesh``: the scenario axis split over the ranks of a
    ``parallel.mesh.Mesh`` for the pre-pass and round 0 (module docstring);
    ignored when S is not a multiple of ``mesh.size``.  Every rank gets the
    full result."""
    device = q.device if isinstance(q, torch.Tensor) else numeric_device()
    if not isinstance(M, torch.Tensor):
        M = np.asarray(M, dtype=np.float64)
    if M.ndim == 3:
        M = M[0]            # one lane's matrix: S copies never reach the host
    M0 = _host64(M)
    q = _host64(q)
    S, n = q.shape
    l64 = _host64(l)
    u64 = _host64(u)
    if var_mask is not None and not bool(
            torch.as_tensor(var_mask).to(torch.bool).all()):
        raise ValueError("shared route requires an unpadded ensemble")

    # EG step from the true spectral norm (power iteration on M'M, on the
    # host): the √(‖M‖₁‖M‖∞) bound overestimates σ_max on these KKT matrices
    # by 2-3×, which costs the same factor in iterations
    v = np.ones(n) / np.sqrt(n)
    for _ in range(30):
        w = M0.T @ (M0 @ v)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            break
        v = w / nw
    Lip = float(np.sqrt(max(np.linalg.norm(M0.T @ (M0 @ v)), 1e-24)))
    # EG tolerates τ < 1/L; Popov's single-GEMM iteration needs τ < 1/(2L)
    tau = np.float32((0.45 if eg_method == "popov" else 0.9)
                     / max(Lip, 1e-12))

    f32, f64 = torch.float32, torch.float64

    def dev(a, dtype=f64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if mesh is not None and S % mesh.size != 0:
        mesh = None
    # the lanes of this rank's pre-pass and round 0: all of them, or its
    # block of the scenario axis
    if mesh is None:
        mine = slice(0, S)
    else:
        from ..parallel.mesh import block_rows, gather
        mine = block_rows(mesh, S)

    M64_d = dev(M0)
    M32_d = M64_d.to(f32)
    Mt32 = M32_d.T.contiguous()
    Q64_d, L64_d, U64_d = dev(q[mine]), dev(l64[mine]), dev(u64[mine])
    Q32, L32, U32 = Q64_d.to(f32), L64_d.to(f32), U64_d.to(f32)
    Z = torch.clamp(torch.zeros_like(Q32), L32, U32)

    scale = 1.0 + float(np.abs(q).max())
    switch = max(tol, 1e-5 * scale)
    band32 = float(np.float32(1e-4 * scale))
    if eg_stable_tol is None:
        # at trajectory scale a handful of flapping labels ensemble-wide
        # should not hold the whole pre-pass hostage (the policy rounds
        # reclassify those lanes from their own basis solutions); small
        # ensembles keep the exact-stability rule
        eg_stable_tol = max(0, S // 128)
    phase_t = {}
    with METRICS.timer("qpn.shared.eg"):
        with _phase(phase_t, "eg", "qpn.shared.eg.steps"):
            max_chunks = max(1, eg_budget // eg_chunk)
            with _matmul_precision(eg_prec):
                Z, _, at_l_d, at_u_d, k = _eg_run(
                    Mt32, Q32, L32, U32, Z, tau, eg_chunk, max_chunks,
                    band32, switch, eg_stable_tol, method=eg_method,
                    mesh=mesh)
            eg_iters = int(k) * eg_chunk
        with _phase(phase_t, "eg_fetch", "qpn.shared.eg.fetch"):
            if mesh is not None:
                Z = gather(mesh, Z)
            Z64 = METRICS.sync(Z.cpu).numpy().astype(np.float64)
    METRICS.bump("shared_eg_steps", eg_iters)
    # the (lanes, n) @ (n, n) products: one or two a step and one a chunk
    METRICS.bump("shared_eg_gemms", int(k) * (
        (1 if eg_method == "popov" else 2) * eg_chunk + 1))

    z_out = Z64.copy()
    done = np.zeros(S, dtype=bool)
    iters_out = np.full(S, eg_iters, dtype=np.int64)
    lu_factored = 0
    refine_gemms = 0
    host_solves = 0
    REFINES = refine_passes

    # finite stand-ins for ±inf bounds in bval (never selected: an infinite
    # bound cannot be active)
    l_fin = np.where(np.isfinite(l64), l64, 0.0)
    u_fin = np.where(np.isfinite(u64), u64, 0.0)

    # Active-set Newton fixpoint (LCP policy iteration / Josephy-Newton),
    # wrapped in a proximal-point outer loop for the degenerate lanes these
    # LP-KKT ensembles produce (M is skew and rank-deficient, so raw
    # complementary bases are frequently singular):
    #
    #   fast path (δ=0): classify → basis solve → adopt → reclassify.  The
    #     EG start classifies with a loose band (its iterate is only
    #     ~switch-accurate); basis solutions classify with a ~zero band
    #     (their free rows satisfy F=0 exactly, so the sign split is the
    #     policy-iteration update).
    #   degenerate ladder (δ>0): on a singular factorization or a cycling
    #     classification, the lane gets a proximal δ.  M+δI is strongly
    #     monotone, so every basis is nonsingular and the inner policy
    #     iteration on the prox subproblem (δ, z_ref fixed) is well-posed;
    #     once the prox subproblem's own natural residual rp meets tol, the
    #     lane recentres z_ref at the prox solution (the proximal-point
    #     outer step, convergent for monotone F) and shrinks δ.  At the
    #     fixed point the prox solution solves the original problem, which
    #     the original-residual audit rn certifies.
    # Fc is filled lazily: round-0 advances write it from their own basis
    # solutions, singular round-0 lanes get a small host GEMM afterwards.
    Zc, Fc = Z64.copy(), np.zeros_like(Z64)
    band_lane = np.full(S, 1e-4 * scale)
    delta_lane = np.zeros(S)
    zref = Z64.copy()
    delta0 = 1e-5 * max(Lip, 1.0)       # f32-visible relative to ‖M‖
    delta_min = 1e-6 * max(Lip, 1.0)
    seen_cls: list[set] = [set() for _ in range(S)]
    active = np.ones(S, dtype=bool)     # lanes still in the Newton loop
    rung = np.zeros(S, dtype=np.int64)
    # escalation ladder per lane: wide-band retry first (a boundary row
    # misread from the ~switch-accurate EG point is the common failure, and
    # reclassifying the same point with a wider band fixes it), then the
    # proximal δ ladder
    _LADDER = ((1e-2, 0.0), (1e-4, 1.0), (1e-4, 30.0), (1e-3, 900.0))

    def _bump_rung(lane):
        rung[lane] += 1
        if rung[lane] > len(_LADDER):
            active[lane] = False
            return
        band_rel, dmul = _LADDER[rung[lane] - 1]
        band_lane[lane] = band_rel * scale
        delta_lane[lane] = dmul * delta0
        zref[lane] = Zc[lane]
        seen_cls[lane].clear()

    hash_w = _hash_weights(n)
    progress_rd = [0]    # last round with real progress (stall detector)

    def _absorb(sel, zc, Fchunk, rn, rp, rd):
        """Per-chunk policy-round bookkeeping: accept audited lanes, adopt
        finite solutions as the next classification point, recentre the
        prox reference where the subproblem converged, escalate singular
        factorizations."""
        ok = np.isfinite(rn) & (rn <= tol)
        z_out[sel[ok]] = zc[ok]
        done[sel[ok]] = True
        fin = np.isfinite(rn)
        # inner policy step: adopt every finite basis solution as the next
        # classification point (no descent requirement: Newton on the
        # natural map is not monotone; cycling is caught by the
        # fingerprints) and classify it with a ~zero band
        adv = ~ok & fin
        Zc[sel[adv]] = zc[adv]
        Fc[sel[adv]] = Fchunk[adv]
        band_lane[sel[adv]] = 1e-9 * scale
        # outer prox step: the prox subproblem is solved (rp ≤ tol) but
        # the original residual is not: recentre z_ref and shrink δ
        rec = adv & (rp <= max(tol, 1e-10 * scale))
        for lane_i in sel[rec]:
            zref[lane_i] = Zc[lane_i]
            seen_cls[lane_i].clear()
        delta_lane[sel[rec]] = np.maximum(
            delta_lane[sel[rec]] * 0.3, delta_min)
        # progress = a certification or an outer prox recentring (a lane
        # legitimately descending its δ ladder must not trip the stall
        # detector even if its first rn ≤ tol is rounds away)
        if ok.any() or rec.any():
            progress_rd[0] = rd
        # singular factorization even with this δ: escalate the ladder
        for lane_i in sel[~ok & ~fin]:
            _bump_rung(lane_i)

    # --- fused first policy round (δ = 0, all lanes) -------------------
    # Labels, masks and bound values stay on the device: the EG
    # classification feeds the basis solve directly, the host fetches the
    # audited f64 results.  This is the round that solves ~all lanes.  Under
    # a mesh it runs as one call: each rank factorizes its own S/size lanes
    # and every rank gets all of them back.
    with METRICS.timer("qpn.shared.round0"):
        sing0: list = []
        r0_chunk = S if mesh is not None else lane_chunk
        for ofs in range(0, S, r0_chunk):
            sel = np.arange(ofs, min(ofs + r0_chunk, S))
            sl = slice(ofs, ofs + sel.size)
            with _phase(phase_t, "round0_compute",
                        "qpn.shared.round0.compute"):
                if mesh is None:
                    zc_d, rn_d, h_d = _round0_solve(
                        M32_d, M64_d, at_l_d[sl], at_u_d[sl], Q64_d[sl],
                        L64_d[sl], U64_d[sl], REFINES)
                else:
                    zc_d, rn_d, h_d = (gather(mesh, a) for a in _round0_solve(
                        M32_d, M64_d, at_l_d, at_u_d, Q64_d, L64_d, U64_d,
                        REFINES))
                lu_factored += sel.size
                refine_gemms += (REFINES + 1) * sel.size
                iters_out[sel] += 1
                rn = METRICS.sync(rn_d.cpu).numpy()   # blocks on the compute
            with _phase(phase_t, "round0_fetch", "qpn.shared.round0.fetch"):
                fin = np.isfinite(rn)
                adv = fin & (rn > tol)
                zc = METRICS.sync(zc_d.cpu).numpy()
                hs = METRICS.sync(h_d.cpu).numpy()
                # a lane that advances through the δ ladder classifies next
                # from its own basis solution: its natural map, for those
                # lanes only
                Fchunk = np.zeros_like(zc)
                Fchunk[adv] = zc[adv] @ M0.T + q[sel[adv]]
                sing0.extend(sel[~fin].tolist())
                _absorb(sel, zc, Fchunk, rn, rn, 0)  # δ=0 ⇒ prox resid = rn
            # record the round-0 fingerprints so a lane re-presenting the
            # same classification later counts as cycling: the device hash
            # and the host loop's _label_hash are the same function
            for k, lane in enumerate(sel):
                seen_cls[lane].add(int(hs[k]))
    METRICS.bump("shared_round0_left", S - int(done.sum()))
    with _phase(phase_t, "newton_rounds", "qpn.shared.ladder"):
        # lanes whose round-0 factorization was singular keep the EG iterate
        # as their classification point: fill their natural map now
        ladder = np.ones(S, dtype=bool)
        # newton_rounds from here on covers the δ-ladder only
        if sing0:
            s0 = np.asarray(sing0, dtype=np.int64)
            Fc[s0] = Zc[s0] @ M0.T + q[s0]
            if structure is not None:
                # round-0-singular lanes are the dual-degenerate class: the δ
                # ladder is the wrong tool for them, so they skip it and go
                # straight to the structured-QP rung
                ladder[s0] = False

        for rd in range(1, newton_rounds):
            todo = np.flatnonzero(~done & active & ladder)
            if todo.size == 0:
                break
            if rd - progress_rd[0] >= 8:
                # stall: no lane has certified for 8 consecutive rounds; the
                # remaining lanes are ladder-cyclers: hand them to the rungs
                break
            # classify from the prox natural map s = z − (F + δ(z − z_ref));
            # for δ=0 lanes this is the original map
            Fp = Fc[todo] + delta_lane[todo, None] * (Zc[todo]
                                                      - zref[todo])
            at_l, at_u = _classify(Zc[todo], Fp, l64[todo], u64[todo],
                                   band_lane[todo, None])
            free = ~(at_l | at_u)
            bval = np.where(at_l, l_fin[todo], u_fin[todo])
            # cycling inside one (δ, z_ref) context: escalate the ladder
            # (fingerprints from the same hash stream as the device round 0)
            fps = _label_hash(at_l, at_u, hash_w)
            fresh = np.ones(todo.size, dtype=bool)
            for k, lane in enumerate(todo):
                fp = int(fps[k])
                if fp in seen_cls[lane]:
                    fresh[k] = False
                    _bump_rung(lane)
                else:
                    seen_cls[lane].add(fp)
            todo = todo[fresh]
            if todo.size == 0:
                continue
            free, bval = free[fresh], bval[fresh]
            for ofs in range(0, todo.size, lane_chunk):
                sel = todo[ofs:ofs + lane_chunk]
                sl = slice(ofs, ofs + sel.size)
                if sel.size <= 24:
                    # straggler tail on host f64 LAPACK: exact f64 needs no
                    # refinement and no f32 singularity handling, and the δ
                    # ladder converges in fewer rounds
                    zc, Fchunk, rn, rp = _host_basis_solve(
                        M0, free[sl], bval[sl], q[sel], l64[sel], u64[sel],
                        delta_lane[sel], zref[sel])
                    host_solves += sel.size
                    iters_out[sel] += 1
                else:
                    outs = _basis_solve_refine(
                        M32_d, M64_d, dev(free[sl], torch.bool),
                        dev(bval[sl]), dev(q[sel]), dev(l64[sel]),
                        dev(u64[sel]), dev(delta_lane[sel]), dev(zref[sel]),
                        REFINES)
                    lu_factored += sel.size
                    refine_gemms += (REFINES + 1) * sel.size
                    iters_out[sel] += 1
                    zc, Fchunk, rn, rp = (METRICS.sync(a.cpu).numpy()
                                          for a in outs)
                _absorb(sel, zc, Fchunk, rn, rp, rd)

    # everything after the ladder and before the final audit: the ADMM rung,
    # the ADMM route, the host lstsq, the prox-EG rung, the generic
    # escalation
    with METRICS.timer("qpn.shared.rungs"):
        # structured rung first, for any straggler count: ADMM on the
        # underlying QPs on the device and the small active-set host polish.
        # One path keeps the straggler population's resolution
        # deterministic.
        chip_admm_flops = 0.0
        rung_t = {}
        with _phase(phase_t, "chip_admm_rung", "qpn.shared.rungs.chip_admm"):
            todo = np.flatnonzero(~done)
            if todo.size and structure is not None:
                METRICS.bump("shared_kkt_chip_admm_rung", todo.size)
                zc, ok, chip_admm_flops = _chip_admm_rung(
                    M0, q, l64, u64, todo, structure, tol, scale, iters_out,
                    device, rung_t)
                z_out[todo[ok]] = zc[ok]
                done[todo[ok]] = True

        # the ADMM route of the structured solve (ADMM with its own polish,
        # dual reconstruction, Newton polish) for the remnants
        with _phase(phase_t, "admm_rung", "qpn.shared.rungs.admm_route"):
            todo = np.flatnonzero(~done)
            if todo.size and structure is not None:
                from .avi import _solve_kkt_avi_admm
                METRICS.bump("shared_kkt_admm_escalation", todo.size)
                sub = _solve_kkt_avi_admm(
                    M64_d[None].expand(todo.size, -1, -1), dev(q[todo]),
                    dev(l64[todo]), dev(u64[todo]),
                    torch.ones(todo.size, n, dtype=torch.bool,
                               device=device),
                    structure, tol)
                ok = METRICS.sync(sub.converged.cpu).numpy()
                z_out[todo[ok]] = METRICS.sync(sub.z.cpu).numpy()[ok]
                done[todo[ok]] = True
                iters_out[todo] += METRICS.sync(
                    sub.iters.cpu).numpy().astype(np.int64)

        # exact host f64 min-norm solve for lanes whose f32 factorization
        # could not be refined: degenerate classifications give singular but
        # consistent basis systems (the solution face is an affine set), and
        # lstsq picks a valid point where np.linalg.solve returns garbage
        # without raising.  Two classification bands tried per lane.
        with _phase(phase_t, "host_lstsq", "qpn.shared.rungs.lstsq"):
            for band in (1e-4 * scale, 1e-2 * scale):
                todo = np.flatnonzero(~done)
                if todo.size == 0:
                    break
                at_l, at_u = _classify(Zc[todo], Fc[todo], l64[todo],
                                       u64[todo], band)
                free = ~(at_l | at_u)
                bval = np.where(at_l, l_fin[todo], u_fin[todo])
                A = np.where(free[:, :, None], M0[None], np.eye(n)[None])
                rhs = np.where(free, -q[todo], bval)
                # gelsy (pivoted QR) over the default gelsd (SVD): the same
                # min-norm answer for these consistent systems at less cost
                import scipy.linalg as sla
                zc = np.stack([sla.lstsq(A[i], rhs[i], lapack_driver="gelsy",
                                         check_finite=False)[0]
                               for i in range(todo.size)])
                host_solves += todo.size
                iters_out[todo] += 1
                rn, _ = _nat_resid_shared(M0, q[todo], l64[todo], u64[todo],
                                          zc)
                ok = np.isfinite(rn) & (rn <= tol)
                z_out[todo[ok]] = zc[ok]
                done[todo[ok]] = True

        # opt-in batched proximal-point rung on the device: it solves mildly
        # degenerate monotone-dominant ensembles without host work, but
        # first-order methods crawl on robust_avoid's heavily skew,
        # rank-deficient lane class, so it is off the default path
        with _phase(phase_t, "prox_eg_rung", "qpn.shared.rungs.prox_eg"):
            todo = np.flatnonzero(~done)
            if enable_prox_eg and todo.size >= 8:
                METRICS.bump("shared_kkt_prox_eg_rung", todo.size)
                delta_p = 0.05 * max(Lip, 1e-12)
                tau_p = np.float32(0.9 / (Lip + delta_p))
                zp_d, rnp_d, kp = _prox_eg_rung(
                    M32_d, M64_d, dev(q[todo]), dev(l64[todo]),
                    dev(u64[todo]), dev(Zc[todo]), np.float32(delta_p),
                    tau_p, tol, 1000, 40)
                zp = METRICS.sync(zp_d.cpu).numpy()
                rnp = METRICS.sync(rnp_d.cpu).numpy()
                ok = np.isfinite(rnp) & (rnp <= tol)
                z_out[todo[ok]] = zp[ok]
                done[todo[ok]] = True
                iters_out[todo] += int(kp) * 1000

        # last resort: the generic adaptive per-lane solver (audited like
        # everything else); scenario stragglers here are genuinely hard
        # lanes
        with _phase(phase_t, "escalations", "qpn.shared.rungs.generic"):
            todo = np.flatnonzero(~done)
            if todo.size:
                METRICS.bump("shared_kkt_generic_escalation", todo.size)
                zg, ok, it_g = _escalate_generic(M0, q[todo], l64[todo],
                                                 u64[todo], Z64[todo], tol,
                                                 device)
                z_out[todo[ok]] = zg[ok]
                done[todo[ok]] = True
                iters_out[todo] += it_g
    with _phase(phase_t, "final_audit", "qpn.shared.audit"):
        resid, _ = _nat_resid_shared(M0, q, l64, u64, z_out)
    converged = resid <= tol
    METRICS.bump("shared_kkt_solves", int(converged.sum()))
    METRICS.bump("shared_host_solves", host_solves)

    if stats is not None:
        # device operation ledger (host LAPACK solves and the escalation
        # rungs excluded; the f64 refinement GEMMs are counted at their
        # nominal operation count)
        gemm = 2.0 * S * n * n
        eg_fl = eg_iters * 2.0 * gemm + (eg_iters / eg_chunk + 1) * gemm
        lu_fl = lu_factored * (2.0 / 3.0) * n ** 3
        tri_fl = (lu_factored + refine_gemms) * 2.0 * n * n * 2.0
        ref_fl = refine_gemms * 2.0 * n * n
        stats.update(dict(
            eg_iters=eg_iters, lu_factored=lu_factored,
            refine_gemms=refine_gemms, host_solves=host_solves,
            device_flops=eg_fl + lu_fl + tri_fl + ref_fl + chip_admm_flops,
            device_bytes=4.0 * (eg_iters * (n * n + 3.0 * S * n)
                                + lu_factored * 2.0 * n * n),
            phase_t={k: round(v, 3) for k, v in phase_t.items()},
            # the ADMM rung's seconds, split: the ADMM calls on the device
            # and the host polish (the port's own entry; phase_t keeps the
            # JAX package's keys)
            chip_admm_t={k: round(v, 3) for k, v in rung_t.items()},
        ))

    return AVIResult(z=dev(z_out), resid=dev(resid),
                     iters=torch.as_tensor(iters_out, device=device),
                     converged=torch.as_tensor(converged, device=device))
