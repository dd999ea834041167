"""Equilibrium algorithm: verification, QEP assembly, solve loop (PyTorch
port of ``qpn_tpu/algorithm.py``).

Re-implements the reference's L3/L4 layers:

* ``verify_solution`` / ``check_qp_convexity`` (qp_processing.jl:39-149) with
  batched least-squares dual recovery and an LCP fallback solved by the
  batched AVI kernel instead of PATH.
* ``process_qp`` (qp_processing.jl:151-241): per-node optimality across the
  cartesian product of child solution pieces, generating per-combo solution
  graphs.
* ``combine`` + the lazy ``IntersectionRoot`` product iterator
  (qp_processing.jl:243-291, intersection.jl) including the red-zone
  exclusion of the all-complements combination.
* ``solve_qep`` GAVI assembly (avi.jl:205-377, 382-444): per-player labeled
  blocks with ξ-consensus top rows, combined into one GAVI and solved by the
  semismooth-Newton kernel.
* ``solve_base`` outer fixed-point loop (algorithm.jl:1-127) with
  random-projection cycling detection.

The outer loop stays a thin host loop (levels as data, recursion over
depth); the batched numeric work underneath (ADMM, AVI, Lemke, the
feasibility screen) runs on ``CONFIG.device``.  The f64 sign-split glue stays
on the host on every device: the dual recovery of
:func:`verify_solutions_batch` and the multi-start choice of
``ops.avi.solve_avi``.  ``solve(checkpoint_path=...)`` saves the iterate
each outer iteration (``utils/checkpoint.py``); ensembles of ``solve`` calls
fuse their batched work under the lockstep broker
(``parallel/lockstep.solve_many_lockstep``).
"""

from __future__ import annotations

import itertools
import logging
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import numeric_device
from .utils import native
from .enumeration import process_solution_graph
from .geometry import setops
from .geometry.project import project as project_poly
from .geometry.poly import Poly, PolyUnion, intersect
from .network import QPNet
from .ops import batch_qp
from .ops.avi import GAVI, Status, solve_gavi
from .utils.metrics import METRICS

logger = logging.getLogger("qpn_tpu_torch")

# --------------------------------------------------------------------------
#  QP solve + convexity audit — qp_processing.jl:1-55
# --------------------------------------------------------------------------

def solve_qp(Q, q, A, l, u):
    """Plain convex QP solve (qp_processing.jl:1-11 OSQP branch)."""
    sol = batch_qp.solve_qp_np(Q, q, A, l, u)
    if sol.status not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
        raise RuntimeError(f"Solver failure. Status value is {sol.status}.")
    return np.asarray(sol.x)


def check_qp_convexity(Q, A, l, u, dec_inds, pid, tol: float = 1e-6):
    """Nullspace-reduced Hessian eigenvalue audit (qp_processing.jl:39-55)."""
    p = Poly(A, l, u)
    impl, vals = setops.implicit_bounds(p, tol=1e-4)
    Ae = A[impl][:, dec_inds] if np.any(impl) else np.zeros((0, len(dec_inds)))
    if Ae.size:
        U, S, Vt = np.linalg.svd(Ae, full_matrices=True)
        r = int(np.sum(S > 1e-10))
        Z = Vt.T[:, r:]
    else:
        Z = np.eye(len(dec_inds))
    QQ = Z.T @ Q[np.ix_(dec_inds, dec_inds)] @ Z
    evals = np.linalg.eigvalsh(QQ + QQ.T)
    if not np.all(evals > -tol):
        raise RuntimeError(f"QP {pid} is not convex. Exiting.")


# --------------------------------------------------------------------------
#  verify_solution — qp_processing.jl:57-149
# --------------------------------------------------------------------------

def verify_solution(qp, pid, constraints: Sequence[Poly], dec_inds, x,
                    check_convexity: bool = False, tol: float = 1e-4,
                    feas_tol: float = 1e-3):
    """KKT verification of x for one node's QP given fixed other-player vars.

    ``feas_tol`` gates feasibility (QPNetOptions.verify_feas_tol; the
    reference hardcodes 1e-3 and misreports it as ``tol``,
    qp_processing.jl:86-89).

    Returns namespace(solution: bool, lam: array | None, e: str | None)."""
    x = np.asarray(x, dtype=np.float64)
    dec_inds = list(dec_inds)
    Q = qp.f.Q[dec_inds, :]
    q = qp.f.q[dec_inds]
    q_tilde = Q @ x + q

    if constraints:
        A = np.vstack([c.A for c in constraints])
        l = np.concatenate([c.l for c in constraints])
        u = np.concatenate([c.u for c in constraints])
    else:
        A = np.zeros((0, len(x)))
        l = np.zeros(0)
        u = np.zeros(0)
    m = A.shape[0]

    if check_convexity:
        check_qp_convexity(qp.f.Q, A, l, u, dec_inds, pid)

    feasible = all(c.contains(x, tol=feas_tol) for c in constraints)
    if not feasible:
        return SimpleNamespace(
            solution=False, lam=None,
            e="Current point is infeasible when using tolerance "
              f"{feas_tol}.")

    if m == 0:
        if np.allclose(q_tilde, 0.0, atol=tol):
            return SimpleNamespace(solution=True, lam=np.zeros(0), e=None)
        return SimpleNamespace(solution=False, lam=None,
                               e="Current point is suboptimal")
    ax = A @ x
    pos = ax < l + 1e-2          # lower-active window (qp_processing.jl:98)
    neg = ax > u - 1e-2
    both = pos & neg
    pos = pos & ~both
    neg = neg & ~both

    Ap = A[pos][:, dec_inds]
    An = A[neg][:, dec_inds]
    A0 = A[both][:, dec_inds]
    n_p, n_n = int(pos.sum()), int(neg.sum())

    Abar = np.hstack([Ap.T, -An.T, A0.T])
    if Abar.shape[1] > 0:
        lam_ls, *_ = np.linalg.lstsq(Abar, q_tilde, rcond=None)
        lam_p = lam_ls[:n_p]
        lam_n = lam_ls[n_p:n_p + n_n]
        lam_0 = lam_ls[n_p + n_n:]
        if np.all(lam_p > -tol) and np.all(lam_n > -tol) and \
                np.allclose(Abar @ lam_ls, q_tilde, atol=tol):
            lam_out = np.zeros(m)
            lam_out[pos] = lam_p
            lam_out[neg] = -lam_n
            lam_out[both] = lam_0
            return SimpleNamespace(solution=True, lam=lam_out, e=None)

    # dual LCP fallback (qp_processing.jl:128-146): signed least squares
    #   min ½ λ'(Ad Ad')λ − (Ad q̃)'λ   s.t.  sign bounds by activity class
    lb = np.where(neg | both, -np.inf, 0.0)
    ub = np.where(pos | both, np.inf, 0.0)
    Ad = A[:, dec_inds]
    try:
        lam = solve_qp(Ad @ Ad.T, -Ad @ q_tilde, np.eye(m), lb, ub)
        # fixed 1e-4 acceptance independent of `tol`: reference parity
        # (qp_processing.jl:140 hard-codes atol=1e-4 in the fallback)
        if np.allclose(Ad.T @ lam, q_tilde, atol=1e-4):
            return SimpleNamespace(solution=True, lam=lam, e=None)
        return SimpleNamespace(solution=False, lam=lam,
                               e="Current point is suboptimal (via QP).")
    except RuntimeError as ee:
        return SimpleNamespace(solution=False, lam=None,
                               e=f"Solving for duals failed. {ee}")


# --------------------------------------------------------------------------
#  batched verification — (nodes × piece-combos) in one kernel
# --------------------------------------------------------------------------

def verify_solutions_batch(tasks, x, tol: float = 1e-4,
                           feas_tol: float = 1e-3):
    """Batched KKT verification over a list of (qp, constraints, dec_inds)
    tasks at the shared point x — the fused form of §3.3's observation that
    verify_solution is a pure function of (qp, constraints, x), batched over
    the (nodes × child-piece-combos) axis (SURVEY §2.3 row 1–2).

    The common path (feasibility + masked least-squares dual recovery + sign
    checks) runs as ONE batched Cholesky solve over padded stacks, in f64 on
    the host (LAPACK through CPU tensors) whatever ``CONFIG.device`` is;
    only items the LSQ path cannot certify fall back to the per-item
    dual-LCP solve."""
    import torch
    from .ops.linalg import chol_solve

    B = len(tasks)
    if B == 0:
        return []
    x = np.asarray(x, dtype=np.float64)
    n = len(x)

    prepared = []
    m_max, d_max = 1, 1
    for (qp, constraints, dec_inds) in tasks:
        dec_inds = list(dec_inds)
        if constraints:
            A = np.vstack([c.A for c in constraints])
            l = np.concatenate([c.l for c in constraints])
            u = np.concatenate([c.u for c in constraints])
        else:
            A = np.zeros((0, n))
            l = np.zeros(0)
            u = np.zeros(0)
        q_t = qp.f.Q[dec_inds, :] @ x + qp.f.q[dec_inds]
        feasible = all(c.contains(x, tol=feas_tol) for c in constraints)
        prepared.append((A, l, u, q_t, dec_inds, feasible))
        m_max = max(m_max, A.shape[0])
        d_max = max(d_max, len(dec_inds))

    from .config import row_bucket, bucket
    m_p = row_bucket(m_max)
    d_p = bucket(d_max, (8, 32, 128))
    Ad = np.zeros((B, m_p, d_p))       # signed active-row matrix (rows=duals)
    qt = np.zeros((B, d_p))
    act_mask = np.zeros((B, m_p), dtype=bool)
    results = [None] * B
    sign_class = np.zeros((B, m_p), dtype=np.int8)  # 1=pos,-1=neg,2=both

    for i, (A, l, u, q_t, dec_inds, feasible) in enumerate(prepared):
        m = A.shape[0]
        if not feasible:
            results[i] = SimpleNamespace(
                solution=False, lam=None,
                e="Current point is infeasible when using tolerance "
                  f"{feas_tol}.")
            continue
        if m == 0:
            ok = np.allclose(q_t, 0.0, atol=tol)
            results[i] = SimpleNamespace(
                solution=bool(ok), lam=np.zeros(0) if ok else None,
                e=None if ok else "Current point is suboptimal")
            continue
        ax = A @ x
        pos = ax < l + 1e-2
        neg = ax > u - 1e-2
        both = pos & neg
        pos = pos & ~both
        neg = neg & ~both
        Adec = A[:, dec_inds]
        signed = np.where(pos[:, None], Adec,
                          np.where(neg[:, None], -Adec,
                                   np.where(both[:, None], Adec, 0.0)))
        Ad[i, :m, :len(dec_inds)] = signed
        qt[i, :len(dec_inds)] = q_t
        act_mask[i, :m] = pos | neg | both
        sign_class[i, :m] = np.where(both, 2,
                            np.where(pos, 1, np.where(neg, -1, 0)))

    # masked least squares: lam = argmin ||Ad' lam - qt|| with inactive rows
    # pinned to 0 via a large diagonal penalty.
    #
    # Sign-refinement rounds: the unconstrained LSQ dual of a degenerate
    # active set often carries wrong-signed entries even when a valid
    # signed dual exists.  An NNLS-style clamp: pin the wrong-signed
    # single-sided rows to 0 and re-solve — each round reuses the SAME G
    # with a new pin diagonal, one batched Cholesky.  Acceptance stays
    # certificate-based (signs AND stationarity residual), so refinement can
    # only move tasks from the expensive fallback to the cheap path, never
    # change an outcome.
    # The whole refinement is host f64 on every device: the certify decision
    # is an f64 sign split against coordinated tolerances (1e-2 activity /
    # 1e-4 duals, qp_processing.jl:98-127), and rounding it differently
    # measurably flips enumeration trajectories (robust_avoid: 71 pieces /
    # 8 QEP against 60 / 7 in the JAX package's history).
    Adj = torch.as_tensor(Ad)
    qtj = torch.as_tensor(qt)
    G0 = torch.einsum("bmd,bkd->bmk", Adj, Adj)
    rhs = torch.einsum("bmd,bd->bm", Adj, qtj)
    eye_m = torch.eye(m_p, dtype=torch.float64)[None]
    sc_all = sign_class
    single = (sc_all == 1) | (sc_all == -1)
    act_work = act_mask.copy()
    certified = np.zeros(B, dtype=bool)
    lam_best = np.zeros((B, m_p))
    # scale-aware pin: 1e8 × the lane's own Gram scale keeps inactive
    # λ ≈ rhs/pin ~ 1e-8 (zero at tol) with bounded dynamic range
    gscale = G0.abs().amax((1, 2)).clamp_min(1.0)
    last_sign_ok = np.zeros(B, dtype=bool)
    last_resid_ok = np.zeros(B, dtype=bool)
    for _round in range(3):
        pin = torch.where(torch.as_tensor(act_work), 0.0,
                          1e8 * gscale[:, None])
        lam_j = chol_solve(G0 + (1e-12 + pin)[:, :, None] * eye_m, rhs)
        lam_all = lam_j.numpy()
        resid_all = (torch.einsum("bmd,bm->bd", Adj, lam_j) - qtj).numpy()
        lam_all = np.where(act_work, lam_all, 0.0)
        bad_sign = single & act_work & (lam_all <= -tol)
        ok_signs_b = ~bad_sign.any(axis=1)
        ok_resid_b = np.abs(resid_all).max(axis=1) <= tol
        last_sign_ok, last_resid_ok = ok_signs_b, ok_resid_b
        newly = ~certified & ok_signs_b & ok_resid_b
        lam_best[newly] = lam_all[newly]
        certified |= newly
        todo = ~certified & bad_sign.any(axis=1)
        if not todo.any():
            break
        act_work = act_work & ~(bad_sign & todo[:, None])
        if _round:
            METRICS.bump("verify_sign_refine_rounds")

    # fallback-cause accounting (weak #8): a lane with clean signs but a
    # stationarity residual above tol lost the fast path to conditioning /
    # rank issues; persistent wrong signs mean no LSQ-certifiable dual
    for i in range(B):
        if results[i] is None and not certified[i]:
            METRICS.bump("verify_fallback_resid" if last_sign_ok[i]
                         else "verify_fallback_sign")

    for i, (A, l, u, q_t, dec_inds, feasible) in enumerate(prepared):
        if results[i] is not None:
            continue
        if certified[i]:
            m = A.shape[0]
            lam = lam_best[i, :m]
            sc = sign_class[i, :m]
            lam_out = np.zeros(m)
            lam_out[sc == 1] = lam[sc == 1]
            lam_out[sc == -1] = -lam[sc == -1]
            lam_out[sc == 2] = lam[sc == 2]
            results[i] = SimpleNamespace(solution=True, lam=lam_out, e=None)

    # fallback: dual LCP for unresolved tasks — batched into ONE padded QP
    # kernel call (qp_processing.jl:128-146 semantics per item; the serial
    # per-item loop was the dominant cost of trajectory-class verifies,
    # ~0.15s × hundreds of tasks)
    unresolved = [i for i in range(B) if results[i] is None]
    if unresolved:
        Bu = len(unresolved)
        mu = max(prepared[i][0].shape[0] for i in unresolved)
        du = max(len(prepared[i][4]) for i in unresolved)
        Au = np.zeros((Bu, mu, du))            # unsigned active-row stacks
        qtu = np.zeros((Bu, du))
        lbu = np.zeros((Bu, mu))
        ubu = np.zeros((Bu, mu))
        Pu = np.zeros((Bu, mu, mu))
        for k, i in enumerate(unresolved):
            A, l, u, q_t, dec_inds, feasible = prepared[i]
            m = A.shape[0]
            ax = A @ x
            pos = ax < l + 1e-2
            neg = ax > u - 1e-2
            both = pos & neg
            Au[k, :m, :len(dec_inds)] = A[:, dec_inds]
            qtu[k, :len(dec_inds)] = q_t
            lbu[k, :m] = np.where(neg | both, -np.inf, 0.0)
            ubu[k, :m] = np.where(pos | both, np.inf, 0.0)
            Pu[k] = Au[k] @ Au[k].swapaxes(0, 1)
            Pu[k, range(m, mu), range(m, mu)] = 1.0     # padded λ rows: SPD
        qu = -np.einsum("bmd,bd->bm", Au, qtu)
        eye = np.repeat(np.eye(mu)[None], Bu, axis=0)
        sols = batch_qp.solve_qp_batch_padded(
            Pu, qu, eye, lbu, ubu, np.ones((Bu, mu), dtype=bool))
        st = np.asarray(sols.status)
        lam_u = np.asarray(sols.x)
        for k, i in enumerate(unresolved):
            A, l, u, q_t, dec_inds, feasible = prepared[i]
            m = A.shape[0]
            if st[k] not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
                results[i] = SimpleNamespace(
                    solution=False, lam=None,
                    e=f"Solving for duals failed. Solver failure. "
                      f"Status value is {st[k]}.")
                continue
            lam = lam_u[k, :m]
            # fixed 1e-4 acceptance independent of `tol`: reference parity
            # (qp_processing.jl:140 hard-codes atol=1e-4 in the fallback)
            if np.allclose(A[:, dec_inds].T @ lam, q_t, atol=1e-4):
                results[i] = SimpleNamespace(solution=True, lam=lam, e=None)
            else:
                results[i] = SimpleNamespace(
                    solution=False, lam=lam,
                    e="Current point is suboptimal (via QP).")
        METRICS.bump("verify_lcp_fallback_batched", Bu)
    METRICS.bump("verify_batched", B)
    return results


# --------------------------------------------------------------------------
#  process_qp — qp_processing.jl:151-241
# --------------------------------------------------------------------------

def _prepare_qp_tasks(qpn: QPNet, pid: int, x, S: Dict[int, PolyUnion]):
    """Phase 1 of process_qp: build the (qp, constraints, dec_inds)
    verification tasks for every child-piece combination of one node."""
    qp = qpn.qps[pid]
    base_constraints = [qpn.constraints[c].poly for c in qp.constraint_indices]
    dec_inds = qpn.decision_inds(pid)
    check_convexity = qpn.options.check_convexity

    child_inds = sorted(qpn.network_edges[pid])
    if child_inds:
        cardinalities = [range(len(S[j])) for j in child_inds]
        if any(len(c) < 1 for c in cardinalities):
            raise RuntimeError("Solution graphs were not properly populated.")
        combos = list(itertools.product(*cardinalities))
        logger.debug("node %d: %d subpiece combinations", pid, len(combos))
        combo_constraints = []
        for combo in combos:
            children_polys = [S[j][ji] for j, ji in zip(child_inds, combo)]
            combo_constraints.append(base_constraints + children_polys)
        tasks = [(qp, cons, dec_inds) for cons in combo_constraints]
    else:
        combos = [()]
        combo_constraints = [base_constraints]
        tasks = [(qp, base_constraints, dec_inds)]
    if check_convexity:
        _audit_convexity(qp, pid, x, dec_inds, base_constraints,
                         combo_constraints)
    return SimpleNamespace(qp=qp, base_constraints=base_constraints,
                           dec_inds=dec_inds, child_inds=child_inds,
                           combos=combos, combo_constraints=combo_constraints,
                           tasks=tasks)


def _audit_convexity(qp, pid, x, dec_inds, base_constraints,
                     combo_constraints):
    """Reference semantics audit the nullspace-reduced Hessian PER child-
    piece combination with the child polys appended (check_qp_convexity is
    invoked inside verify_solution, qp_processing.jl:69).  Child polys can
    only pin MORE directions, so the combo nullspace is a subspace of the
    base nullspace: if the base audit passes, every combo passes — only on
    base failure does each combo need its own (possibly passing) audit."""
    def _stack(cons):
        if not cons:
            return (np.zeros((0, len(x))), np.zeros(0), np.zeros(0))
        return (np.vstack([c.A for c in cons]),
                np.concatenate([c.l for c in cons]),
                np.concatenate([c.u for c in cons]))

    try:
        check_qp_convexity(qp.f.Q, *_stack(base_constraints), dec_inds, pid)
        return
    except RuntimeError:
        pass
    for cons in combo_constraints:
        check_qp_convexity(qp.f.Q, *_stack(cons), dec_inds, pid)


def _finish_process_qp(qpn: QPNet, pid: int, x, prep, verifies,
                       exploration_vertices: int = 0,
                       rng: Optional[np.random.Generator] = None,
                       request=frozenset(), make_requests: bool = False):
    """Phase 2 of process_qp: consume verification results, generate and
    combine the per-combo solution graphs (qp_processing.jl:188-224).

    ``request`` (directions the PARENT level wants this node's solution map
    to extend toward) is threaded into the piece enumeration, where
    comp_indices grants the matching boundary labels (avi_solutions.jl:
    522-541).  With ``make_requests`` this node also IDENTIFIES new requests
    for its own children: active verification duals on child-graph rows map
    through the projection parents (identify_request, avi.jl:479-506) —
    the live version of the flow the reference keeps dormant behind
    requests.jl:22."""
    qp = prep.qp
    identified_request = set()
    gen_solution_graphs = (pid not in qpn.network_depth_map[1]) \
        or qpn.options.gen_solution_map
    if prep.child_inds:
        results = []
        failing = []          # every non-vacuous failing combo, in order
        first_err = None
        for combo, appended, ret in zip(prep.combos, prep.combo_constraints,
                                        verifies):
            if not ret.solution:
                # Vacuous-combo guard (deliberate robustness upgrade over
                # qp_processing.jl:186-190): a child-piece combination whose
                # region is EMPTY at the current parameters contributes
                # nothing to S = ⋃ₚ ⋂ᵢ Zᵢᵖ, so "x is not optimal under it"
                # is vacuous.  The reference forwards such combos to the QEP
                # assembler, building an infeasible GAVI that kills PATH
                # ("unbounded or ill-conditioned", avi.jl:413-427) — the
                # observed robust_avoid_simple num_obj=3 failure mode.
                if ret.e and "infeasible" in str(ret.e) \
                        and _combo_region_vacuous(prep, appended, x):
                    METRICS.bump("vacuous_combos")
                    continue
                # Request-extension combos: with make_requests, children's
                # maps are deliberately extended toward pieces that do NOT
                # contain the current point (requests.jl:6-17 step 4: the
                # map "adheres to the parent request when possible").  Such
                # pieces enrich the returned solution map; they are not new
                # optimality obligations — treating them as failures would
                # oscillate the parent between branches forever.
                if make_requests and ret.e and "infeasible" in str(ret.e) \
                        and not all(
                            cp.contains(x, tol=1e-3)
                            for cp in appended[len(prep.base_constraints):]):
                    METRICS.bump("request_extension_combos_skipped")
                    continue
                failing.append({j: ji
                                for j, ji in zip(prep.child_inds, combo)})
                if first_err is None:
                    first_err = ret.e
        if failing:
            # reference behavior: report the first failing combo; the
            # alternates let the caller retry when its QEP turns out
            # unsolvable (robustness upgrade, see solve_base)
            return SimpleNamespace(solution=False, e=first_err, failed=False,
                                   subpiece_assignments=failing[0],
                                   alternate_assignments=failing[1:], S=None)
        if not any(r.solution for r in verifies):
            # EVERY combo was skipped as vacuous: nothing actually verified
            # x (its own feasibility included) — this is a failure, not
            # vacuous contentment; the caller perturbs and retries
            return SimpleNamespace(solution=False, failed=True, S=None,
                                   e="all subpiece combinations vacuous",
                                   subpiece_assignments={})
        for combo, appended, ret in zip(prep.combos, prep.combo_constraints,
                                        verifies):
            if not ret.solution:
                continue      # vacuous combos contribute no graph
            if make_requests and ret.lam is not None:
                identified_request |= _identify_from_duals(
                    prep.base_constraints, appended, ret.lam)
            if gen_solution_graphs:
                children_polys = appended[len(prep.base_constraints):]
                gen = process_solution_graph(
                    qp, appended, prep.dec_inds, x, ret.lam,
                    exploration_vertices=exploration_vertices, rng=rng,
                    frontier_store=getattr(qpn, "frontier_store", None),
                    request=request)
                graph = setops.remove_subsets(PolyUnion(gen.collect()))
                results.append((children_polys, graph))
        if gen_solution_graphs:
            try:
                S_out = PolyUnion(list(combine(results, x)))
            except RuntimeError:
                return SimpleNamespace(solution=False, failed=True, S=None,
                                       e=None, subpiece_assignments={})
            if len(S_out) == 0:
                # every branch of the combination tree pruned away: the
                # node has no representable solution graph at this point —
                # report failure so the caller can perturb and retry
                # (consuming an empty graph upstream would be a hard error)
                return SimpleNamespace(solution=False, failed=True, S=None,
                                       e=None, subpiece_assignments={})
        else:
            S_out = None
    else:
        ret = verifies[0]
        if not ret.solution:
            return SimpleNamespace(solution=False, e=ret.e, failed=False,
                                   subpiece_assignments={}, S=None)
        if gen_solution_graphs:
            gen = process_solution_graph(
                qp, prep.base_constraints, prep.dec_inds, x, ret.lam,
                exploration_vertices=exploration_vertices, rng=rng,
                frontier_store=getattr(qpn, "frontier_store", None),
                request=request)
            S_out = PolyUnion(gen.collect())
            if len(S_out) == 0:
                raise RuntimeError(
                    "This shouldn't happen. Solution graph is empty.")
        else:
            S_out = None
    return SimpleNamespace(solution=True, S=S_out, failed=False, e=None,
                           subpiece_assignments={},
                           identified_request=identified_request)


def _identify_from_duals(base_constraints, appended, lam):
    """Map active verification duals on the child-solution-graph rows into
    request directions for the child's enumeration (avi.jl:479-506).  A
    propagation LP failure skips that row's request rather than killing an
    otherwise-converged solve (the reference raises, but only from a flow it
    never runs)."""
    from .requests import identify_request
    lam = np.asarray(lam)
    identified = set()
    off = sum(c.m for c in base_constraints)
    for cp in appended[len(base_constraints):]:
        try:
            identified |= identify_request(cp, lam[off:off + cp.m])
        except RuntimeError:
            METRICS.bump("request_propagate_failed")
        off += cp.m
    if identified:
        METRICS.bump("requests_identified", len(identified))
    return identified


def _combo_region_vacuous(prep, appended_constraints, x) -> bool:
    """True iff the combo's constraint region, with the node's non-decision
    coordinates pinned at their current values, is empty."""
    region = intersect(*appended_constraints) if appended_constraints else None
    if region is None:
        return False
    x = np.asarray(x, dtype=np.float64)
    spec = x.copy()
    spec[list(prep.dec_inds)] = np.nan        # decisions stay free
    sliced = region.poly_slice(spec)
    return bool(setops.is_empty(sliced.closure()))


def process_qp(qpn: QPNet, pid: int, x, S: Dict[int, PolyUnion],
               exploration_vertices: int = 0,
               rng: Optional[np.random.Generator] = None,
               request=frozenset(), make_requests: bool = False):
    prep = _prepare_qp_tasks(qpn, pid, x, S)
    verifies = verify_solutions_batch(
        prep.tasks, x, tol=qpn.options.tol,
        feas_tol=qpn.options.verify_feas_tol)
    return _finish_process_qp(qpn, pid, x, prep, verifies,
                              exploration_vertices, rng,
                              request=request, make_requests=make_requests)


def process_qps_level(qpn: QPNet, players, x, S: Dict[int, PolyUnion],
                      exploration_vertices: int = 0,
                      rng: Optional[np.random.Generator] = None,
                      request=frozenset(), make_requests: bool = False):
    """Level-wide node-parallel verification (SURVEY §2.3 row 1).

    The reference maps process_qp over players serially (algorithm.jl:44-52);
    here the (players × child-piece-combos) KKT verifications of an entire
    level fuse into ONE batched kernel call, and only the graph-generation
    phase (already kernel-batched internally) runs per node."""
    preps = [_prepare_qp_tasks(qpn, pid, x, S) for pid in players]
    flat_tasks = [t for p in preps for t in p.tasks]
    flat_verifies = verify_solutions_batch(
        flat_tasks, x, tol=qpn.options.tol,
        feas_tol=qpn.options.verify_feas_tol)
    out = []
    k = 0
    for pid, prep in zip(players, preps):
        v = flat_verifies[k:k + len(prep.tasks)]
        k += len(prep.tasks)
        out.append(_finish_process_qp(qpn, pid, x, prep, v,
                                      exploration_vertices, rng,
                                      request=request,
                                      make_requests=make_requests))
    return out


# --------------------------------------------------------------------------
#  combine — qp_processing.jl:243-291 + intersection.jl
# --------------------------------------------------------------------------

def combine(solgraphs, x):
    """Region/solution decomposition ``S := ⋃ₚ ⋂ᵢ Zᵢᵖ`` with
    ``Zᵢᵖ ∈ {Rᵢᶜ, Sᵢ}`` (docstring qp_processing.jl:260-266)."""
    regions: List[Poly] = []
    solutions: List[PolyUnion] = []
    for (children_polys, s) in solgraphs:
        pr = intersect(*children_polys)
        pr = project_poly(pr, range(pr.dim))
        regions.append(pr)
        solutions.append(s)
    return _combine(regions, solutions, x)


def _combine(regions, solutions, x):
    if len(solutions) == 0:
        raise RuntimeError("No solutions to combine...")
    if len(solutions) == 1:
        return list(solutions[0])
    complements = [r.complement() for r in regions]
    combined = [PolyUnion(list(s) + list(rc))
                for s, rc in zip(solutions, complements)]
    widths = [len(c) for c in combined]
    if len(widths) > 3 and sum(widths) > 20:
        raise RuntimeError(f"Too many solutions to combine. {widths}")
    logger.debug("combine widths: %s", widths)
    red_lengths = [len(rc) for rc in complements]
    return intersection_iter(combined, red_lengths, np.asarray(x))


def intersection_iter(pus: List[PolyUnion], red_lengths, central_point):
    """Product-of-unions iteration with pruning (intersection.jl:55-151): a
    branch dies as soon as the partial intersection misses the central
    point's closure or is empty; the all-complements leaf combination (red
    zone) is excluded.

    The reference walks this tree depth-first with one emptiness LP per node;
    here each depth expands level-synchronously so ALL surviving branches'
    emptiness checks fuse into one batched kernel call.  The explored node
    set and the emitted leaf order are identical to the DFS (pruning is
    per-node, traversal-order independent; leaves are emitted in
    lexicographic index order)."""
    N = len(pus)
    full = [len(pu) for pu in pus]
    central = np.asarray(central_point, dtype=np.float64)

    frontier = [(None, ())]          # (partial intersection, index tuple)
    for depth in range(N):
        cands = []
        for parent_poly, idxs in frontier:
            for i, p in enumerate(pus[depth].polys):
                cur = p if parent_poly is None else intersect(parent_poly, p)
                METRICS.bump("intersection_nodes")
                if cur.closure().contains(central, tol=1e-6):
                    cands.append((cur, idxs + (i,)))
        if not cands:
            return
        empty = setops.is_empty_batch([c[0] for c in cands])
        frontier = [c for c, e in zip(cands, empty) if not e]

    for poly, idxs in frontier:
        redzone = all(idx >= full[d] - red_lengths[d]
                      for d, idx in enumerate(idxs))
        if not redzone:
            yield poly


# --------------------------------------------------------------------------
#  QEP assembly + solve — avi.jl:205-377, 382-444
# --------------------------------------------------------------------------

def create_labeled_gavi_from_qp(qpn: QPNet, pid: int,
                                solution_graphs: Dict[int, Poly]):
    """Per-player block with labeled variables Z = [x; ξᵢ; λᵢ; ψᵢ]
    (avi.jl:205-251).  Matches the live reference: the ξ identity block is
    zeroed (avi.jl:244) and ξ is pinned by the consensus top rows instead."""
    dvars = qpn.decision_inds(pid)
    n_dec = len(dvars)
    qp = qpn.qps[pid]
    n_total = qp.f.Q.shape[1]

    labels: Dict[str, int] = {}
    for i in range(n_total):
        labels[f"x_{i}"] = i
    for e, i in enumerate(dvars):
        labels[f"xi_{pid}_{i}"] = n_total + e
    total = n_total + n_dec

    blocks_A, blocks_l, blocks_u = [], [], []
    for ci in qp.constraint_indices:
        c = qpn.constraints[ci].poly
        for i in range(c.m):
            labels[f"lam_{pid}_{ci}_{i}"] = total + i
        total += c.m
        blocks_A.append(c.A)
        blocks_l.append(c.l)
        blocks_u.append(c.u)
    A_i = np.vstack(blocks_A) if blocks_A else np.zeros((0, n_total))
    l_i = np.concatenate(blocks_l) if blocks_l else np.zeros(0)
    u_i = np.concatenate(blocks_u) if blocks_u else np.zeros(0)

    blocks_A, blocks_l, blocks_u = [], [], []
    for j in sorted(qpn.network_edges[pid]):
        Sj = solution_graphs[j]
        for i in range(Sj.m):
            labels[f"psi_{pid}_{j}_{i}"] = total + i
        total += Sj.m
        blocks_A.append(Sj.A)
        blocks_l.append(Sj.l)
        blocks_u.append(Sj.u)
    A_S = np.vstack(blocks_A) if blocks_A else np.zeros((0, n_total))
    l_S = np.concatenate(blocks_l) if blocks_l else np.zeros(0)
    u_S = np.concatenate(blocks_u) if blocks_u else np.zeros(0)

    M1 = np.hstack([
        qp.f.Q[dvars, :],
        0.0 * np.eye(n_dec),            # zeroed ξ block (avi.jl:244)
        -A_i[:, dvars].T,
        -A_S[:, dvars].T,
    ])
    q1 = qp.f.q[dvars]
    M2 = np.vstack([A_i, A_S])
    l2 = np.concatenate([l_i, l_S])
    u2 = np.concatenate([u_i, u_S])
    return SimpleNamespace(dvars=dvars, labels=labels, M1=M1, q1=q1, M2=M2,
                           l2=l2, u2=u2)


def combine_gavis(n: int, dec_inds, param_inds, labeled_gavis,
                  layout: Optional[dict] = None) -> GAVI:
    """Stack per-player blocks into one GAVI over
    Z = [x_dec; ξ…; λψ…] with ξ-consensus top rows (avi.jl:305-377).

    ``layout``, if given, is filled with the combined column indices of the
    ψ variables (per-player solution-graph duals) — the MIN_NORM
    shared-variable mode's revision objective needs them
    (deprecated/avi.jl:148-369 semantics)."""
    nd = len(dec_inds)
    total_dual_dim = 0
    total_xi_dim = 0
    for pid, lg in labeled_gavis.items():
        total_dual_dim += lg.M1.shape[1] - n
        total_xi_dim += lg.M1.shape[0]
    xi_ranges: Dict[int, range] = {}
    lampsi_ranges: Dict[int, range] = {}
    off1, off2 = 0, total_xi_dim

    pool = sorted(labeled_gavis.keys())
    M_rows, N_rows, q_rows = [], [], []
    for pid in pool:
        lg = labeled_gavis[pid]
        M1 = lg.M1
        dual_dim = M1.shape[1] - n
        xi_dim = M1.shape[0]
        lampsi_dim = dual_dim - xi_dim
        xi_ranges[pid] = range(off1, off1 + xi_dim)
        lampsi_ranges[pid] = range(off2, off2 + lampsi_dim)
        Mi = np.zeros((xi_dim, nd + total_dual_dim))
        Mi[:, :nd] = M1[:, dec_inds]
        Mi[:, [nd + r for r in xi_ranges[pid]]] = M1[:, n:n + xi_dim]
        Mi[:, [nd + r for r in lampsi_ranges[pid]]] = M1[:, n + xi_dim:]
        M_rows.append(Mi)
        N_rows.append(M1[:, param_inds])
        q_rows.append(lg.q1)
        off1 += xi_dim
        off2 += lampsi_dim
    M = np.vstack(M_rows)
    N = np.vstack(N_rows)
    q = np.concatenate(q_rows)

    A_rows, B_rows, l2_rows, u2_rows = [], [], [], []
    for pid in pool:
        lg = labeled_gavis[pid]
        A_rows.append(lg.M2[:, dec_inds])
        B_rows.append(lg.M2[:, param_inds])
        l2_rows.append(lg.l2)
        u2_rows.append(lg.u2)
    A = np.vstack(A_rows)
    B = np.vstack(B_rows)
    l2 = np.concatenate(l2_rows)
    u2 = np.concatenate(u2_rows)

    top_M = np.zeros((nd, M.shape[1]))
    top_N = np.zeros((nd, N.shape[1]))
    top_q = np.zeros(nd)
    for pid in pool:
        lg = labeled_gavis[pid]
        xr = xi_ranges[pid]
        for di, d in enumerate(dec_inds):
            if d in lg.dvars:
                col = nd + xr[lg.labels[f"xi_{pid}_{d}"] - n]
                top_M[di, col] = 1.0

    if layout is not None:
        psi_inds = []
        for pid in pool:
            lg = labeled_gavis[pid]
            xi_dim = lg.M1.shape[0]
            lr = lampsi_ranges[pid]
            for key, idx in lg.labels.items():
                if key.startswith("psi_"):
                    psi_inds.append(nd + lr[idx - n - xi_dim])
        layout["psi_inds"] = sorted(psi_inds)
        layout["nd"] = nd

    M = np.vstack([top_M, M])
    N = np.vstack([top_N, N])
    o = np.concatenate([top_q, q])
    l1 = np.full(len(o), -np.inf)
    u1 = np.full(len(o), np.inf)
    A = np.hstack([A, np.zeros((A.shape[0], total_dual_dim))])
    return GAVI(M, N, o, l1, u1, A, B, l2, u2)


def _try_potential_qp(qpn: QPNet, player_pool, x, S, dec_inds, param_inds):
    """Potential-game fast path.

    When (a) decision sets at the level are disjoint, (b) the stacked
    stationarity Jacobian over the level decisions is symmetric, and (c) each
    player's constraints touch only its own decisions (other players enter as
    parameters), the Nash equilibrium is the optimum of one potential QP —
    solvable by the batched ADMM kernel in a few hundred cheap iterations
    instead of a full complementarity solve.  The result is audited against
    each player's KKT (verify_solutions_batch); any failure falls back to the
    GAVI path, so semantics are identical to the reference.
    """
    nd = len(dec_inds)
    col = {d: i for i, d in enumerate(dec_inds)}
    owner = {}
    for pid in player_pool:
        for d in qpn.decision_inds(pid):
            if d in owner:
                return None          # overlapping decisions: not separable
            owner[d] = pid
    J = np.zeros((nd, nd))
    c = np.zeros(nd)
    for pid in player_pool:
        dvars = qpn.decision_inds(pid)
        rows = [col[d] for d in dvars]
        Q = qpn.qps[pid].f.Q
        J[np.ix_(rows, [col[d] for d in dec_inds])] = Q[np.ix_(dvars, dec_inds)]
        c[rows] = (Q[np.ix_(dvars, param_inds)] @ x[param_inds]
                   + qpn.qps[pid].f.q[dvars])
    if not np.allclose(J, J.T, atol=1e-10):
        return None
    # constraints: stack per player; support must stay within own decisions
    A_rows, l_rows, u_rows = [], [], []
    for pid in sorted(player_pool):
        own = set(qpn.decision_inds(pid))
        polys = [qpn.constraints[ci].poly
                 for ci in qpn.qps[pid].constraint_indices]
        polys += [S[j] for j in sorted(qpn.network_edges[pid])]
        for p in polys:
            touched = set(np.nonzero(np.abs(p.A[:, dec_inds]).sum(0))[0])
            if not {dec_inds[t] for t in touched} <= own:
                return None
            A_rows.append(p.A)
            l_rows.append(p.l)
            u_rows.append(p.u)
    if A_rows:
        A = np.vstack(A_rows)
        l = np.concatenate(l_rows)
        u = np.concatenate(u_rows)
    else:
        A = np.zeros((0, len(x)))
        l = np.zeros(0)
        u = np.zeros(0)
    shift = A[:, param_inds] @ x[param_inds]
    sol = batch_qp.solve_qp_np(J, c, A[:, dec_inds], l - shift, u - shift)
    if sol.status not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
        return None
    x_opt = x.copy()
    x_opt[dec_inds] = np.asarray(sol.x)
    # audit: every player's KKT must hold at the joint point
    tasks = []
    for pid in sorted(player_pool):
        cons = [qpn.constraints[ci].poly
                for ci in qpn.qps[pid].constraint_indices]
        cons += [S[j] for j in sorted(qpn.network_edges[pid])]
        tasks.append((qpn.qps[pid], cons, qpn.decision_inds(pid)))
    checks = verify_solutions_batch(
        tasks, x_opt, tol=qpn.options.tol,
        feas_tol=qpn.options.verify_feas_tol)
    if not all(r.solution for r in checks):
        return None
    METRICS.bump("qep_potential_fastpath")
    return x_opt


def _qep_region_feasible(qpn: QPNet, player_pool, x, S: Dict[int, Poly]):
    """Cheap joint-feasibility screen of a QEP's constraint region at the
    current ancestor variables: the players' shared constraints plus every
    assigned child piece, sliced at the non-decision coordinates."""
    x = np.asarray(x, dtype=np.float64)
    dec = sorted(set().union(*[set(qpn.decision_inds(i))
                               for i in player_pool]))
    cons = []
    seen = set()
    for pid in player_pool:
        for ci in qpn.qps[pid].constraint_indices:
            if ci not in seen:
                seen.add(ci)
                cons.append(qpn.constraints[ci].poly)
    for child_id in sorted(set().union(
            *[qpn.network_edges[i] for i in player_pool])):
        if child_id in S:
            cons.append(S[child_id])
    if not cons:
        return True
    region = intersect(*cons)
    spec = x.copy()
    spec[dec] = np.nan
    sliced = region.poly_slice(spec).closure()
    # strict emptiness margin: the QEP AVI is solved to 1e-10, so a region
    # infeasible by even 1e-3 (far below the geometric default 1e-2) makes
    # it unsolvable — screen with a tight tolerance
    empty, _ = setops.exemplar_batch([sliced], tol=1e-6)
    return not bool(empty[0])


def solve_qep(qpn: QPNet, player_pool, x, S: Dict[int, Poly]):
    """Level Nash solve (avi.jl:382-444), with a potential-game QP fast path
    audited per-player before acceptance."""
    x = np.asarray(x, dtype=np.float64)
    x_dim = len(x)
    dec_inds = sorted(set().union(*[set(qpn.decision_inds(i))
                                    for i in player_pool]))
    param_inds = [i for i in range(x_dim) if i not in set(dec_inds)]

    from .options import SharedVariableMode
    min_norm = (qpn.options.shared_variable_mode
                == SharedVariableMode.MIN_NORM)
    # MIN_NORM asks for explicit control over the dual selection — the
    # potential-game shortcut never materializes ψ, so it can't honor it
    fast = (None if min_norm else
            _try_potential_qp(qpn, player_pool, x, S, dec_inds, param_inds))
    METRICS.bump("qep_solves")
    if fast is not None:
        return fast

    labeled = {pid: create_labeled_gavi_from_qp(qpn, pid, S)
               for pid in player_pool}
    layout: Dict = {}
    gavi = combine_gavis(x_dim, dec_inds, param_inds, labeled, layout)

    w = x[param_inds]
    z0 = np.concatenate([x[dec_inds],
                         np.zeros(gavi.M.shape[1] - len(dec_inds))])
    with METRICS.timer("solve_gavi"):
        z, status = solve_gavi(gavi, z0, w)
    if status != Status.SUCCESS:
        raise RuntimeError(
            f"AVI solve error. This might be because one of the qps "
            f"{sorted(player_pool)} is unbounded or ill-conditioned.")

    if min_norm and layout.get("psi_inds"):
        z = min_norm_revise_qep(gavi, layout["psi_inds"], z, w)

    x_opt = x.copy()
    x_opt[dec_inds] = z[:len(dec_inds)]
    x_opt[param_inds] = w
    return x_opt


def min_norm_revise_qep(gavi: GAVI, psi_inds, z, w):
    """``shared_variable_mode=MIN_NORM`` consumer: re-solve the QEP GAVI
    restricted to the local solution piece at (z, w), minimizing ½‖ψ‖² over
    the solution-graph duals (the semantics the reference documents in its
    deprecated monolithic solve_qep, deprecated/avi.jl:148-369; the live
    reference accepts the flag and drops it, avi.jl:387-390).

    When child solution graphs carry redundant constraint rows the
    equilibrium duals ψ are a degenerate set; the default SHARED_DUAL flow
    returns whichever point the solver lands on, MIN_NORM selects the
    minimum-norm representative — making multiplier-based diagnostics (and
    the requests subsystem reading ψ activity) deterministic.  Falls back to
    the unrevised z if the restricted solve fails."""
    from .enumeration import comp_indices, local_piece, max_freedom_K
    from .requests import min_norm_objective, revise_avi_solution
    nz, nw = len(z), len(w)
    J = comp_indices(gavi, z, w)
    K = max_freedom_K(J)
    piece, _ = local_piece(gavi, nz, nw, K)
    f = min_norm_objective(nz, psi_inds)
    try:
        z_rev = revise_avi_solution(f, piece, z, w)
    except RuntimeError:
        METRICS.bump("min_norm_revise_failed")
        return z
    METRICS.bump("min_norm_revised")
    return np.asarray(z_rev)[:nz]


# --------------------------------------------------------------------------
#  solve_base — algorithm.jl:1-127
# --------------------------------------------------------------------------

def _approx_vec(a, b):
    """Julia's isapprox for vectors: ‖a−b‖ ≤ rtol·max(‖a‖, ‖b‖)."""
    a = np.asarray(a)
    b = np.asarray(b)
    rtol = math.sqrt(np.finfo(np.float64).eps)
    return np.linalg.norm(a - b) <= rtol * max(np.linalg.norm(a),
                                               np.linalg.norm(b), 1e-300)


def solve_base(qpn: QPNet, x_init, request=frozenset(),
               relaxable_inds=frozenset(), level: int = 1,
               proj_vectors: Optional[List[np.ndarray]] = None,
               rng: Optional[np.random.Generator] = None,
               checkpoint_path: Optional[str] = None):
    if rng is None:
        rng = np.random.default_rng()
    if proj_vectors is None:
        proj_vectors = []
    x = np.asarray(x_init, dtype=np.float64).copy()
    request = frozenset(request)
    make_requests = qpn.options.make_requests
    try:
        if level == 1 and qpn.options.debug_visualize:
            qpn.visualization_function(x)
        if level == 1 and not proj_vectors:
            for _ in range(qpn.options.num_projections):
                proj_vectors.append(rng.standard_normal(len(x)))
        pert_budget = 5       # perturb-to-continue attempts (see below)
        req_budget = 2        # request-negotiation rounds per level
        for iters in range(1, qpn.options.max_iters + 1):
            proj_vals = np.array([x @ v for v in proj_vectors])
            logger.debug("Iteration %d at level %d. %s", iters, level,
                         proj_vals)
            if level == 1 and checkpoint_path is not None:
                from .utils.checkpoint import save_state
                save_state(checkpoint_path, x,
                           iterate_cache=qpn.iterate_cache,
                           meta={"iteration": iters})
            if qpn.options.check_for_cycling:
                if qpn.options.num_projections == 0:
                    raise RuntimeError(
                        "Cycling check requested, but num_projections == 0.")
                cache = qpn.iterate_cache.setdefault(level, [])
                if any(_approx_vec(proj_vals, prev) for prev in cache):
                    # same escape hatch as the failed-QEP case below: the
                    # reference raises here (algorithm.jl:16-30); with
                    # perturb_to_continue we nudge the sub-level variables
                    # out of the 2-cycle before giving up
                    if qpn.options.perturb_to_continue and pert_budget > 0:
                        pert_budget -= 1
                        METRICS.bump("perturb_to_continue")
                        players_ = sorted(qpn.network_depth_map[level])
                        sub = sorted(set(range(len(x))) - set().union(
                            *[set(qpn.decision_inds(i)) for i in players_]))
                        sub = sub or list(range(len(x)))
                        x = x.copy()
                        x[sub] += 0.1 * rng.standard_normal(len(sub))
                        qpn.iterate_cache[level] = []
                        continue
                    raise RuntimeError(
                        "Cycling detected (solution iterate returned to a "
                        "previous value). Try check_convexity = true.")
                cache.append(proj_vals)

            if level < qpn.num_levels():
                ret_low = solve_base(qpn, x, request, relaxable_inds,
                                     level=level + 1,
                                     proj_vectors=proj_vectors, rng=rng)
                if not ret_low.solved:
                    # child-level failure: one more perturb-and-retry tier
                    # before propagating (same escape hatch as below)
                    if qpn.options.perturb_to_continue and pert_budget > 0:
                        pert_budget -= 1
                        METRICS.bump("perturb_to_continue")
                        x = x.copy()
                        x += 0.05 * rng.standard_normal(len(x))
                        continue
                    return SimpleNamespace(solved=False, x_fail=x, x_opt=None,
                                           Sol=None)
                S = ret_low.Sol
                x = np.asarray(ret_low.x_opt)
            else:
                S: Dict[int, PolyUnion] = {}

            players = sorted(qpn.network_depth_map[level])
            child_level_players = sorted(
                set().union(*[qpn.network_edges[i] for i in players]))
            results = process_qps_level(
                qpn, players, x, S,
                exploration_vertices=qpn.options.exploration_vertices,
                rng=rng, request=request, make_requests=make_requests)

            equilibrium = True
            subpiece_ids = {i: 0 for i in child_level_players}

            if any(r.failed for r in results):
                # the reference's perturb-to-continue branch lives exactly
                # here (algorithm.jl:57-66, disabled by `&& false`); wired
                # live: nudge the non-level variables and retry
                if qpn.options.perturb_to_continue and pert_budget > 0:
                    pert_budget -= 1
                    METRICS.bump("perturb_to_continue")
                    sub = sorted(set(range(len(x))) - set().union(
                        *[set(qpn.decision_inds(i)) for i in players]))
                    sub = sub or list(range(len(x)))
                    x = x.copy()
                    x[sub] += 0.1 * rng.standard_normal(len(sub))
                    continue
                return SimpleNamespace(solved=False, x_fail=x, x_opt=None,
                                       Sol=None)

            for pid, r in zip(players, results):
                if not r.solution:
                    equilibrium = False
                    if level < qpn.num_levels():
                        for child_id, sp_id in r.subpiece_assignments.items():
                            # later players overwrite earlier ones, like the
                            # reference (algorithm.jl:73-81)
                            subpiece_ids[child_id] = sp_id
                else:
                    S[pid] = (setops.remove_subsets(r.S)
                              if level in qpn.options.levels_to_remove_subsets
                              else r.S)
                    if S[pid] is not None:
                        logger.debug("Solution graph for node %d has %d "
                                     "pieces.", pid, len(S[pid]))

            if not equilibrium:
                logger.debug("No equilibrium at level %d; QEP with subpieces "
                             "%s", level, subpiece_ids)
                # Robustness upgrade over algorithm.jl:91-109: the reference
                # merges failing combos across players (later players
                # overwrite, algorithm.jl:73-81) and dies in PATH when the
                # merged region is jointly infeasible at the current
                # ancestors.  Here the merged candidate is screened for
                # joint feasibility first; infeasible or unsolvable
                # candidates fall through to each player's own failing
                # combos (and their alternates) before giving up.
                cand_ids = [dict(subpiece_ids)]
                if level < qpn.num_levels():
                    for pid, r in zip(players, results):
                        if r.solution:
                            continue
                        alts = ([r.subpiece_assignments]
                                + list(getattr(r, "alternate_assignments",
                                               []))[:4])
                        for alt in alts:
                            cand = {i: 0 for i in child_level_players}
                            cand.update(alt)
                            if cand not in cand_ids:
                                cand_ids.append(cand)
                last_err = None
                xnew = None
                for ci, ids in enumerate(cand_ids[:10]):
                    cand = {i: S[i][ji] for i, ji in ids.items()}
                    if not _qep_region_feasible(qpn, players, x, cand):
                        METRICS.bump("qep_infeasible_combo_skipped")
                        last_err = last_err or RuntimeError(
                            "QEP subpiece combination region is empty at "
                            "the current ancestor variables.")
                        continue
                    try:
                        xnew = solve_qep(qpn, players, x, cand)
                        if ci > 0:
                            METRICS.bump("qep_alternate_combo")
                        break
                    except RuntimeError as err:
                        last_err = err
                        continue
                if xnew is None:
                    # perturb-to-continue (algorithm.jl:57-66 — present in
                    # the reference but disabled by `&& false`; wired live
                    # here): when every subpiece combination yields an
                    # infeasible/unsolvable QEP, nudge the sub-level
                    # variables and re-derive the lower levels' solution
                    # graphs from the perturbed point.
                    if qpn.options.perturb_to_continue and pert_budget > 0:
                        pert_budget -= 1
                        METRICS.bump("perturb_to_continue")
                        sub = sorted(set(range(len(x)))
                                     - set().union(*[set(qpn.decision_inds(i))
                                                     for i in players]))
                        sub = sub or list(range(len(x)))
                        x = x.copy()
                        x[sub] += 0.1 * rng.standard_normal(len(sub))
                        continue
                    raise last_err
                if np.linalg.norm(xnew - x) < 1e-4:
                    raise RuntimeError(
                        "Detected disagreement in solution status between "
                        "qp solution processor and equilibrium solver.\n"
                        "Check the convexity and conditioning of your QPs.")
                x = xnew
                METRICS.bump("equilibrium_steps")
                if qpn.options.debug_visualize:
                    qpn.visualization_function(x)
                continue
            else:
                identified = set().union(
                    *[getattr(r, "identified_request", set())
                      for r in results]) if make_requests else set()
                new_reqs = identified - set(request)
                if make_requests and new_reqs and req_budget > 0 \
                        and level < qpn.num_levels():
                    # Live request negotiation (the loop the reference
                    # sketches in requests.jl:6-17 but early-returns out of
                    # at requests.jl:22): the level is content, but its duals
                    # on child-graph rows identify directions the children's
                    # solution maps should extend toward.  Re-derive the
                    # lower levels with the enlarged request — comp_indices
                    # grants the matching labels there — and re-verify.
                    req_budget -= 1
                    request = frozenset(set(request) | new_reqs)
                    METRICS.bump("request_rounds")
                    # same x re-enters the loop (and the sub-level
                    # recursions) deliberately: a request change is new
                    # state, not a cycle — reset this level's and every
                    # deeper level's fingerprints
                    for k in list(qpn.iterate_cache):
                        if k >= level:
                            qpn.iterate_cache[k] = []
                    continue
                if level == 1:
                    for k in qpn.iterate_cache:
                        qpn.iterate_cache[k] = []
                return SimpleNamespace(solved=True, x_opt=x, Sol=S,
                                       identified_request=identified,
                                       x_alts=[], x_fail=None)
        raise RuntimeError("Can't find solution")
    except (RuntimeError, ValueError, AssertionError) as err:
        for k in qpn.iterate_cache:
            qpn.iterate_cache[k] = []
        logger.error("%s", err)
        return SimpleNamespace(solved=False, x_fail=x, x_opt=None, Sol=None,
                               error=err)


def _chain_sweep_warmstart(qpn: QPNet):
    """Level-pipeline fast path (SURVEY §2.3 row 6 — the PP analogue latent
    in the reference's per-level recursion, algorithm.jl:32-43).

    Chain networks in the fast class (one player per level, own-variable
    constraints, objective coupling only to the single child — the checks in
    parallel.sharded.stack_chain_avis) have an init-independent equilibrium
    computed by ONE bottom-up sweep over stacked per-level KKT AVIs —
    no host recursion, no QEP assembly.  Returns the sweep point, or None
    when the network is outside the class or the sweep residuals fail —
    the caller then falls back to host recursion.  The point is consumed as
    a warm start: solve_base still runs its full verification and graph
    generation, so a wrong sweep degrades to extra iterations, never to a
    wrong answer."""
    if qpn.num_levels() < 3:
        return None          # shallow nets: the scan saves nothing
    try:
        from .parallel.sharded import level_sweep_scan, stack_chain_avis
        M, Nc, o, l, u, nd, owns = stack_chain_avis(qpn)
    except (ValueError, AssertionError):
        return None
    carry, zs, resids = level_sweep_scan(M, Nc, o, l, u, nd, np.zeros(nd))
    if float(np.max(np.asarray(resids))) > 1e-8:
        METRICS.bump("chain_sweep_residual_reject")
        return None
    x = np.zeros(qpn.num_vars)
    for lvl, own in enumerate(owns):
        x[own] = np.asarray(zs)[lvl, :nd]
    METRICS.bump("chain_sweep")
    return x


def solve(qpn: QPNet, x_init=None, parent_level_request=frozenset(),
          relaxable_inds=frozenset(), level: int = 1,
          proj_vectors=None, rng=None, seed: int = 1,
          checkpoint_path: Optional[str] = None):
    """Entry point (requests.jl:1-22).  The request-negotiation state machine
    in the reference is dead code behind an early return (requests.jl:22) —
    solve delegates directly to solve_base.  ``checkpoint_path`` saves the
    iterate + cycling fingerprints each outer iteration, the enumeration
    frontiers under ``<checkpoint_path>.frontiers``, and the solution graphs
    at the end (utils/checkpoint; ``resume`` continues from the file).

    The counters of ``METRICS`` (span times included) restart at every
    call, except under a lockstep broker, where the scenario threads share
    them; the kernel launch counts never do (a caller reads them across
    calls).

    The batched work runs on ``CONFIG.device``, the card by default; without
    a CUDA device the call raises (set ``CONFIG.device = "cpu"``), and so it
    does when the native host library cannot be built or loaded."""
    # A missing device or native library is the caller's to settle, not a
    # failed solve: solve_base would catch the error and report
    # solved=False.
    numeric_device()
    native._load()
    if x_init is None:
        x_init = qpn.default_initialization
    if rng is None:
        rng = np.random.default_rng(seed)
    if checkpoint_path is not None:
        from .utils.checkpoint import FrontierStore
        qpn.frontier_store = FrontierStore(str(checkpoint_path) + ".frontiers")
    else:
        # a later solve() WITHOUT a checkpoint path must not silently resume
        # (or keep writing) frontiers from an earlier checkpointed run
        qpn.frontier_store = None
    # under a lockstep broker N scenario threads run solve() concurrently;
    # resetting the process-global METRICS here would wipe the other
    # scenarios' counters mid-run
    from .parallel.lockstep import active_broker
    if active_broker() is None:
        METRICS.reset(launches=False)
    qpn.metrics = METRICS
    if level == 1:
        # chain networks in the fast class solve their (init-independent)
        # equilibrium in one scan; solve_base then verifies it and builds
        # the solution graphs without any QEP step
        x_sweep = _chain_sweep_warmstart(qpn)
        if x_sweep is not None:
            x_init = x_sweep
    with METRICS.timer("solve"):
        ret = solve_base(qpn, x_init, parent_level_request, relaxable_inds,
                         level=level, proj_vectors=proj_vectors, rng=rng,
                         checkpoint_path=checkpoint_path)
    if checkpoint_path is not None and ret.solved:
        from .utils.checkpoint import save_state
        save_state(checkpoint_path, ret.x_opt, Sol=ret.Sol,
                   iterate_cache=qpn.iterate_cache, meta={"solved": True})
    return ret


def solve_many(qpns, x_inits=None, seed: int = 1):
    """Solve a scenario ensemble of QPNets.

    The host loops are per-scenario; each scenario's batched work runs on
    ``CONFIG.device``.  Returns a list of per-scenario results.
    ``parallel.lockstep.solve_many_lockstep`` runs the same ensemble with
    the scenarios' batched calls fused."""
    qpns = list(qpns)
    if x_inits is None:
        x_inits = [None] * len(qpns)
    out = []
    for qpn, x0 in zip(qpns, x_inits):
        out.append(solve(qpn, x0, seed=seed))
    return out
