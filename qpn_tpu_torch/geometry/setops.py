"""Batched polyhedral set operations (emptiness, membership, subset,
implicit bounds) — PyTorch port of ``qpn_tpu/geometry/setops.py``: numpy
host code, each query phrased as a batch of small LPs/QPs for the batched
ADMM engine (``ops/batch_qp.py``), the native exact-shape pivot engine
(``ops/lemke.solve_lp_host_batch``) or the f32 feasibility screen
(``ops/screen.py``; its CUDA kernel on a CUDA ``CONFIG.device``).

This module replaces the reference's ten OSQP call sites with four batched
primitives:

* :func:`exemplar_batch` — the ε-inflation feasibility LP (sets.jl:591-642)
  honoring *strict* inequality rows via the dual-activity check.
* :func:`contains_batch` — membership incl. partial-x membership
  (sets.jl:820-848), reformulated as ε-inflation (same answer, no reliance on
  infeasibility certificates).
* :func:`support_batch` — min/max of linear directions over polys; backs
  ``issubset`` (sets.jl:377-407) and ``implicit_bounds`` (sets.jl:660-713).
* :func:`remove_subsets` — the O(n²) pairwise-containment prune
  (sets.jl:889-905) as one all-pairs batch, with the reference's *serial*
  tie-break preserved on host (its threading bug note documents why the
  tie-break must stay deterministic).

Ragged batches are grouped by (dim, row-bucket), as in the JAX package (the
masked padding rows change no lane's result).  Above
``prune_dedup_threshold`` pieces the duplicate prune runs over the ranks of
a ``torch.distributed`` process group when a group of more than one rank
is up (``parallel/sharded.py``, ring-rotated above its threshold), on the
host otherwise.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np

from ..config import row_bucket
from ..ops import batch_qp
from .poly import Poly, PolyUnion

_INF = np.inf


# --------------------------------------------------------------------------
#  Padding helpers
# --------------------------------------------------------------------------

def _abs_close(a, b, atol):
    """|a−b| ≤ atol with NO relative term: np.isclose's default rtol=1e-5
    scales with magnitude, so a width-5 slab on bounds near 1e6 would be
    falsely classified as an implicit equality."""
    with np.errstate(invalid="ignore"):
        return np.abs(np.asarray(a) - np.asarray(b)) <= atol


def _pad_rows(A, l, u, m_pad):
    m, n = A.shape
    if m == m_pad:
        mask = np.ones(m, dtype=bool)
        return A, l, u, mask
    Ap = np.zeros((m_pad, n))
    lp = np.full(m_pad, -_INF)
    up = np.full(m_pad, _INF)
    Ap[:m] = A
    lp[:m] = l
    up[:m] = u
    mask = np.zeros(m_pad, dtype=bool)
    mask[:m] = True
    return Ap, lp, up, mask


def _group_indices(shapes):
    groups = defaultdict(list)
    for i, s in enumerate(shapes):
        groups[s].append(i)
    return groups


# --------------------------------------------------------------------------
#  exemplar / emptiness
# --------------------------------------------------------------------------

def exemplar_batch(polys: Sequence[Poly], tol: float = 1e-2,
                   _verdict_only: bool = False):
    """Batched ε-inflation feasibility check (sets.jl:591-642).

    For each poly solves  min ε  s.t. Ax + ε ≥ l, −Ax + ε ≥ −u  and decides:
    ε* > tol ⇒ empty; |ε*| ≤ tol ⇒ empty iff a *strict* bound is active (dual
    nonzero on an open row); else nonempty with ``example = x*``.

    Returns (empty: bool array, examples: list of x or None).

    ``_verdict_only=True`` (the is_empty/is_empty_batch path) allows the
    native exact-pivot engine: the EMPTINESS verdict is value-determined
    (ε* is unique), so the engines agree on it — but the witness POINT is
    selection-dependent (vertex vs interior-ish), so verdict-only results
    are cached in a separate namespace and their witnesses never leak to
    witness-consuming callers.
    """
    B = len(polys)
    empty = np.zeros(B, dtype=bool)
    examples: List[Optional[np.ndarray]] = [None] * B
    if B == 0:
        return empty, examples

    from ..config import CONFIG as _CFG
    use_host = (_CFG.exemplar_engine == "host"
                or (_verdict_only and _CFG.empty_engine == "host"))
    # content-addressed memo: emptiness/exemplar are pure in the poly.
    # Witness-grade entries live under b"exemplar"; host verdict-only
    # entries under b"empty" (verdict consumers accept either).
    from .query_cache import CACHE, poly_key
    keys = [(b"exemplar", poly_key(p), round(tol, 9)) for p in polys]
    todo = []
    first_for_key = {}
    dupes = []          # (i, j): lane i copies the result of solved lane j
    for i, k in enumerate(keys):
        hit = CACHE.get(k)
        if hit is None and _verdict_only:
            hit = CACHE.get((b"empty",) + k[1:])
        if hit is not None:
            empty[i], examples[i] = hit
        elif k in first_for_key:
            # content-duplicate within this call (all-pairs callers feed
            # many): solve once, copy the verdict
            dupes.append((i, first_for_key[k]))
        else:
            first_for_key[k] = len(todo)
            todo.append(i)
    if not todo:
        return empty, examples
    polys_all, empty_all, examples_all = polys, empty, examples
    polys = [polys_all[i] for i in todo]
    B = len(polys)
    empty = np.zeros(B, dtype=bool)
    examples = [None] * B
    uncertified = np.zeros(B, dtype=bool)

    # group by (n_dim, bucketed 2m rows)
    shapes = [(p.dim, row_bucket(max(2 * p.m, 2))) for p in polys]
    for (n, mp), idxs in _group_indices(shapes).items():
        Ps, qs, As, ls, us, masks = [], [], [], [], [], []
        for i in idxs:
            p = polys[i]
            m = p.m
            # vars: [x (n); eps] ; rows: [A x + eps >= l ; -A x + eps >= -u]
            AA = np.zeros((mp, n + 1))
            AA[:m, :n] = p.A
            AA[m:2 * m, :n] = -p.A
            AA[:2 * m, n] = 1.0
            ll = np.full(mp, -_INF)
            uu = np.full(mp, _INF)
            ll[:m] = np.where(np.isfinite(p.l), p.l, -_INF)
            ll[m:2 * m] = np.where(np.isfinite(p.u), -p.u, -_INF)
            # rows with infinite bound are vacuous: mask them off
            mask = np.zeros(mp, dtype=bool)
            mask[:m] = np.isfinite(p.l)
            mask[m:2 * m] = np.isfinite(p.u)
            AA[~mask] = 0.0
            ll[~mask] = -_INF
            q = np.zeros(n + 1)
            q[n] = 1.0
            Ps.append(np.zeros((n + 1, n + 1)))
            qs.append(q)
            As.append(AA)
            ls.append(ll)
            us.append(uu)
            masks.append(mask)
        sol = None
        host_lane = np.zeros(len(idxs), dtype=bool)
        if use_host and not (_CFG.exemplar_engine == "host"):
            # Verdict-only host screen.  The verdict is value-determined
            # (ε* unique) EXCEPT when the poly has strict rows and ε*
            # falls in the (−tol, tol] boundary band, where the decision
            # reads dual activity — which is selection-dependent.  The
            # host engine therefore decides only the clean lanes; the
            # boundary band re-solves with the ADMM engine so the
            # decision procedure stays identical to the witness path.
            from ..ops.lemke import solve_lp_host_batch
            hs = solve_lp_host_batch(
                np.array(qs), np.array(As), np.array(ls), np.array(us),
                np.array(masks))
            for k, i in enumerate(idxs):
                p = polys[i]
                if p.m == 0:
                    host_lane[k] = True
                    continue
                stk = int(np.asarray(hs.status)[k])
                epsk = float(np.asarray(hs.x)[k, p.dim])
                has_strict = bool(np.any(
                    (p.strict_l & np.isfinite(p.l))
                    | (p.strict_u & np.isfinite(p.u))))
                if stk == batch_qp.DUAL_INFEASIBLE:
                    host_lane[k] = True          # strictly feasible
                elif stk == batch_qp.SOLVED and (
                        not has_strict or epsk > tol or epsk <= -tol):
                    host_lane[k] = True
            if host_lane.all():
                sol = hs
            elif host_lane.any():
                sub = [j for j, h in enumerate(host_lane) if not h]
                ss = batch_qp.solve_qp_batch_padded(
                    np.array([Ps[j] for j in sub]),
                    np.array([qs[j] for j in sub]),
                    np.array([As[j] for j in sub]),
                    np.array([ls[j] for j in sub]),
                    np.array([us[j] for j in sub]),
                    np.array([masks[j] for j in sub]), eps=1e-6)
                X = np.array(hs.x)
                Y = np.array(hs.y)
                St = np.array(hs.status)
                X[sub] = np.asarray(ss.x)
                Y[sub] = np.asarray(ss.y)
                St[sub] = np.asarray(ss.status)
                sol = batch_qp.QPSolution(
                    x=X, y=Y, z=hs.z, obj=hs.obj, status=St,
                    prim_res=hs.prim_res, dual_res=hs.dual_res,
                    iters=hs.iters)
        elif use_host:
            # opt-in full host exemplar engine (witness-grade by request)
            from ..ops.lemke import solve_lp_host_batch
            sol = solve_lp_host_batch(
                np.array(qs), np.array(As), np.array(ls), np.array(us),
                np.array(masks))
            host_lane[:] = True
        if sol is None:
            # eps 1e-6: the ε*/dual decisions here compare against
            # tol=1e-2 / 1e-6, and the terminal active-set polish inside
            # the ADMM kernel recovers ~1e-10 residuals once the active
            # set is identified — the default 1e-9 first-order tolerance
            # costs thousands of extra lockstep iterations on these
            # min-margin LPs for nothing
            sol = batch_qp.solve_qp_batch_padded(
                np.array(Ps), np.array(qs), np.array(As), np.array(ls),
                np.array(us), np.array(masks), eps=1e-6)
        X = np.asarray(sol.x)
        Y = np.asarray(sol.y)
        St = np.asarray(sol.status)
        for k, i in enumerate(idxs):
            p = polys[i]
            m = p.m
            if m == 0:
                empty[i] = False
                examples[i] = np.zeros(p.dim)
                continue
            if St[k] == batch_qp.MAX_ITER:
                # UNCONVERGED: decide best-effort from the iterate but mark
                # the lane so the verdict is NEVER cached (support_batch's
                # discipline) — a garbage eps replayed process-wide would
                # poison every later emptiness/subset query on this poly
                uncertified[i] = True
            if St[k] == batch_qp.DUAL_INFEASIBLE:
                # eps unbounded below ⇒ strictly feasible; the iterate is
                # NOT a solved-LP optimum though — only pass it on as a
                # witness if it actually lies in the poly
                empty[i] = False
                x = X[k, :p.dim]
                examples[i] = x if p.closure().contains(
                    x, tol=max(tol, 1e-6)) else None
                continue
            eps = X[k, p.dim]
            x = X[k, :p.dim]
            if eps > tol or St[k] == batch_qp.PRIMAL_INFEASIBLE:
                empty[i] = True
            elif eps > -tol:
                # boundary case: strict rows active ⇒ empty (sets.jl:624-641)
                yl = Y[k, :m]
                yu = Y[k, m:2 * m]
                open_low = p.strict_l & np.isfinite(p.l)
                open_hi = p.strict_u & np.isfinite(p.u)
                act_l = np.abs(yl) > tol
                act_u = np.abs(yu) > tol
                if np.any(act_l & open_low) or np.any(act_u & open_hi):
                    empty[i] = True
                else:
                    examples[i] = x
            else:
                examples[i] = x
    host_witness = use_host and not (_CFG.exemplar_engine == "host")
    for j, i in enumerate(todo):
        empty_all[i] = empty[j]
        examples_all[i] = examples[j]
        if uncertified[j]:
            continue          # never cache an unconverged solve's verdict
        if host_witness:
            # vertex-selected witness: cache the verdict only, in the
            # verdict namespace — never as a witness-grade exemplar
            CACHE.put((b"empty",) + keys[i][1:], (bool(empty[j]), None))
        else:
            CACHE.put(keys[i], (bool(empty[j]), examples[j]))
    for i, j in dupes:
        empty_all[i] = empty[j]
        examples_all[i] = examples[j]
    return empty_all, examples_all


def is_empty(poly: Poly, tol: float = 1e-4, x=None) -> bool:
    """sets.jl:647-655: short-circuit on a witness point, else exemplar."""
    if x is not None and poly.contains(np.asarray(x)[: poly.dim], tol):
        return False
    # tol is FORWARDED to the ε-inflation decision, matching the reference
    # (isempty's tol=1e-4 reaches exemplar, sets.jl:646-655 — the bare
    # exemplar default is the looser 1e-2)
    empty, _ = exemplar_batch([poly], tol=tol, _verdict_only=True)
    return bool(empty[0])


def is_empty_batch(polys: Sequence[Poly], tol: float = 1e-4, x=None):
    """Batched emptiness with optional shared witness point.

    With the screen on (``config.screen_enabled``), an f32 projected-
    subgradient screen (``ops/screen.feasibility_screen``) first harvests
    cheap witnesses for batches of ≥4 polys of one dimension without strict
    rows; only unwitnessed polys pay for the exact f64 ε-inflation LP.  A
    failure of the screen raises."""
    polys = list(polys)
    need = []
    out = np.zeros(len(polys), dtype=bool)
    for i, p in enumerate(polys):
        if x is not None and p.contains(np.asarray(x)[: p.dim], tol):
            out[i] = False
        else:
            need.append(i)
    if need:
        from ..config import screen_enabled
        if screen_enabled() and len(need) >= 4:
            sub = [polys[i] for i in need]
            if len({p.dim for p in sub}) == 1 and not any(
                    p.strict_l.any() or p.strict_u.any() for p in sub):
                # Correctness note: the screen can only SKIP exact LPs for
                # polys whose witness point was host-verified inside
                # feasibility_screen — a faulty kernel cannot flip
                # emptiness results, it can only waste the screen.  A
                # kernel that fails raises: there is no fallback.
                from ..ops.screen import feasibility_screen
                from ..utils.metrics import METRICS
                # margin = the caller's tol: the exact decision is
                # "empty iff eps* > tol", so a witness may skip the LP only
                # when its violation is within THAT tolerance — a looser
                # default would flip boundary verdicts
                witnessed, _ = feasibility_screen(
                    sub, x0=None if x is None else
                    np.asarray(x)[: sub[0].dim], margin=tol)
                METRICS.bump("screen_polys", len(sub))
                METRICS.bump("screen_witnessed", int(witnessed.sum()))
                need = [i for i, w in zip(need, witnessed) if not w]
    if need:
        # tol forwarded to the ε-inflation decision (reference parity:
        # sets.jl:646-655 passes isempty's tol through to exemplar)
        empty, _ = exemplar_batch([polys[i] for i in need], tol=tol,
                                  _verdict_only=True)
        for k, i in enumerate(need):
            out[i] = empty[k]
    return out


# --------------------------------------------------------------------------
#  membership (incl. partial x) — sets.jl:820-848
# --------------------------------------------------------------------------

def contains_batch(polys: Sequence[Poly], xs, tol: float = 1e-6):
    """For each (poly, x): membership. len(x) may be < dim (partial x): the
    remaining coordinates are existentially quantified (an LP)."""
    B = len(polys)
    out = np.zeros(B, dtype=bool)
    lp_idx = []
    for i, p in enumerate(polys):
        x = np.asarray(xs[i], dtype=np.float64)
        if x.shape[0] == p.dim:
            out[i] = p.contains(x, tol)
        else:
            lp_idx.append(i)
    if not lp_idx:
        return out
    # ε-inflation feasibility over the free tail coordinates
    slices = []
    for i in lp_idx:
        p = polys[i]
        x = np.asarray(xs[i], dtype=np.float64)
        nfix = x.shape[0]
        shift = p.A[:, :nfix] @ x
        slices.append(Poly(p.A[:, nfix:], p.l - shift, p.u - shift,
                           p.strict_l, p.strict_u, normalize=False))
    empty, _ = exemplar_batch(slices, tol=max(tol, 1e-6),
                              _verdict_only=True)
    for k, i in enumerate(lp_idx):
        out[i] = not empty[k]
    return out


def contains(x, poly: Poly, tol: float = 1e-6) -> bool:
    return bool(contains_batch([poly], [np.asarray(x)], tol)[0])


# --------------------------------------------------------------------------
#  support values — backs issubset and implicit_bounds
# --------------------------------------------------------------------------

def support_batch(polys: Sequence[Poly], dirs: Sequence[np.ndarray]):
    """For each (poly, direction) pair: minimize d'x over the closed poly.

    Returns (vals, status) where vals[i] = min, -inf if unbounded,
    +inf if the poly is empty (primal infeasible)."""
    B = len(polys)
    vals = np.zeros(B)
    stat = np.zeros(B, dtype=int)
    if B == 0:
        return vals, stat
    # content-addressed memo: support values are pure in (poly, direction)
    from .query_cache import CACHE, dir_key, poly_key
    keys = [(b"support", poly_key(p), dir_key(d))
            for p, d in zip(polys, dirs)]
    todo = []
    first_for_key = {}
    dupes = []          # (i, j): lane i copies the result of solved lane j
    for i, k in enumerate(keys):
        hit = CACHE.get(k)
        if hit is not None:
            vals[i], stat[i] = hit
        elif k in first_for_key:
            dupes.append((i, first_for_key[k]))
        else:
            first_for_key[k] = len(todo)
            todo.append(i)
    if not todo:
        return vals, stat
    vals_all, stat_all, polys_all, dirs_all = vals, stat, polys, dirs
    polys = [polys_all[i] for i in todo]
    dirs = [dirs_all[i] for i in todo]
    B = len(polys)
    vals = np.zeros(B)
    stat = np.zeros(B, dtype=int)
    shapes = [(p.dim, row_bucket(max(p.m, 1))) for p in polys]
    for (n, mp), idxs in _group_indices(shapes).items():
        Ps, qs, As, ls, us, masks = [], [], [], [], [], []
        for i in idxs:
            p = polys[i]
            A, l, u, mask = _pad_rows(p.A, p.l, p.u, mp)
            Ps.append(np.zeros((n, n)))
            qs.append(np.asarray(dirs[i], dtype=np.float64))
            As.append(A)
            ls.append(l)
            us.append(u)
            masks.append(mask)
        from ..config import CONFIG as _CFG
        sol = None
        if _CFG.support_engine == "host":
            # native exact-shape pivot engine: support values are unique,
            # so swapping the engine cannot alter downstream decisions
            # (unlike argmin-dependent queries); ~60 exact pivots on a
            # tiny tableau beat thousands of first-order iterations
            from ..ops.lemke import solve_lp_host_batch
            sol = solve_lp_host_batch(
                np.array(qs), np.array(As), np.array(ls), np.array(us),
                np.array(masks))
        if sol is None and _CFG.support_engine == "lemke":
            # batched pivot engine on CONFIG.device (kept for engine
            # cross-checks)
            sol = batch_qp.solve_qp_batch_padded(
                np.array(Ps), np.array(qs), np.array(As), np.array(ls),
                np.array(us), np.array(masks), _prefer_lemke=True)
        if sol is None:
            # eps 1e-7 (vs default 1e-9): support values feed ⊆ margins at
            # tol=1e-6; the terminal polish lands exact objectives once
            # the optimal active set is identified
            sol = batch_qp.solve_qp_batch_padded(
                np.array(Ps), np.array(qs), np.array(As), np.array(ls),
                np.array(us), np.array(masks), eps=1e-7)
        OBJ = np.asarray(sol.obj)
        St = np.asarray(sol.status)
        for k, i in enumerate(idxs):
            stat[i] = St[k]
            if St[k] == batch_qp.DUAL_INFEASIBLE:
                vals[i] = -_INF
            elif St[k] == batch_qp.PRIMAL_INFEASIBLE:
                vals[i] = _INF
            else:
                vals[i] = OBJ[k]
    for j, i in enumerate(todo):
        vals_all[i] = vals[j]
        stat_all[i] = stat[j]
        # UNCONVERGED solves (MAX_ITER) must not poison the cache: the
        # objective value is garbage and a cached garbage value would be
        # reused for the rest of the process
        if stat[j] != batch_qp.MAX_ITER:
            CACHE.put(keys[i], (float(vals[j]), int(stat[j])))
    for i, j in dupes:
        vals_all[i] = vals[j]
        stat_all[i] = stat[j]
    return vals_all, stat_all


def issubset_pairs(pairs, tol: float = 1e-6):
    """Batched ``P1 ⊆ P2`` for a list of (P1, P2) pairs (sets.jl:377-407).

    P1 ⊆ P2 iff for every finite bound row (a, b, dir) of P2 the support of P1
    satisfies min dir·a'x ≥ dir·b − tol.  Matches the reference exactly,
    including its quirk that an *empty* P1 whose support LP reports
    infeasibility yields False."""
    # Cheap exemplar certificate first: a point of P1 clearly violating a
    # row of P2 disproves P1 ⊆ P2 with pure host arithmetic.  Solution-map
    # pieces have pairwise-disjoint interiors, so the (cached) ε-inflation
    # exemplar — a max-margin interior point — resolves almost every
    # non-subset pair without an LP.  Borderline points fall through.
    out = np.ones(len(pairs), dtype=bool)
    uniq = []
    seen_ids = {}
    for P1, _ in pairs:
        if id(P1) not in seen_ids:
            seen_ids[id(P1)] = len(uniq)
            uniq.append(P1)
    empty1, ex1 = exemplar_batch(uniq)
    undecided = []
    for pi, (P1, P2) in enumerate(pairs):
        k = seen_ids[id(P1)]
        if empty1[k]:
            out[pi] = False          # reference quirk: empty P1 ⇒ False
            continue
        x = ex1[k]
        if x is not None:
            ax = P2.A @ x
            with np.errstate(invalid="ignore"):
                v = np.maximum(
                    np.where(np.isfinite(P2.l), P2.l - ax, -np.inf),
                    np.where(np.isfinite(P2.u), ax - P2.u, -np.inf))
            # certificate threshold must match the LP path's acceptance
            # (support ≥ bound − tol): a violation within tol would still
            # be accepted there, so only a >tol violation may short-circuit
            if np.nanmax(v, initial=-np.inf) > max(tol, 1e-5):
                out[pi] = False      # certified non-subset
                continue
        undecided.append(pi)
    if not undecided:
        return out

    # Deduplicate support queries: in an all-pairs prune the same P1 is
    # tested against every other member, and members of one solution-map
    # union share normalized hyperplanes (same GAVI arrangement), so the
    # distinct (P1, direction) set is FAR smaller than pairs × facets.
    qkey_to_slot = {}
    slot_polys, slot_dirs = [], []
    checks = []           # (pair_idx, slot, bound, sign)
    for pi in undecided:
        P1, P2 = pairs[pi]
        for i in range(P2.m):
            for d, bound, sgn in (((P2.A[i]), P2.l[i], 1.0),
                                  ((-P2.A[i]), P2.u[i], -1.0)):
                if not np.isfinite(bound):
                    continue
                key = (id(P1), tuple(np.round(d, 9)))
                slot = qkey_to_slot.get(key)
                if slot is None:
                    slot = len(slot_polys)
                    qkey_to_slot[key] = slot
                    slot_polys.append(P1)
                    slot_dirs.append(d)
                checks.append((pi, slot, bound, sgn))
    if not checks:
        return out
    vals, stat = support_batch(slot_polys, slot_dirs)
    for pi, slot, bound, sgn in checks:
        if stat[slot] not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
            out[pi] = False          # unbounded below / infeasible
        elif vals[slot] < sgn * bound - tol:
            out[pi] = False
    return out


def issubset(P1: Poly, P2: Poly, tol: float = 1e-6) -> bool:
    return bool(issubset_pairs([(P1, P2)], tol)[0])


def issubset_union(P1: Poly, PU: PolyUnion, tol: float = 1e-6) -> bool:
    """Conservative union-subset test (sets.jl:1015-1018): 'true' is correct,
    'false' may be a false negative."""
    return any(issubset(P1, P, tol) for P in PU)


# --------------------------------------------------------------------------
#  implicit bounds / intrinsic dimension — sets.jl:660-729
# --------------------------------------------------------------------------

class EmptySetError(RuntimeError):
    pass


def implicit_bounds(poly: Poly, tol: float = 1e-4):
    """Rows whose min and max over the poly coincide are implicit equalities.
    Raises EmptySetError when the poly is empty (sets.jl:683-684)."""
    m = poly.m
    implicitly_equality = np.zeros(m, dtype=bool)
    vals = np.full(m, _INF)
    todo = []
    for i in range(m):
        if _abs_close(poly.l[i], poly.u[i], tol):
            implicitly_equality[i] = True
            vals[i] = 0.5 * (poly.l[i] + poly.u[i])
        else:
            todo.append(i)
    if todo:
        polys = [poly] * (2 * len(todo))
        dirs = [poly.A[i] for i in todo] + [-poly.A[i] for i in todo]
        v, s = support_batch(polys, dirs)
        for k, i in enumerate(todo):
            lo_v, lo_s = v[k], s[k]
            hi_v, hi_s = v[len(todo) + k], s[len(todo) + k]
            if lo_s == batch_qp.PRIMAL_INFEASIBLE or hi_s == batch_qp.PRIMAL_INFEASIBLE:
                raise EmptySetError("Empty set")
            if lo_s == batch_qp.MAX_ITER or hi_s == batch_qp.MAX_ITER:
                # unconverged support value: its objective is garbage —
                # conservatively treat the row as NOT an implicit equality
                # rather than classify on noise
                continue
            val_low = -_INF if lo_s == batch_qp.DUAL_INFEASIBLE else lo_v
            val_hi = _INF if hi_s == batch_qp.DUAL_INFEASIBLE else -hi_v
            if np.isfinite(val_low) and np.isfinite(val_hi) and \
                    _abs_close(val_low, val_hi, tol):
                implicitly_equality[i] = True
                vals[i] = 0.5 * (val_low + val_hi)
    return implicitly_equality, vals


def intrinsic_dim(poly: Poly, tol: float = 1e-4) -> int:
    """embedded_dim − rank of implicit-equality rows (sets.jl:718-729)."""
    try:
        impl, _ = implicit_bounds(poly, tol)
    except EmptySetError:
        return 0
    Aim = poly.A[impl]
    r = int(np.linalg.matrix_rank(Aim)) if Aim.size else 0
    return poly.dim - r


def eliminate_variables(poly: Poly, indices) -> Poly:
    """Substitute out variables pinned by implicit equalities (sets.jl:731-814),
    with the same rank-deficiency fallback: columns that cannot be pinned are
    kept. Pure pivoted-QR elimination on host (setup-scale, not hot).
    The result lives in the reduced space (columns = kept coordinates in
    order)."""
    elim = np.asarray(sorted(indices), dtype=int)
    d = poly.dim
    keep = np.array([i for i in range(d) if i not in set(elim.tolist())], dtype=int)
    if len(elim) == 0:
        return poly
    try:
        impl, vals = implicit_bounds(poly)
    except EmptySetError:
        return poly
    A, l, u, sl, su = poly.vectorize()
    ineq = ~impl
    Ae_elim = A[impl][:, elim]
    rank = int(np.linalg.matrix_rank(Ae_elim)) if Ae_elim.size else 0
    if rank < len(elim):
        # pick an eliminable column subset — greedy rank-revealing sweep
        # (the reference's pivoted-QR fallback, sets.jl:763-796)
        cols = []
        cur = np.zeros((Ae_elim.shape[0], 0))
        for j in range(Ae_elim.shape[1]):
            cand = np.hstack([cur, Ae_elim[:, j:j + 1]])
            if np.linalg.matrix_rank(cand) > cur.shape[1]:
                cur = cand
                cols.append(j)
        new_elim = elim[cols]
        keep = np.array(sorted(set(range(d)) - set(new_elim.tolist())), dtype=int)
        elim = new_elim
        if len(elim) == 0:
            return poly
        Ae_elim = A[impl][:, elim]
    Ae_keep = A[impl][:, keep]
    Ai_elim = A[ineq][:, elim]
    Ai_keep = A[ineq][:, keep]
    rhs = vals[impl]
    # x_elim = Ad (rhs − Ae_keep x_keep), Ad = pseudo-inverse
    Ad = np.linalg.pinv(Ae_elim)
    P = np.eye(Ae_elim.shape[0]) - Ae_elim @ Ad
    Ae = P @ Ae_keep
    be = P @ rhs
    Ai = Ai_keep - Ai_elim @ Ad @ Ae_keep
    ci = Ai_elim @ Ad @ rhs
    A_new = np.vstack([Ae, Ai])
    l_new = np.concatenate([be, l[ineq] - ci])
    u_new = np.concatenate([be, u[ineq] - ci])
    sl_new = np.concatenate([sl[impl], sl[ineq]])
    su_new = np.concatenate([su[impl], su[ineq]])
    # the result lives in the REDUCED space: its columns are the `keep`
    # coordinates in order (dim = len(keep), not poly.dim)
    return Poly(A_new, l_new, u_new, sl_new, su_new)


# --------------------------------------------------------------------------
#  remove_subsets — sets.jl:889-905
# --------------------------------------------------------------------------

def remove_subsets(pu: Optional[PolyUnion], tol: float = 1e-6):
    """Prune polys contained in another member.  All pairwise containment LPs
    run as ONE batch; the keep/remove decision then replays the reference's
    serial loop so the tie-break for mutually-contained sets is identical
    (the reference disabled threading over exactly this, sets.jl:890-893).

    Above ``CONFIG.prune_dedup_threshold`` pieces the O(N²) Python pair
    materialization would dominate (the regime the ring prune exists for,
    sets.jl:889-905 hazard): a signature-duplicate prune runs FIRST (over
    the ranks of a process group of more than one rank, see
    :func:`_dedup_signatures`), and the geometric stage then uses a
    vectorized exemplar screen so only certificate-ambiguous pairs
    materialize as LPs."""
    if pu is None:
        return None
    N = len(pu)
    if N <= 1:
        return pu
    from ..config import CONFIG
    if N > CONFIG.prune_dedup_threshold:
        pu = _dedup_signatures(pu)
        N = len(pu)
        if N <= 1:
            return pu
    if N > CONFIG.prune_dedup_threshold:
        return _remove_subsets_large(pu, tol)
    pairs = [(pu[i], pu[j]) for i in range(N) for j in range(N) if i != j]
    flags = issubset_pairs(pairs, tol)
    S = np.zeros((N, N), dtype=bool)
    k = 0
    for i in range(N):
        for j in range(N):
            if i != j:
                S[i, j] = flags[k]
                k += 1
    return _serial_keep(pu, S)


def _serial_keep(pu: PolyUnion, S: np.ndarray) -> PolyUnion:
    """The reference's serial keep loop (sets.jl:895-905): piece i drops iff
    it is a subset of a not-yet-dropped j — the deterministic tie-break that
    keeps exactly one member of each mutual-containment group."""
    N = len(pu)
    is_subset = np.zeros(N, dtype=bool)
    for i in range(N):
        if any(S[i, j] and not is_subset[j] for j in range(N) if j != i):
            is_subset[i] = True
    return PolyUnion([pu[i] for i in range(N) if not is_subset[i]])


def piece_signature(p: Poly) -> np.ndarray:
    """(5,) int32 content signature of a poly's normalized H-rep, rounded to
    the framework's 5-digit dedup precision (sets.jl:105-112 convention).
    Equal signatures ⇔ identical pieces at that precision."""
    import hashlib
    rows = np.round(np.column_stack([
        p.A, p.l, p.u,
        p.strict_l.astype(np.float64), p.strict_u.astype(np.float64)]), 5)
    rows = rows[np.lexsort(rows.T[::-1])]            # row-order canonical
    h = hashlib.sha1(np.ascontiguousarray(rows).tobytes()
                     + p.dim.to_bytes(4, "little")).digest()
    return np.frombuffer(h[:20], dtype=np.int32).copy()


def _dedup_signatures(pu: PolyUnion) -> PolyUnion:
    """Drop exact (5-digit) duplicate pieces, keeping the LAST of each group
    — the member the serial containment loop would keep.

    Where the JAX package tests for more than one device, the port tests
    for a ``torch.distributed`` process group of more than one rank: then
    the prune is collective (``parallel.sharded.sharded_containment_prune``
    over ``multihost.global_mesh()``, ring-rotated above its threshold) and
    every rank must call this with the same pieces, as SPMD code does.
    Otherwise, and in a scenario thread of a lockstep broker (whose threads
    would meet the other ranks' collectives in thread order), the host loop
    runs.  The mask is the same either way."""
    import torch.distributed as dist
    from ..parallel.lockstep import active_broker
    from ..utils.metrics import METRICS
    N = len(pu)
    sig = np.stack([piece_signature(p) for p in pu.polys])
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1 and active_broker() is None:
        from ..parallel.multihost import global_mesh
        from ..parallel.sharded import sharded_containment_prune
        mesh = global_mesh()
        # reversed index ⇒ lowest-wins dominance keeps the LAST duplicate,
        # the serial loop's tie-break for identical pieces
        order = np.arange(N - 1, -1, -1)
        pad = -(-N // mesh.size) * mesh.size - N
        if pad:
            # padded lanes: unique signatures (the row index baked in) that
            # never dominate a real lane
            filler = np.full((pad, sig.shape[1]), -(2 ** 31 - 1), np.int32)
            filler[:, 0] = np.arange(pad)
            sig_p = np.concatenate([sig, filler])
            order_p = np.concatenate([order, N + np.arange(pad)])
        else:
            sig_p, order_p = sig, order
        keep = sharded_containment_prune(
            mesh, sig_p, order_p.astype(np.float64)).cpu().numpy()[:N]
        METRICS.bump("prune_dedup_sharded", N)
    else:
        keep = np.ones(N, dtype=bool)
        seen = {}
        for i in range(N - 1, -1, -1):               # last wins
            key = sig[i].tobytes()
            if key in seen:
                keep[i] = False
            else:
                seen[key] = i
        METRICS.bump("prune_dedup_host", N)
    dropped = int(N - keep.sum())
    if dropped:
        METRICS.bump("prune_dedup_dropped", dropped)
    return PolyUnion([p for p, k in zip(pu.polys, keep) if k])


def _remove_subsets_large(pu: PolyUnion, tol: float) -> PolyUnion:
    """Containment prune without O(N²) Python pair materialization: the
    exemplar certificate screen runs as blockwise numpy over the padded row
    stacks, and only certificate-ambiguous (i, j) pairs fall through to
    support LPs.  Decision semantics identical to the pairwise path."""
    from ..utils.metrics import METRICS
    N = len(pu)
    d = pu[0].dim
    empty, ex = exemplar_batch(list(pu.polys))
    m_max = max(p.m for p in pu.polys)
    A = np.zeros((N, m_max, d))
    lo = np.full((N, m_max), -_INF)
    up = np.full((N, m_max), _INF)
    for j, p in enumerate(pu.polys):
        A[j, :p.m] = p.A
        lo[j, :p.m] = p.l
        up[j, :p.m] = p.u
    X = np.zeros((N, d))
    has_x = np.zeros(N, dtype=bool)
    for i in range(N):
        if not empty[i] and ex[i] is not None:
            X[i] = ex[i]
            has_x[i] = True
    thr = max(tol, 1e-5)
    # blockwise violation of exemplar x_i against every piece j's rows
    maybe = np.zeros((N, N), dtype=bool)     # pair (i, j) needs the LP path
    blk = max(1, int(2e7 // (N * m_max)) or 1)
    for j0 in range(0, N, blk):
        j1 = min(N, j0 + blk)
        ax = np.einsum("jmd,id->ijm", A[j0:j1], X)
        with np.errstate(invalid="ignore"):
            v = np.maximum(
                np.where(np.isfinite(lo[None, j0:j1]), lo[None, j0:j1] - ax,
                         -_INF),
                np.where(np.isfinite(up[None, j0:j1]), ax - up[None, j0:j1],
                         -_INF))
        viol = np.nanmax(v, axis=2, initial=-_INF) > thr
        maybe[:, j0:j1] = ~viol
    # exemplar-less pieces can't be screened; empty pieces are never subsets
    maybe[~has_x & ~np.asarray(empty, dtype=bool), :] = True
    maybe[np.asarray(empty, dtype=bool), :] = False
    np.fill_diagonal(maybe, False)
    idx_pairs = np.argwhere(maybe)
    METRICS.bump("prune_large_lp_pairs", len(idx_pairs))
    S = np.zeros((N, N), dtype=bool)
    if len(idx_pairs):
        pairs = [(pu[int(i)], pu[int(j)]) for i, j in idx_pairs]
        flags = issubset_pairs(pairs, tol)
        for (i, j), f in zip(idx_pairs, flags):
            S[int(i), int(j)] = f
    return _serial_keep(pu, S)
