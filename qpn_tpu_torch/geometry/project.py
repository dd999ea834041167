"""Polyhedral projection without double description — the cdd replacement
(copy of ``qpn_tpu/geometry/project.py``; numpy host code).

The reference projects solution-map pieces to x-space by a V-rep round-trip
through cdd (sets.jl:501-523: H-rep → vertices/rays → apply selection matrix →
back to H-rep).  That is inherently serial, exponential in the worst case, and
hostile to batching.  Here projection is *symbolic on the H-rep*:

1. **Equality elimination** — variables pinned by (implicit) equality rows are
   Gauss-eliminated exactly.  In the enumeration pipeline most eliminated
   coordinates (duals λ, slacks s) are pinned by the active-set recipe K, so
   this step usually removes everything (the reference exploits the same
   structure in local_piece's "reducible" reduction, avi_solutions.jl:441-491).
2. **Fourier–Motzkin** on the few remaining coordinates, with parallel-row
   merging and (optionally) batched-LP redundancy pruning.

This covers all projection uses in the framework; there is no V-rep anywhere
in the hot path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .poly import Poly
from . import setops

_EQ_TOL = 1e-9
_PIV_TOL = 1e-9
_FM_ROW_CAP = 4096


def _rows_as_onesided(A, l, u, sl, su):
    """Split two-sided rows into ≤-form (c, b, strict) pairs."""
    cs, bs, st = [], [], []
    for i in range(A.shape[0]):
        if np.isfinite(u[i]):
            cs.append(A[i].copy())
            bs.append(u[i])
            st.append(bool(su[i]))
        if np.isfinite(l[i]):
            cs.append(-A[i])
            bs.append(-l[i])
            st.append(bool(sl[i]))
    if not cs:
        return np.zeros((0, A.shape[1])), np.zeros(0), np.zeros(0, dtype=bool)
    return np.array(cs), np.array(bs), np.array(st)


def eliminate_by_equalities(A, l, u, sl, su, elim_cols):
    """Gauss-eliminate columns in ``elim_cols`` using explicit equality rows
    (l == u).  Returns updated (A, l, u, sl, su, remaining_elim_cols)."""
    A = A.copy(); l = l.copy(); u = u.copy()
    sl = sl.copy(); su = su.copy()
    remaining = list(elim_cols)
    alive = np.ones(A.shape[0], dtype=bool)
    progress = True
    while progress:
        progress = False
        # strict-flagged l == u rows are EMPTY-set markers (a'x <= b
        # AND a'x < b), not equalities -- consuming one as a pivot
        # would erase the infeasibility
        eq = (alive & np.isfinite(l) & np.isfinite(u)
              & (np.abs(u - l) < _EQ_TOL) & ~sl & ~su)
        for j in list(remaining):
            cand = np.where(eq & (np.abs(A[:, j]) > _PIV_TOL))[0]
            if len(cand) == 0:
                continue
            # pivot on the row with the largest coefficient for stability
            i = cand[np.argmax(np.abs(A[cand, j]))]
            piv = A[i, j]
            v = 0.5 * (l[i] + u[i])
            for r in range(A.shape[0]):
                if r == i or not alive[r] or abs(A[r, j]) <= _PIV_TOL:
                    continue
                c = A[r, j] / piv
                A[r] = A[r] - c * A[i]
                A[r, j] = 0.0
                l[r] = l[r] - c * v if np.isfinite(l[r]) else l[r]
                u[r] = u[r] - c * v if np.isfinite(u[r]) else u[r]
            alive[i] = False
            remaining.remove(j)
            progress = True
            eq = (alive & np.isfinite(l) & np.isfinite(u)
                  & (np.abs(u - l) < _EQ_TOL) & ~sl & ~su)
    keep = alive
    return A[keep], l[keep], u[keep], sl[keep], su[keep], remaining


def fourier_motzkin(C, b, strict, j):
    """Eliminate column j from the one-sided system C x ≤ b."""
    pos = C[:, j] > _PIV_TOL
    neg = C[:, j] < -_PIV_TOL
    zero = ~pos & ~neg
    keepC, keepb, keeps = C[zero], b[zero], strict[zero]
    P, N = np.where(pos)[0], np.where(neg)[0]
    if len(P) == 0 or len(N) == 0:
        # variable unbounded on one side: all rows touching it vanish
        out = keepC.copy()
        out[:, j] = 0.0
        return out, keepb, keeps
    newC, newb, news = [], [], []
    for p in P:
        cp = C[p] / C[p, j]
        bp = b[p] / C[p, j]
        for q in N:
            cq = C[q] / (-C[q, j])
            bq = b[q] / (-C[q, j])
            c = cp + cq
            c[j] = 0.0
            newC.append(c)
            newb.append(bp + bq)
            news.append(bool(strict[p] or strict[q]))
    out = np.vstack([keepC] + ([np.array(newC)] if newC else []))
    outb = np.concatenate([keepb] + ([np.array(newb)] if newb else []))
    outs = np.concatenate([keeps] + ([np.array(news, dtype=bool)] if news else []))
    out[:, j] = 0.0
    if out.shape[0] > _FM_ROW_CAP:
        raise RuntimeError(
            f"Fourier-Motzkin blow-up: {out.shape[0]} rows eliminating col {j}")
    return out, outb, outs


def _dedupe_onesided(C, b, strict, tol=1e-9):
    """Normalize by row norm and keep the tightest bound per direction."""
    if C.shape[0] == 0:
        return C, b, strict
    norms = np.linalg.norm(C, axis=1)
    ok = norms > tol
    # zero rows: 0 ≤ b (or 0 < b when strict) must hold; infeasible zero
    # rows are kept as markers.  A STRICT zero row with b ≈ 0 encodes
    # 0 < 0 — exactly what FM produces when combining the two sides of an
    # empty open slab — and must not be silently discarded.
    zero_bad = ~ok & ((b < -tol) | (strict & (b <= tol)))
    Cn = C[ok] / norms[ok, None]
    bn = b[ok] / norms[ok]
    sn = strict[ok]
    best = {}
    for i in range(Cn.shape[0]):
        key = tuple(np.round(Cn[i], 7))
        if key not in best or bn[i] < best[key][0] - tol:
            best[key] = (bn[i], sn[i], i)
        elif sn[i] and bn[i] <= best[key][0]:
            # a strict row may tighten a within-tol closed row ONLY when its
            # bound is actually ≤ the kept one: upgrading `≤ 5` to `< 5`
            # because of a strictly LOOSER `< 5+1e-16` would drop the shared
            # facet (a point at 5 satisfies both originals)
            best[key] = (bn[i], True, best[key][2])
    idx = [v[2] for v in best.values()]
    Co = Cn[idx]
    bo = np.array([best[tuple(np.round(Cn[i], 7))][0] for i in idx])
    so = np.array([best[tuple(np.round(Cn[i], 7))][1] for i in idx], dtype=bool)
    if zero_bad.any():
        # keep one infeasibility marker row 0'x ≤ b < 0
        Co = np.vstack([Co, np.zeros((1, C.shape[1]))])
        bo = np.concatenate([bo, [-1.0]])
        so = np.concatenate([so, [False]])
    return Co, bo, so


def _prune_redundant(C, b, strict, max_rows=64, tol=1e-6):
    """LP-based redundancy removal when FM output grows beyond max_rows.

    Two batched support-LP passes instead of one LP per row: phase 1 tests
    every row against all others; phase 2 re-tests the phase-1 candidates
    against the SURVIVOR set alone, so two mutually-redundant rows can
    never both be dropped (the reference's remove_subsets threading bug is
    the cautionary tale, sets.jl:889-905).  STRICT rows are never dropped —
    redundancy against closed rows would close an open boundary, flipping
    membership on shared facets of solution-map pieces."""
    if C.shape[0] <= max_rows:
        return C, b, strict
    from ..ops import batch_qp

    def _batch_test(indices, keep_mask):
        """Redundant-vs-(keep_mask minus self) verdict per index."""
        polys, dirs = [], []
        for i in indices:
            mask = keep_mask.copy()
            mask[i] = False
            polys.append(Poly(C[mask], np.full(int(mask.sum()), -np.inf),
                              b[mask], normalize=False))
            dirs.append(-C[i])
        vals, stat = setops.support_batch(polys, dirs)
        out = []
        for k, i in enumerate(indices):
            ok = stat[k] in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE)
            # max C[i] x = -min(-C[i] x)
            out.append(bool(ok) and -vals[k] <= b[i] + tol)
        return out

    cand = [i for i in range(C.shape[0]) if not strict[i]]
    if not cand:
        return C, b, strict
    all_mask = np.ones(C.shape[0], dtype=bool)
    red1 = _batch_test(cand, all_mask)
    maybe = [i for i, r in zip(cand, red1) if r]
    if not maybe:
        return C, b, strict
    survivors = all_mask.copy()
    survivors[maybe] = False
    red2 = _batch_test(maybe, survivors)
    keep = all_mask.copy()
    for i, r in zip(maybe, red2):
        if r:
            keep[i] = False
    return C[keep], b[keep], strict[keep]


def project(p: Poly, keep_dims: Sequence[int], prune: bool = True) -> Poly:
    """Project ``p`` onto ``keep_dims`` (result dim = len(keep_dims), columns
    in keep order).  The returned Poly carries ``parent=p`` like the
    reference's ProjectedPoly (sets.jl:501-523)."""
    keep_dims = list(keep_dims)
    d = p.dim
    elim = [j for j in range(d) if j not in set(keep_dims)]
    if not elim:
        out = Poly(p.A[:, keep_dims], p.l, p.u, p.strict_l, p.strict_u,
                   parent=p, normalize=False).simplify()
        return out
    A, l, u, sl, su = p.vectorize()
    A, l, u, sl, su, rem = eliminate_by_equalities(A, l, u, sl, su, elim)
    if rem:
        C, b, st = _rows_as_onesided(A, l, u, sl, su)
        for j in rem:
            C, b, st = fourier_motzkin(C, b, st, j)
            C, b, st = _dedupe_onesided(C, b, st)
        if prune:
            C, b, st = _prune_redundant(C, b, st)
        out = Poly(C[:, keep_dims], np.full(C.shape[0], -np.inf), b,
                   np.zeros(C.shape[0], dtype=bool), st,
                   parent=p)
    else:
        out = Poly(A[:, keep_dims], l, u, sl, su, parent=p)
    return out.simplify()


def permute_columns(p: Poly, positions: Sequence[int], full_dim: int) -> Poly:
    """Scatter the columns of ``p`` into a ``full_dim`` space at ``positions``
    (the reference's permute!, avi_solutions.jl:43-56)."""
    A = np.zeros((p.m, full_dim))
    A[:, list(positions)] = p.A
    return Poly(A, p.l, p.u, p.strict_l, p.strict_u, parent=p.parent,
                normalize=False)
