"""Polyhedral geometry, host-side structures (copy of
``qpn_tpu/geometry/poly.py``; numpy only).

Re-designs the reference's ``src/sets.jl`` (Slice / BasicPoly / ProjectedPoly /
IntersectionPoly / PolyUnion hierarchy, sets.jl:68-207):

* A :class:`Poly` is a *dense H-rep tensor* ``l ⋈ A x ⋈ u`` with per-row
  strictness masks (open bounds, sets.jl:1-13) instead of a Julia ``Set`` of
  sparse ``Slice`` objects.  Rows are normalized exactly like ``Slice``
  (sets.jl:76-89): lexico-positive leading coefficient scaled to +1.
* Intersection is row concatenation (the reference's lazy IntersectionPoly,
  sets.jl:132-134, always flattens before vectorize anyway); projection
  provenance (ProjectedPoly.parent, sets.jl:127-130) is carried as per-row
  parent references for the request subsystem.

All scalars here are numpy float64 on host.  The batched emptiness /
containment queries live in ``setops.py``.
"""

from __future__ import annotations

import numpy as np

from collections import namedtuple

_NORM_TOL = 1e-8
_QUANT_DIGITS = 5  # reference rounds to 5 digits for dedup (sets.jl:105-112)


# Provenance label identifying where a halfspace was introduced in the QPNet
# (sets.jl:53-58).  Carried per row bound; unioned when parallel rows merge.
HalfspaceLabel = namedtuple(
    "HalfspaceLabel", ["level", "subpiece_index", "comp_index", "bound_index"])


def lexico_positive(a, tol: float = _NORM_TOL):
    """(is_lexico_positive, |first nonzero|) — sets.jl:18-25."""
    a = np.asarray(a, dtype=np.float64)
    nz = np.nonzero(np.abs(a) > tol)[0]
    if len(nz) == 0:
        raise ValueError("zero vector has no lexico sign")
    lead = a[nz[0]]
    return bool(lead >= 0), float(abs(lead))


def get_lexico_ordering(A, tol: float = _NORM_TOL):
    """Row ordering by leading-nonzero column (sets.jl:27-46)."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    order = []
    for j in range(n):
        for i in range(m):
            nz = np.nonzero(np.abs(A[i]) > tol)[0]
            if len(nz) == 0:
                if j == 0:
                    order.append(i)
                continue
            if nz[0] == j:
                order.append(i)
    return order


def _normalize_rows(A, l, u, strict_l, strict_u):
    """Slice normalization (sets.jl:76-89): drop tiny entries, scale each row so
    its first nonzero coefficient is +1 (flipping bounds/strictness if the
    leading coefficient is negative)."""
    A = np.array(A, dtype=np.float64, copy=True)
    if A.ndim == 1:
        A = A[None, :]
    m, n = A.shape
    l = np.array(l, dtype=np.float64, copy=True).reshape(m)
    u = np.array(u, dtype=np.float64, copy=True).reshape(m)
    strict_l = np.array(strict_l, dtype=bool, copy=True).reshape(m)
    strict_u = np.array(strict_u, dtype=bool, copy=True).reshape(m)

    A[np.abs(A) < _NORM_TOL] = 0.0
    norms = np.linalg.norm(A, axis=1)
    zero_rows = norms <= _NORM_TOL
    A[zero_rows] = 0.0

    nz = ~zero_rows
    if np.any(nz):
        # first nonzero entry per (nonzero) row
        nonzero_mask = np.abs(A) > 0
        first_idx = np.argmax(nonzero_mask, axis=1)
        lead = A[np.arange(m), first_idx]
        scale = np.abs(lead)
        scale[zero_rows] = 1.0
        neg = (lead < 0) & nz
        A[nz] = A[nz] / scale[nz, None]
        l_new = np.where(nz, l / scale, l)
        u_new = np.where(nz, u / scale, u)
        # sign flip: a -> -a, bounds swap l,u -> -u,-l, strictness swaps
        A[neg] = -A[neg]
        l2 = np.where(neg, -u_new, l_new)
        u2 = np.where(neg, -l_new, u_new)
        sl2 = np.where(neg, strict_u, strict_l)
        su2 = np.where(neg, strict_l, strict_u)
        l, u, strict_l, strict_u = l2, u2, sl2, su2
    return A, l, u, strict_l, strict_u


def _quant_key(A, l, u, strict_l, strict_u):
    Ar = np.round(A, _QUANT_DIGITS) + 0.0  # +0.0 folds -0.0 into 0.0
    lr = np.round(l, _QUANT_DIGITS) + 0.0
    ur = np.round(u, _QUANT_DIGITS) + 0.0
    return [
        (tuple(Ar[i]), lr[i], ur[i], bool(strict_l[i]), bool(strict_u[i]))
        for i in range(A.shape[0])
    ]


class Poly:
    """Not-necessarily-closed polyhedron ``{x : l ⋈ A x ⋈ u}`` in H-rep.

    ``strict_l[i]`` / ``strict_u[i]`` mark open bounds (the reference's
    ``Relation`` ``<`` vs ``≤``, sets.jl:1).  ``parent`` records the
    pre-projection polyhedron for projected pieces (sets.jl:127-130);
    ``row_parents`` maps each row to the sub-poly parent when this Poly is a
    flattened intersection (sets.jl:223-253).
    """

    __slots__ = ("A", "l", "u", "strict_l", "strict_u", "parent",
                 "row_parents", "labels_l", "labels_u", "_key", "_qkey")

    def __init__(self, A, l, u, strict_l=None, strict_u=None, *, parent=None,
                 row_parents=None, labels_l=None, labels_u=None,
                 normalize=True, dedupe=True):
        A = np.asarray(A, dtype=np.float64)
        if A.ndim == 1:
            A = A[None, :]
        m = A.shape[0]
        if strict_l is None:
            strict_l = np.zeros(m, dtype=bool)
        if strict_u is None:
            strict_u = np.zeros(m, dtype=bool)
        if normalize:
            A, l, u, strict_l, strict_u = _normalize_rows(A, l, u, strict_l, strict_u)
        else:
            A = np.array(A, dtype=np.float64, copy=True)
            l = np.array(l, dtype=np.float64, copy=True).reshape(m)
            u = np.array(u, dtype=np.float64, copy=True).reshape(m)
            strict_l = np.array(strict_l, dtype=bool).reshape(m)
            strict_u = np.array(strict_u, dtype=bool).reshape(m)

        if row_parents is None:
            row_parents = [parent] * m
        else:
            row_parents = list(row_parents)
            assert len(row_parents) == m
        labels_l = [frozenset()] * m if labels_l is None else list(labels_l)
        labels_u = [frozenset()] * m if labels_u is None else list(labels_u)

        if dedupe and m > 0:
            # Set-of-Slice semantics: rows equal under 5-digit rounding collapse
            # (sets.jl:104-112); native C++ kernel (utils/native).
            from ..utils.native import dedupe_rows_mask
            stacked = np.column_stack([
                A, np.nan_to_num(l, posinf=1e200, neginf=-1e200),
                np.nan_to_num(u, posinf=1e200, neginf=-1e200),
                strict_l.astype(np.float64), strict_u.astype(np.float64)])
            keep_mask = dedupe_rows_mask(stacked)
            keep = np.nonzero(keep_mask)[0].tolist()
            if len(keep) != m:
                A, l, u = A[keep], l[keep], u[keep]
                strict_l, strict_u = strict_l[keep], strict_u[keep]
                row_parents = [row_parents[i] for i in keep]
                labels_l = [labels_l[i] for i in keep]
                labels_u = [labels_u[i] for i in keep]

        self.A, self.l, self.u = A, l, u
        self.strict_l, self.strict_u = strict_l, strict_u
        self.parent = parent
        self.row_parents = row_parents
        self.labels_l, self.labels_u = labels_l, labels_u
        self._key = None

    # -- basic protocol ----------------------------------------------------
    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    def embedded_dim(self) -> int:  # sets.jl:347-349
        return self.A.shape[1]

    def __len__(self) -> int:
        return self.m

    def vectorize(self):
        """(A, l, u, strict_l, strict_u) — sets.jl:213-221."""
        return self.A, self.l, self.u, self.strict_l, self.strict_u

    def key(self):
        if self._key is None:
            self._key = frozenset(
                _quant_key(self.A, self.l, self.u, self.strict_l, self.strict_u))
        return self._key

    def __eq__(self, other):  # sets.jl:141-146
        return isinstance(other, Poly) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"Poly(m={self.m}, dim={self.dim})"

    # -- parent provenance (sets.jl:223-253) -------------------------------
    def has_parent(self, i: int) -> bool:
        return self.row_parents[i] is not None

    def get_parent(self, i: int):
        return self.row_parents[i]

    # -- algebra -----------------------------------------------------------
    def closure(self) -> "Poly":  # sets.jl:364-372
        return Poly(self.A, self.l, self.u, None, None,
                    parent=self.parent, row_parents=self.row_parents,
                    normalize=False)

    def simplify(self, tol: float = 1e-6) -> "Poly":
        """Merge (near-)parallel rows keeping tightest bounds (sets.jl:255-305).

        Equal-direction rows (within ``tol``) merge: lower bounds take the max,
        upper bounds the min; ties within tol average and keep strictness if
        either side is strict (matching the reference's tie branch)."""
        if self.m <= 1:
            return self
        A, l, u, sl, su = self.A, self.l, self.u, self.strict_l, self.strict_u
        norms = np.linalg.norm(A, axis=1)
        kept: list[int] = []          # representative row index per group
        groups: list[list[int]] = []
        merged = False
        for i in range(self.m):
            if norms[i] <= tol:
                # zero row: trivial unless bounds exclude 0 (keep only if
                # binding).  Strictness matters: l ≤ 0 with strict_l means
                # l < 0 is REQUIRED, so l ≈ 0 strict is infeasible (0 < 0);
                # dropping it would turn an empty poly nonempty.
                if (l[i] > tol) or (u[i] < -tol) \
                        or (sl[i] and l[i] >= -tol) \
                        or (su[i] and u[i] <= tol):
                    kept.append(i)
                    groups.append([i])
                else:
                    merged = True     # row dropped: output differs
                continue
            # one vectorized closeness test against all current reps (the
            # per-pair np.all calls dominated simplify's host time)
            if kept:
                close = np.all(np.abs(A[kept] - A[i]) <= tol, axis=1)
                hit = int(np.argmax(close)) if close.any() else -1
            else:
                hit = -1
            if hit >= 0:
                groups[hit].append(i)
                merged = True
            else:
                kept.append(i)
                groups.append([i])
        if not merged:
            return self               # nothing merged or dropped: identity
        newA, newl, newu, newsl, newsu, rp = [], [], [], [], [], []
        nll, nlu = [], []
        for rep, grp in zip(kept, groups):
            gl, gu = l[grp], u[grp]
            gsl, gsu = sl[grp], su[grp]
            # tightest lower bound (ties: average & strict-if-any, sets.jl:270-281)
            lmax = gl.max()
            tie_l = gl >= lmax - tol
            ml = float(gl[tie_l].mean())
            msl = bool(gsl[tie_l].any())
            umin = gu.min()
            tie_u = gu <= umin + tol
            mu = float(gu[tie_u].mean())
            msu = bool(gsu[tie_u].any())
            newA.append(A[rep])
            newl.append(ml)
            newu.append(mu)
            newsl.append(msl)
            newsu.append(msu)
            rp.append(self.row_parents[rep])
            # provenance labels union across tied bounds (sets.jl:280, 293)
            nll.append(frozenset().union(
                *[self.labels_l[g] for g, t in zip(grp, tie_l) if t]))
            nlu.append(frozenset().union(
                *[self.labels_u[g] for g, t in zip(grp, tie_u) if t]))
        return Poly(np.array(newA), np.array(newl), np.array(newu),
                    np.array(newsl), np.array(newsu), parent=self.parent,
                    row_parents=rp, labels_l=nll, labels_u=nlu,
                    normalize=False)

    def poly_slice(self, x_partial) -> "Poly":
        """Fix coordinates where ``x_partial`` is not NaN (sets.jl:532-548)."""
        x_partial = np.asarray(x_partial, dtype=np.float64)
        keep = np.isnan(x_partial)
        fixed = ~keep
        shift = self.A[:, fixed] @ x_partial[fixed]
        return Poly(self.A[:, keep], self.l - shift, self.u - shift,
                    self.strict_l, self.strict_u, normalize=False)

    def contains(self, x, tol: float = 1e-6) -> bool:
        """Full-dimension membership (sets.jl:850-853 per row).  Partial-x
        membership (an LP) lives in ``setops.contains``."""
        x = np.asarray(x, dtype=np.float64)
        assert x.shape[0] == self.dim
        ax = self.A @ x
        lo = np.where(self.strict_l, self.l - tol < ax, self.l - tol <= ax)
        hi = np.where(self.strict_u, ax - tol < self.u, ax - tol <= self.u)
        return bool(np.all(lo & hi))

    def complement(self) -> "PolyUnion":
        """Union of flipped outer halfspaces, one or two per row
        (sets.jl:918-930): finite lower bound contributes {a'x ⋈ l} with
        complemented strictness; finite upper bound {u ⋈ a'x}."""
        out = []
        for i in range(self.m):
            a = self.A[i]
            if np.isfinite(self.l[i]):
                out.append(Poly(a[None, :], [-np.inf], [self.l[i]],
                                [True], [not self.strict_l[i]], normalize=False))
            if np.isfinite(self.u[i]):
                out.append(Poly(a[None, :], [self.u[i]], [np.inf],
                                [not self.strict_u[i]], [True], normalize=False))
        return PolyUnion(out)

    def translate(self, b) -> "Poly":
        shift = self.A @ np.asarray(b, dtype=np.float64)
        return Poly(self.A, self.l + shift, self.u + shift, self.strict_l,
                    self.strict_u, normalize=False)


def intersect(*polys: Poly) -> Poly:
    """Flattened intersection by row concatenation (sets.jl:936-968)."""
    assert len(polys) > 0
    d = polys[0].dim
    assert all(p.dim == d for p in polys), "dimension mismatch in intersect"
    A = np.concatenate([p.A for p in polys], axis=0)
    l = np.concatenate([p.l for p in polys])
    u = np.concatenate([p.u for p in polys])
    sl = np.concatenate([p.strict_l for p in polys])
    su = np.concatenate([p.strict_u for p in polys])
    rp = [par for p in polys
          for par in (p.row_parents if p.row_parents else [p.parent] * p.m)]
    ll = [lab for p in polys for lab in p.labels_l]
    lu = [lab for p in polys for lab in p.labels_u]
    return Poly(A, l, u, sl, su, row_parents=rp, labels_l=ll, labels_u=lu,
                normalize=False, dedupe=False)


def from_box(lo, hi) -> Poly:
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    n = lo.shape[0]
    return Poly(np.eye(n), lo, hi)


class PolyUnion:
    """Union of polyhedra (sets.jl:858-887)."""

    __slots__ = ("polys",)

    def __init__(self, polys):
        self.polys = list(polys)

    def __len__(self):
        return len(self.polys)

    def __iter__(self):
        return iter(self.polys)

    def __getitem__(self, i):
        if isinstance(i, (list, np.ndarray)):
            return PolyUnion([self.polys[j] for j in np.asarray(i).tolist()])
        return self.polys[i]

    def __repr__(self):
        return f"PolyUnion(len={len(self.polys)})"

    def append(self, p: Poly):
        self.polys.append(p)

    def contains(self, x, tol: float = 1e-6) -> bool:  # sets.jl:910-913
        return any(p.contains(x, tol) for p in self.polys)

    @staticmethod
    def vcat(*pus: "PolyUnion") -> "PolyUnion":
        return PolyUnion([p for pu in pus for p in pu.polys])


def union_intersect(*pus: PolyUnion):
    """Product-intersection of unions — yields one Poly per element of the
    cartesian product (sets.jl:973-975)."""
    import itertools
    for combo in itertools.product(*[pu.polys for pu in pus]):
        yield intersect(*combo)


# -- random generation (sets.jl:316-345) -----------------------------------

def rand_poly(rng: np.random.Generator, dim=None) -> Poly:
    m = int(rng.integers(2, 6))
    n = int(dim) if dim is not None else int(rng.integers(2, 6))
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    l = rng.standard_normal(m)
    u = rng.standard_normal(m)
    sl = rng.random(m) < 0.5
    su = rng.random(m) < 0.5
    bad = u < l
    l[bad] = u[bad]
    sl[bad] = False
    su[bad] = False
    return Poly(A, l, u, sl, su)


def random_polys_of_dim(rng: np.random.Generator, N: int, m: int):
    out = []
    for _ in range(N):
        n = int(rng.integers(2, 5))
        A = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.75)
        l = rng.standard_normal(n)
        u = rng.standard_normal(n)
        sl = rng.random(n) < 0.5
        su = rng.random(n) < 0.5
        bad = u < l
        l[bad] = u[bad] - 2.0
        sl[bad] = False
        su[bad] = False
        out.append(Poly(A, l, u, sl, su))
    return out
