"""Symbolic modeling frontend (copy of ``qpn_tpu/frontend.py``; numpy only).

The reference extracts ``A`` / ``Q, q, k`` from user expressions with
Symbolics.jl jacobians (programs.jl:147-201).  Here the same API shape is kept
(``variables``, ``add_constraint``, ``add_qp``) but the extraction engine is a
structural monomial recursion over tiny operator-overloading trees of ``Var``
leaves (``Expr.quad``): exact (k, q, Q) coefficients in one O(tree) pass, no
tracing or probing (an earlier version used ``jax.jacobian``/``jax.hessian``
at zero — correct but it paid a JAX trace per node, dominating model setup).
Non-linear constraints and non-quadratic costs are rejected structurally,
mirroring the reference's errors (programs.jl:154, 179).

Expressions compose with numpy object arrays, so model code reads like the
Julia examples::

    w = variables("w", 2); x = variable("x"); y = variable("y")
    b = QPNetBuilder(w, x, y)
    cid = b.add_constraint([y], [0.0], [np.inf])
    b.add_qp((y - x) ** 2, [cid], y)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .network import QPNet, Quadratic


class NonQuadraticError(ValueError):
    """Raised during structural extraction when a product exceeds degree 2."""


class Expr:
    """Scalar expression node."""

    def eval(self, x, index):  # pragma: no cover - abstract
        raise NotImplementedError

    def quad(self):  # pragma: no cover - abstract
        """Exact structural extraction: (k, q, Q2) with ``q`` a {uid: coeff}
        dict and ``Q2`` a {(uid_i<=uid_j): coeff} dict of monomial
        coefficients — the expression equals
        ``k + Σ q[i]·x_i + Σ Q2[i,j]·x_i·x_j``.  Pure numpy/Python over the
        tiny operator tree: replaces the per-call ``jax.hessian``/
        ``jax.jacobian`` traces (the reference's Symbolics.jl jacobians,
        programs.jl:149, 173-174) with an O(tree) recursion, and is exact
        rather than probe-at-zero."""
        raise NotImplementedError

    # arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return Add(self, _lift(o))

    def __radd__(self, o):
        return Add(_lift(o), self)

    def __sub__(self, o):
        return Add(self, Scale(_lift(o), -1.0))

    def __rsub__(self, o):
        return Add(_lift(o), Scale(self, -1.0))

    def __neg__(self):
        return Scale(self, -1.0)

    def __mul__(self, o):
        if isinstance(o, (int, float, np.floating, np.integer)):
            return Scale(self, float(o))
        return Mul(self, _lift(o))

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if not isinstance(o, (int, float, np.floating, np.integer)):
            raise ValueError("can only divide expressions by scalars")
        return Scale(self, 1.0 / float(o))

    def __pow__(self, p):
        if p == 1:
            return self
        if p != 2:
            raise ValueError(
                f"x**{p} is not quadratic: only squares (and **1) are "
                "supported in quadratic models")
        return Mul(self, self)


class Const(Expr):
    def __init__(self, v):
        self.v = float(v)

    def eval(self, x, index):
        return self.v

    def quad(self):
        return self.v, {}, {}


class Var(Expr):
    _count = 0

    def __init__(self, name: str):
        self.name = name
        self.uid = Var._count
        Var._count += 1

    def eval(self, x, index):
        return x[index[self.uid]]

    def quad(self):
        return 0.0, {self.uid: 1.0}, {}

    def __repr__(self):
        return self.name


class Add(Expr):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def eval(self, x, index):
        return self.a.eval(x, index) + self.b.eval(x, index)

    def quad(self):
        ka, qa, Qa = self.a.quad()
        kb, qb, Qb = self.b.quad()
        q = dict(qa)
        for i, c in qb.items():
            q[i] = q.get(i, 0.0) + c
        Q = dict(Qa)
        for ij, c in Qb.items():
            Q[ij] = Q.get(ij, 0.0) + c
        return ka + kb, q, Q


class Mul(Expr):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def eval(self, x, index):
        return self.a.eval(x, index) * self.b.eval(x, index)

    def quad(self):
        ka, qa, Qa = self.a.quad()
        kb, qb, Qb = self.b.quad()
        # Degree decisions must be value-aware: Add/Scale keep zero-valued
        # entries, so e.g. (x*y - x*y + x) * x is genuinely quadratic even
        # though Qa is non-empty as a dict.  Prune exact zeros first.
        qa = {i: c for i, c in qa.items() if c != 0.0}
        Qa = {ij: c for ij, c in Qa.items() if c != 0.0}
        qb = {i: c for i, c in qb.items() if c != 0.0}
        Qb = {ij: c for ij, c in Qb.items() if c != 0.0}
        # constant factors scale the other side (degree 0 * degree <=2)
        if not qa and not Qa:
            return ka * kb, {i: ka * c for i, c in qb.items()}, \
                {ij: ka * c for ij, c in Qb.items()}
        if not qb and not Qb:
            return ka * kb, {i: kb * c for i, c in qa.items()}, \
                {ij: kb * c for ij, c in Qa.items()}
        if Qa or Qb:
            raise NonQuadraticError(
                "product of a quadratic term with a non-constant term "
                "exceeds degree 2")
        # affine * affine
        k = ka * kb
        q = {i: kb * c for i, c in qa.items()}
        for i, c in qb.items():
            q[i] = q.get(i, 0.0) + ka * c
        Q = {}
        for i, ca in qa.items():
            for j, cb in qb.items():
                ij = (i, j) if i <= j else (j, i)
                Q[ij] = Q.get(ij, 0.0) + ca * cb
        return k, q, Q


class Scale(Expr):
    def __init__(self, a, c):
        self.a, self.c = a, float(c)

    def eval(self, x, index):
        return self.c * self.a.eval(x, index)

    def quad(self):
        k, q, Q = self.a.quad()
        return self.c * k, {i: self.c * c for i, c in q.items()}, \
            {ij: self.c * c for ij, c in Q.items()}


def _lift(v):
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, np.floating, np.integer)):
        return Const(v)
    raise TypeError(f"cannot lift {type(v)} into an expression")


def variable(name: str) -> Var:
    return Var(name)


def variables(name: str, *dims) -> np.ndarray:
    """Array of Vars, e.g. variables('x', 2) or variables('uo', 2, 3)
    (programs.jl:143-144).  Dims are sizes (ints) or ranges — a Python
    ``range`` contributes ``len(range)`` entries."""
    dims = tuple(len(d) if isinstance(d, range) else int(d) for d in dims)
    out = np.empty(dims, dtype=object)
    for idx in np.ndindex(*dims):
        suffix = "_".join(str(i + 1) for i in idx)
        out[idx] = Var(f"{name}{suffix}")
    return out


def _flatten_vars(sym_vars) -> List[Var]:
    flat: List[Var] = []
    for sv in sym_vars:
        if isinstance(sv, Var):
            flat.append(sv)
        else:
            arr = np.asarray(sv, dtype=object)
            # Julia (column-major) enumeration order for multi-dim blocks
            flat.extend(arr.flatten(order="F").tolist())
    return flat


class QPNetBuilder:
    """Mirror of ``QPNet(sym_vars...)`` + the symbolic add_* API
    (programs.jl:94-116, 147-201)."""

    def __init__(self, *sym_vars):
        self.vars = _flatten_vars(sym_vars)
        self.index: Dict[int, int] = {v.uid: i for i, v in enumerate(self.vars)}
        self.net = QPNet(len(self.vars), [v.name for v in self.vars])

    @property
    def num_vars(self):
        return len(self.vars)

    def add_constraint(self, cons, lb, ub, tol: float = 1e-8) -> int:
        """programs.jl:147-170: extract sparse A and constant offset; the
        bounds are shifted by the constant term."""
        cons = list(np.asarray(cons, dtype=object).flatten(order="F")) \
            if not isinstance(cons, (list, tuple)) else list(cons)
        lb = np.atleast_1d(np.asarray(lb, dtype=np.float64))
        ub = np.atleast_1d(np.asarray(ub, dtype=np.float64))
        if not (len(cons) == len(lb) == len(ub)):
            raise ValueError(
                f"add_constraint: {len(cons)} expressions but "
                f"{len(lb)} lower / {len(ub)} upper bounds")
        m, n = len(cons), self.num_vars
        A = np.zeros((m, n))
        vals = np.zeros(m)
        for r, e in enumerate(cons):
            try:
                k, q, Q2 = _lift(e).quad()
            except NonQuadraticError:
                raise ValueError("Detected non-linear constraint!") from None
            if any(abs(c) >= tol for c in Q2.values()):
                raise ValueError("Detected non-linear constraint!")
            vals[r] = k
            for uid, c in q.items():
                A[r, self.index[uid]] = c
        A[np.abs(A) < tol] = 0.0
        return self.net.add_constraint(A, lb - vals, ub - vals)

    def add_qp(self, cost: Expr, con_inds, *private_vars, tol: float = 1e-8) -> int:
        """programs.jl:172-201: Q = hessian, q = grad at 0, k = cost(0) —
        read off the structural monomial extraction (exact)."""
        try:
            k, qd, Q2 = _lift(cost).quad()
        except NonQuadraticError:
            raise ValueError("Detected non-quadratic cost!") from None
        n = self.num_vars
        Q = np.zeros((n, n))
        q = np.zeros(n)
        for uid, c in qd.items():
            q[self.index[uid]] = c
        # monomial c·x_i·x_j → symmetric ½ x'Qx entries
        for (ui, uj), c in Q2.items():
            i, j = self.index[ui], self.index[uj]
            if i == j:
                Q[i, i] += 2.0 * c
            else:
                Q[i, j] += c
                Q[j, i] += c
        Q[np.abs(Q) < tol] = 0.0
        var_inds = [self.index[v.uid] for v in _flatten_vars(private_vars)]
        return self.net.add_qp(Quadratic(Q, q, float(k)), list(con_inds),
                               var_inds)

    # passthroughs ---------------------------------------------------------
    def add_edges(self, edge_list):
        self.net.add_edges(edge_list)

    def assign_constraint_groups(self, group_map=None):
        self.net.assign_constraint_groups(group_map)

    def set_options(self, **kw):
        self.net.set_options(**kw)


def dot(a, b):
    """Inner product helper for object arrays of Exprs / floats."""
    a = np.asarray(a, dtype=object).ravel(order="F")
    b = np.asarray(b, dtype=object).ravel(order="F")
    assert a.shape == b.shape
    out = _lift(0.0)
    for ai, bi in zip(a, b):
        out = out + _lift(ai) * _lift(bi)
    return out


def sqnorm(a):
    return dot(a, a)
