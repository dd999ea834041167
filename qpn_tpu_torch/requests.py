"""Request subsystem: directions a parent wants a child's solution map to
extend toward (avi.jl:479-537), plus the min-norm revision machinery
(avi.jl:539-586).  Copy of ``qpn_tpu/requests.py`` (numpy host code).

Status parity note: the reference wires requests through solve_base's
signature but disables the negotiation state machine with an early return
(requests.jl:22) and defaults ``make_requests=false`` — the flow below is the
live implementation of the same contracts (identify / propagate), consumed by
``comp_indices``'s request-granted labels when ``make_requests`` is enabled.
"""

from __future__ import annotations

from typing import Set

import numpy as np

from .geometry.poly import Poly
from .network import Linear, Quadratic
from .ops import batch_qp
from .ops.avi import GAVI, Status, solve_gavi


def identify_request(S: Poly, lams, parent_request=frozenset(),
                     propagate: bool = False) -> Set[Linear]:
    """Read active duals on child-graph constraint rows and map the
    corresponding directions through the projection parents
    (avi.jl:479-506)."""
    identified: Set[Linear] = set()
    A, l, u, _, _ = S.vectorize()
    m, d = A.shape
    if propagate:
        for req in parent_request:
            a = np.asarray(req.a)
            # a request of dimension exactly d has an EMPTY tail, which is
            # vacuously zero — the reference processes it
            # (iszero(req.a[d+1:end]) is true for an empty slice)
            if a.shape[0] < d or not np.allclose(a[d:], 0.0):
                continue
            for i in range(m):
                if np.allclose(a[:d], A[i], atol=1e-8) and S.has_parent(i):
                    identified |= propagate_request(A[i], S.get_parent(i))
                elif np.allclose(a[:d], -A[i], atol=1e-8) and S.has_parent(i):
                    identified |= propagate_request(-A[i], S.get_parent(i))
    else:
        for i, lam in enumerate(np.asarray(lams)):
            if lam >= 1e-4 and S.has_parent(i):
                identified |= propagate_request(A[i], S.get_parent(i))
            elif lam <= -1e-4 and S.has_parent(i):
                identified |= propagate_request(-A[i], S.get_parent(i))
    return identified


def propagate_request(request, poly: Poly) -> Set[Linear]:
    """Re-express a direction over a projected poly in the parent (pre-
    projection) poly's coordinates via an LP's duals (avi.jl:508-537)."""
    d = poly.dim
    request = np.asarray(request, dtype=np.float64)
    q = np.zeros(d)
    q[: len(request)] = request
    sol = batch_qp.solve_qp_np(np.zeros((d, d)), q, poly.A, poly.l, poly.u)
    out: Set[Linear] = set()
    if sol.status in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
        duals = -np.asarray(sol.y)
        for i, lam in enumerate(duals):
            if lam >= 1e-4:
                out.add(Linear(poly.A[i]))
            elif lam <= -1e-4:
                out.add(Linear(-poly.A[i]))
    else:
        raise RuntimeError(
            "Unable to propagate request to parent poly for some reason.")
    return out


def min_norm_objective(n: int, inds) -> Quadratic:
    """f(z) = ½ Σ_{i∈inds} z_i² (avi.jl:539-546; the reference version has a
    latent bug calling a nonexistent 2-arg Quadratic — fixed here)."""
    Q = np.zeros((n, n))
    for i in inds:
        Q[i, i] = 1.0
    return Quadratic(Q, np.zeros(n), 0.0)


def revise_avi_solution(f: Quadratic, piece: Poly, zr, w):
    """Re-solve a GAVI restricted to one piece, minimizing f (typically the
    ψ min-norm objective) over it (avi.jl:548-586).  Returns the revised z.

    ``piece`` must be in raw GAVI (z, w) column layout — columns [0, nz)
    are z and [nz, nz+nw) are w, exactly what local_piece emits.  (The
    reference's version is dead code referencing an undefined variable;
    this is the repaired behavior it documents.)"""
    zr = np.asarray(zr, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    A, ll, uu, _, _ = piece.vectorize()
    m, n_total = A.shape
    nz, nw = len(zr), len(w)
    if n_total != nz + nw:
        raise ValueError(
            f"revise_avi_solution: piece has {n_total} columns, expected "
            f"nz+nw={nz + nw} (raw (z, w) layout)")
    B = A[:, nz:nz + nw]
    A1 = A[:, :nz]
    gavi = GAVI(
        M=np.hstack([f.Q[:nz, :nz], -A1.T]),
        N=np.zeros((nz, nw)), o=f.q[:nz],
        l1=np.full(nz, -np.inf), u1=np.full(nz, np.inf),
        A=np.hstack([A1, np.zeros((m, m))]), B=B,
        l2=ll, u2=uu)
    z0 = np.concatenate([zr, np.zeros(m)])
    z, status = solve_gavi(gavi, z0, w)
    if status != Status.SUCCESS:
        raise RuntimeError("AVI solve error!")
    return z
