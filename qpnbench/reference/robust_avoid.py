"""Plain NumPy statement of the robust-avoidance certificate ensemble.

The robust_avoid example of the Mathematical Program Networks paper
(arXiv:2404.03767; QuadraticProgramNetworks.jl v0.4.0,
``examples/deprecated/robust_avoid.jl``): an ego trajectory of T steps and
``num_obj`` obstacles, each polytope given by ``num_poly_faces`` faces.  The
network's variables are, in this order and each block column-major, the ego
start xe (2), the obstacle starts xo (2, K), the ego's velocity deltas ue
(2, T), the obstacles' uo (2, T, K), the separating points s (2, T, K) and
the inflations eps (T, K).  The deepest level holds one certificate player
per obstacle k and step t (in that order), an LP

    min eps[t,k]  s.t.  Ae (s - pe) + be + eps >= 0,  Ao_k (s - po) + bo_k + eps >= 0

in its decisions (s[:, t, k], eps[t, k]), where pe = xe + Σ_{τ≤t} ue[:, τ]
and po = xo[:, k] + Σ_{τ≤t} uo[:, τ, k].  Each constraint row is kept in the
package's normal form (a Slice, sets.jl:76-89): entries below 1e-8 dropped,
the row scaled so that its first nonzero coefficient in the variable order
is +1, the inequality turned where that coefficient was negative.  The
scenario ensemble stacks the KKT conditions of all certificate players as
one box AVI ``M z + q ⟂ l ≤ z ≤ u`` in the layout ``z = [x (nd); λ (m);
s (m)]``:

    rows 0..nd        (x free):           -A' λ + c       = 0
    rows nd..nd+m     (λ free):            A x - s + B w  = 0
    rows nd+m..nd+2m  (s in the bounds):   λ

with x the decisions in the variable order, one λ and one s for each row
(players in order, each player's ego faces before its obstacle faces), and
w the other variables at the default start (xe = (-3, 0), xo[:, k] = (2k,
-0.5), all deltas 0).  A scenario shifts xe and each xo by ``shift`` and
adds ``jitter`` to the finite lower bounds that are not equalities.

This module is written from the model's equations and imports nothing of
the program; it is what the benchmark judges the program's answers by.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the network's coefficient cutoff: entries below it are dropped
COEF_TOL = 1e-8


@dataclasses.dataclass
class Problem:
    """One configuration's certificate AVI, before the scenario draw."""
    M: np.ndarray        # (n, n)
    q0: np.ndarray       # (n,) q at the default start positions
    dq: np.ndarray       # (n, p) dq/d(shift): q = q0 + dq @ shift
    l: np.ndarray        # (n,) lower bounds before the jitter
    u: np.ndarray        # (n,)
    jittered: np.ndarray  # (n,) bool: the bounds a scenario jitters
    nd: int
    m: int


def poly_faces(rng, num_faces):
    """A polytope of ``num_faces`` faces around the origin: unit normals at
    evenly spaced angles, jittered and turned at random, and one offset for
    all faces (robust_avoid_simple.jl:22-28)."""
    angles = (np.arange(num_faces) * 2 * np.pi / num_faces
              + 0.15 * rng.standard_normal(num_faces) + np.pi * rng.random())
    A = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    b = 0.2 + 0.8 * rng.random() * np.ones(num_faces)
    return A, b


def normal_form(a: np.ndarray, lo: float, hi: float):
    """A row ``lo <= a·v <= hi`` as a Slice: tiny entries dropped, the first
    nonzero coefficient scaled to +1, the bounds scaled and, where that
    coefficient was negative, swapped and negated."""
    a = np.where(np.abs(a) < COEF_TOL, 0.0, a)
    lead = a[np.flatnonzero(a)[0]]
    a, lo, hi = a / abs(lead), lo / abs(lead), hi / abs(lead)
    if lead < 0:
        a, lo, hi = -a, -hi, -lo
    return a, lo, hi


def problem(config: dict) -> Problem:
    """The certificate AVI of a configuration: the model at its ``T``,
    ``num_obj`` and ``num_poly_faces``, its polytopes drawn from its
    ``model_seed``."""
    T, K = config["T"], config["num_obj"]
    F = config["num_poly_faces"]
    rng = np.random.default_rng(config["model_seed"])
    Ae, be = poly_faces(rng, F)
    obstacles = [poly_faces(rng, F) for _ in range(K)]

    # the network's variables, column-major within each block
    xe = [0, 1]
    xo = {(j, k): 2 + j + 2 * k for j in range(2) for k in range(K)}
    ue = {(j, t): 2 + 2 * K + j + 2 * t for j in range(2) for t in range(T)}
    uo = {(j, t, k): 2 + 2 * K + 2 * T + j + 2 * t + 2 * T * k
          for j in range(2) for t in range(T) for k in range(K)}
    base_s = 2 + 2 * K + 2 * T + 2 * T * K
    sv = {(j, t, k): base_s + j + 2 * t + 2 * T * k
          for j in range(2) for t in range(T) for k in range(K)}
    ev = {(t, k): base_s + 2 * T * K + t + T * k
          for t in range(T) for k in range(K)}
    nv = base_s + 3 * T * K
    start = np.zeros(nv)
    start[xe] = [-3.0, 0.0]
    for k in range(K):
        start[[xo[0, k], xo[1, k]]] = [2.0 * k, -0.5]

    players = [(t, k) for k in range(K) for t in range(T)]
    dec = sorted([sv[j, t, k] for (t, k) in players for j in range(2)]
                 + [ev[t, k] for (t, k) in players])
    params = [v for v in range(nv) if v not in set(dec)]
    col = {v: i for i, v in enumerate(dec)}
    nd = len(dec)
    m = 2 * F * len(players)
    n = nd + 2 * m
    # the shifted parameters lead w: xe, then each xo
    p = 2 * (1 + K)

    M = np.zeros((n, n))
    q0 = np.zeros(n)
    dq = np.zeros((n, p))
    l = np.full(n, -np.inf)
    u = np.full(n, np.inf)
    c = 0                                   # this row's λ and s index
    for (t, k) in players:
        Ao, bo = obstacles[k]
        for A, b, at, moves in (
                (Ae, be, xe, [ue[0, tau] for tau in range(t + 1)]
                 + [ue[1, tau] for tau in range(t + 1)]),
                (Ao, bo, [xo[0, k], xo[1, k]],
                 [uo[0, tau, k] for tau in range(t + 1)]
                 + [uo[1, tau, k] for tau in range(t + 1)])):
            for r in range(F):
                # A[r]·(s - start - Σ deltas) + b[r] + eps >= 0
                a = np.zeros(nv)
                a[[sv[0, t, k], sv[1, t, k]]] = A[r]
                a[at] = -A[r]
                half = len(moves) // 2
                a[moves[:half]] = -A[r, 0]
                a[moves[half:]] = -A[r, 1]
                a[ev[t, k]] = 1.0
                a, lo, hi = normal_form(a, -b[r], np.inf)
                x_cols = [col[v] for v in (sv[0, t, k], sv[1, t, k],
                                           ev[t, k])]
                ax = a[[sv[0, t, k], sv[1, t, k], ev[t, k]]]
                M[x_cols, nd + c] = -ax
                M[nd + c, x_cols] = ax
                M[nd + c, nd + m + c] = -1.0
                q0[nd + c] = a[params] @ start[params]
                dq[nd + c] = a[params[:p]]
                M[nd + m + c, nd + c] = 1.0
                l[nd + m + c], u[nd + m + c] = lo, hi
                c += 1
        q0[col[ev[t, k]]] = 1.0
    jittered = np.isfinite(l) & ~(np.isfinite(u) & (np.abs(u - l) < 1e-12))
    return Problem(M=M, q0=q0, dq=dq, l=l, u=u, jittered=jittered, nd=nd,
                   m=m)


def lanes(prob: Problem, shift: np.ndarray, jitter: np.ndarray):
    """(q, l, u) of every scenario: ``shift`` (..., p), ``jitter`` (..., n)."""
    q = prob.q0 + shift @ prob.dq.T
    l = np.where(prob.jittered, prob.l + jitter, prob.l)
    u = np.broadcast_to(prob.u, l.shape)
    return q, l, u
