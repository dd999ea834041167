"""Trilevel interpolation-avoid (behavioral port of
``examples/deprecated/interpolation_avoid.jl``).

The reference file is design intent only: it references undefined symbols
(``x̄1``, ``u1``, ``simple_dyn``) and its interpolation constraint
``x2 = p·x_prev + (1−p)·x1`` with variable ``p`` is BILINEAR — not
expressible in the reference's own symbolic frontend either (add_constraint!
rejects nonlinear expressions, programs.jl:147-170).  This port keeps the
documented game structure — continuous-collision certificates along the
ego's swept segment, adversarially aggregated — with the interpolation
sampled at fixed weights α_k (the standard linear relaxation of swept-volume
checking):

* **s-players** (one per timestep × sample; interpolation_avoid.jl:47-54):
  ``min ε`` over ``(σ, ε)`` s.t. ``A_e(σ − x2_k) + b_e + 1ε ≥ 0`` and
  ``A_o σ + b_o + 1ε ≥ 0`` where ``x2_k = α_k x_prev + (1−α_k) x1`` is the
  k-th sample on the swept segment (α_k constant ⇒ linear);
  ε ≤ 0 certifies overlap at that sample.
* **a-player** (per timestep; the adversarial interpolation,
  interpolation_avoid.jl:56-66): ``max c_t`` s.t. ``c_t ≤ ε_{k,t}`` ∀k —
  i.e. ``c_t = min_k ε_{k,t}``, the most-penetrating sample.
* **ego** (interpolation_avoid.jl:69-86): ``min Σ_t −x1₁ₜ`` s.t.
  double-integrator dynamics, ``‖u‖∞ ≤ 5``, and ``c_t ≥ 0``.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register
from .robust_constrained import dyn


@register("interpolation_avoid")
def setup(T: int = 1, num_samples: int = 3, **kwargs):
    Ae = np.array([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
    be = np.ones(4)
    a2 = np.array([np.sqrt(3.0), -2.0])
    a2 /= np.linalg.norm(a2)
    a3 = np.array([-np.sqrt(3.0), -2.0])
    a3 /= np.linalg.norm(a3)
    Ao = np.vstack([[0.0, 1.0], a2, a3])
    bo = 0.3 * np.ones(3)
    alphas = np.linspace(0.0, 1.0, num_samples)

    K = num_samples
    xbar = variables("xbar", 4)
    x1 = variables("x1", 4, T)
    u = variables("u", 2, T)
    s = variables("s", 2, K, T)
    eps = variables("eps", K, T)
    c = variables("c", T)

    b = QPNetBuilder(xbar, x1, u, s, eps, c)

    def sample_pos(k, t, coord):
        """α_k · prev + (1−α_k) · x1_t  (linear: α_k is a constant)."""
        a = float(alphas[k])
        prev = xbar[coord] if t == 0 else x1[coord, t - 1]
        return a * prev + (1.0 - a) * x1[coord, t]

    s_players, a_players = {}, {}
    for t in range(T):
        for k in range(K):
            cons, lb, ub = [], [], []
            for r in range(4):
                cons.append(float(Ae[r, 0]) * (s[0, k, t] - sample_pos(k, t, 0))
                            + float(Ae[r, 1]) * (s[1, k, t] - sample_pos(k, t, 1))
                            + float(be[r]) + eps[k, t])
                lb.append(0.0)
                ub.append(np.inf)
            for r in range(3):
                cons.append(float(Ao[r, 0]) * s[0, k, t]
                            + float(Ao[r, 1]) * s[1, k, t]
                            + float(bo[r]) + eps[k, t])
                lb.append(0.0)
                ub.append(np.inf)
            cid = b.add_constraint(cons, np.array(lb), np.array(ub))
            s_players[(k, t)] = b.add_qp(_lift(0.0) + eps[k, t], [cid],
                                         s[0, k, t], s[1, k, t], eps[k, t])
        # adversarial aggregation: c_t = min_k eps_{k,t}
        cons = [eps[k, t] - c[t] for k in range(K)]
        cid = b.add_constraint(cons, np.zeros(K), np.full(K, np.inf))
        a_players[t] = b.add_qp(_lift(0.0) - c[t], [cid], c[t])

    dyn_cons, ctrl = [], []
    for t in range(T):
        prev = [xbar[kk] for kk in range(4)] if t == 0 \
            else [x1[kk, t - 1] for kk in range(4)]
        step = dyn(prev, [u[0, t], u[1, t]])
        for kk in range(4):
            dyn_cons.append(x1[kk, t] - step[kk])
        ctrl += [u[0, t], u[1, t]]
    ego_cons = dyn_cons + ctrl + [_lift(0.0) + c[t] for t in range(T)]
    lbv = np.concatenate([np.zeros(4 * T), np.full(2 * T, -5.0),
                          np.zeros(T)])
    ubv = np.concatenate([np.zeros(4 * T), np.full(2 * T, 5.0),
                          np.full(T, np.inf)])
    ego_cid = b.add_constraint(ego_cons, lbv, ubv)
    cost = _lift(0.0)
    for t in range(T):
        cost = cost + (-1.0) * x1[0, t]
    ego = b.add_qp(cost, [ego_cid],
                   *([x1[kk, t] for t in range(T) for kk in range(4)]
                     + [u[kk, t] for t in range(T) for kk in range(2)]))

    edges = [(ego, a_players[t]) for t in range(T)]
    edges += [(a_players[t], s_players[(k, t)])
              for t in range(T) for k in range(K)]
    b.add_edges(edges)
    b.assign_constraint_groups()
    b.set_options(**kwargs)

    # dynamics rollout with u=0 (mirrors initialize_interpolation,
    # interpolation_avoid.jl:97-112): the ego starts left of the obstacle
    # and coasts right, so every swept-segment sample starts separated
    init = np.zeros(b.net.num_vars)
    x0 = np.array([-3.0, 0.0, 1.0, 0.0])
    init[:4] = x0
    prev = x0
    for t in range(T):
        prev = np.array(dyn(list(prev), [0.0, 0.0]), dtype=np.float64)
        init[4 + 4 * t:4 + 4 * (t + 1)] = prev
    b.net.default_initialization = init
    b.net.problem_data.update(Ae=Ae, be=be, Ao=Ao, bo=bo, T=T,
                              alphas=alphas)
    return b.net
