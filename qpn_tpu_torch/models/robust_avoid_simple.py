"""Robust collision-avoidance example (examples/robust_avoid_simple.jl).

Three-level DAG per obstacle: ego (level 1) → adversary controlling each
obstacle's motion (level 2) → separation-certificate node (level 3) whose QP
computes the signed inflation ϵᵢ certifying polytope separation between the
ego body and obstacle i.

variables := xe(2) xo(2,K) ue(2) uo(2,K) s(2,K) ϵ(K)   (K = num_obj)
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register


def _affine_rows(A, xs, b):
    """Rows of A @ xs + b as Expr list (xs: list of Expr)."""
    out = []
    for r in range(A.shape[0]):
        e = _lift(float(b[r]))
        for c in range(A.shape[1]):
            if A[r, c] != 0.0:
                e = e + float(A[r, c]) * xs[c]
        out.append(e)
    return out


def _poly_faces(rng, num_faces):
    angles = (np.arange(num_faces) * 2 * np.pi / num_faces
              + 0.15 * rng.standard_normal(num_faces) + np.pi * rng.random())
    A = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    # reference parity: the offset is a SINGLE scalar broadcast over all
    # faces (`0.2 .+ 0.8*rand(rng)*ones(num_poly_faces)`,
    # robust_avoid_simple.jl:22-28) — per-face offsets would be a
    # different model
    b = 0.2 + 0.8 * rng.random() * np.ones(num_faces)
    return A, b


@register("robust_avoid_simple")
def setup(num_obj: int = 2, num_poly_faces: int = 5,
          exploration_vertices: int = 10, max_ego_delta: float = 15.0,
          max_obj_delta: float = 1.0, num_projections: int = 5,
          seed: int = 1, **kwargs):
    rng = np.random.default_rng(seed)

    Q = np.array([[0.0, 0.0], [0.0, 0.001]])
    q = np.array([-1.0, 0.0])

    Ae, be = _poly_faces(rng, num_poly_faces)
    Aos, bos = [], []
    for _ in range(num_obj):
        Ao, bo = _poly_faces(rng, num_poly_faces)
        Aos.append(Ao)
        bos.append(bo)

    ue = variables("ue", 2)
    uo = variables("uo", 2, num_obj)
    xe = variables("xe", 2)
    xo = variables("xo", 2, num_obj)
    s = variables("s", 2, num_obj)
    eps = variables("eps", num_obj)

    b = QPNetBuilder(xe, xo, ue, uo, s, eps)
    net = b.net
    net.problem_data.update(Ae=Ae, be=be, Ao=Aos, bo=bos)

    s_players = {}
    for i in range(num_obj):
        cost = eps[i] * 1.0
        # Ae (s_i − (xe+ue)) + be + 1ϵ ≥ 0 ; Ao_i (s_i − (xo_i+uo_i)) + bo_i + 1ϵ ≥ 0
        rel_e = [s[0, i] - (xe[0] + ue[0]), s[1, i] - (xe[1] + ue[1])]
        rel_o = [s[0, i] - (xo[0, i] + uo[0, i]), s[1, i] - (xo[1, i] + uo[1, i])]
        cons = ([r + eps[i] for r in _affine_rows(Ae, rel_e, be)]
                + [r + eps[i] for r in _affine_rows(Aos[i], rel_o, bos[i])])
        lb = np.zeros(len(cons))
        ub = np.full(len(cons), np.inf)
        cid = b.add_constraint(cons, lb, ub)
        s_players[i] = b.add_qp(cost, [cid], s[:, i], eps[i])

    a_players = {}
    for i in range(num_obj):
        cid = b.add_constraint([uo[0, i], uo[1, i]],
                               np.full(2, -max_obj_delta),
                               np.full(2, max_obj_delta))
        a_players[i] = b.add_qp(eps[i] * 1.0, [cid], uo[:, i])

    cons = [ue[0], ue[1]] + [eps[i] for i in range(num_obj)]
    lb = np.concatenate([np.full(2, -max_ego_delta), np.zeros(num_obj)])
    ub = np.concatenate([np.full(2, max_ego_delta), np.full(num_obj, np.inf)])
    ego_cid = b.add_constraint(cons, lb, ub)
    xef = [xe[0] + ue[0], xe[1] + ue[1]]
    cost = _lift(0.0)
    for r in range(2):
        for c in range(2):
            if Q[r, c] != 0.0:
                cost = cost + 0.5 * float(Q[r, c]) * xef[r] * xef[c]
        cost = cost + float(q[r]) * xef[r]
    ego_player = b.add_qp(cost, [ego_cid], ue)

    edge_list = ([(ego_player, a_players[i]) for i in range(num_obj)]
                 + [(a_players[i], s_players[i]) for i in range(num_obj)])
    b.add_edges(edge_list)
    b.assign_constraint_groups()
    b.set_options(exploration_vertices=exploration_vertices,
                  num_projections=num_projections, debug_visualize=False,
                  **kwargs)

    x0e = np.array([-5.0, 0.0])
    x0os = [np.array([3.0 * i, -1.0]) for i in range(num_obj)]
    init = np.concatenate([x0e] + x0os
                          + [np.zeros(2 * (1 + num_obj)), np.zeros(3 * num_obj)])
    net.default_initialization = init

    from .viz import visualize_robust_avoid_simple
    net.visualization_function = (
        lambda x: visualize_robust_avoid_simple(Ae, be, Aos, bos, x))
    return net
