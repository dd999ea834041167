"""Bilevel obstacle-avoidance MPC (behavioral port of
``examples/deprecated/control_avoid.jl``).

Two levels: the vehicle's planner above per-(timestep × obstacle)
certificate players.

* **s-players** (control_avoid.jl:81-100): ``min s[i,t]`` s.t.
  ``h[j,i,t] = a_j'x_t − b_j`` and ``s ≥ h`` — the least-violated halfspace
  of the polygonal obstacle (avoidance ⟺ s ≥ 0), identical structure to
  robust_constrained's certificates.
* **u-player** (control_avoid.jl:123-162): ``min Σ_t (−10·x₁ₜ + x₂ₜ²)``
  over (x̄, x, u) s.t. double-integrator dynamics, ``‖u‖∞ ≤ max_accel``,
  pinned initial state, and the avoidance certificates ``s[i,t] ≥ 0``
  (which bind through the children's solution maps).

Obstacle centers ``o`` are unowned (fixed at their initialization) —
the reference declares them as leading free variables, control_avoid.jl:49.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register
from .robust_constrained import dyn


@register("control_avoid")
def setup(T: int = 2, num_obj: int = 1, num_obj_faces: int = 4,
          obstacle_spacing: float = 1.0, lane_heading: float = 0.0,
          initial_speed: float = 3.0, lane_width: float = 10.0,
          initial_box_length: float = 6.0, max_accel: float = 10.0,
          **kwargs):
    lane_vec = np.array([np.cos(lane_heading), np.sin(lane_heading)])
    right_normal = np.array([-np.sin(lane_heading), np.cos(lane_heading)])
    R = np.column_stack([lane_vec, right_normal])
    Rinv = np.linalg.inv(R)

    o = variables("o", 2, num_obj)
    xbar = variables("xbar", 4)
    x = variables("x", 4, T)
    u = variables("u", 2, T)
    h = variables("h", num_obj_faces, num_obj, T)
    s = variables("s", num_obj, T)

    b = QPNetBuilder(o, xbar, x, u, h, s)

    def face(i, j, t):
        th1 = (j + 1) * 2 * np.pi / num_obj_faces
        th2 = (j + 2) * 2 * np.pi / num_obj_faces
        v1 = np.array([np.cos(th1), np.sin(th1)])
        v2 = np.array([np.cos(th2), np.sin(th2)])
        d = v2 - v1
        a = np.array([d[1], -d[0]])
        return (a[0] * (x[0, t] - o[0, i]) + a[1] * (x[1, t] - o[1, i])
                - float(a @ v1))

    s_players = []
    for t in range(T):
        for i in range(num_obj):
            cons, lb, ub = [], [], []
            for j in range(num_obj_faces):
                cons.append(h[j, i, t] - face(i, j, t))
                lb.append(0.0)
                ub.append(0.0)
                cons.append(s[i, t] - h[j, i, t])
                lb.append(0.0)
                ub.append(np.inf)
            cid = b.add_constraint(cons, np.array(lb), np.array(ub))
            pvars = [s[i, t]] + [h[j, i, t] for j in range(num_obj_faces)]
            s_players.append(b.add_qp(_lift(0.0) + s[i, t], [cid], *pvars))

    dyn_cons = []
    for t in range(T):
        prev = [xbar[k] for k in range(4)] if t == 0 \
            else [x[k, t - 1] for k in range(4)]
        step = dyn(prev, [u[0, t], u[1, t]])
        for k in range(4):
            dyn_cons.append(x[k, t] - step[k])
    dyn_cid = b.add_constraint(dyn_cons, np.zeros(4 * T), np.zeros(4 * T))

    u_cons = [u[k, t] for t in range(T) for k in range(2)]
    ctrl_cid = b.add_constraint(u_cons, np.full(2 * T, -max_accel),
                                np.full(2 * T, max_accel))

    # reference parity: velocity components are pinned RAW (world
    # frame) while positions go through Rinv -- the reference does
    # the same (R\\x_bar[1:2] then x_bar[3:4],
    # robust_constrained.jl:214-222), so nonzero lane_heading
    # carries the same latent quirk there
    init_cons = [Rinv[0, 0] * xbar[0] + Rinv[0, 1] * xbar[1],
                 Rinv[1, 0] * xbar[0] + Rinv[1, 1] * xbar[1],
                 xbar[2], xbar[3]]
    init_cid = b.add_constraint(init_cons,
                                np.array([0.0, 0.0, initial_speed, 0.0]),
                                np.array([0.0, 0.0, initial_speed, 0.0]))

    avoid_cons = [s[i, t] for i in range(num_obj) for t in range(T)]
    s_cid = b.add_constraint(avoid_cons, np.zeros(num_obj * T),
                             np.full(num_obj * T, np.inf))

    cost = _lift(0.0)
    for t in range(T):
        cost = cost + (-10.0) * x[0, t] + x[1, t] * x[1, t]
    uvars = ([xbar[k] for k in range(4)]
             + [x[k, t] for t in range(T) for k in range(4)]
             + [u[k, t] for t in range(T) for k in range(2)])
    u_player = b.add_qp(cost, [dyn_cid, ctrl_cid, init_cid, s_cid], *uvars)

    b.add_edges([(u_player, sp) for sp in s_players])
    b.assign_constraint_groups()
    b.set_options(**kwargs)

    dist_along = (np.arange(1, num_obj + 1) * obstacle_spacing
                  + initial_box_length / 2)
    offsets = np.array([(-1) ** (i + 1) for i in range(num_obj)]) \
        * lane_width / 5.0
    init = np.zeros(b.net.num_vars)
    for i in range(num_obj):
        c = R @ np.array([dist_along[i], offsets[i]])
        init[2 * i:2 * i + 2] = c          # obstacle centers (unowned)
    init[2 * num_obj + 2] = initial_speed  # xbar velocity
    b.net.default_initialization = init
    b.net.problem_data.update(T=T, num_obj=num_obj, max_accel=max_accel)
    return b.net
