"""Constraint-coupled adversarial reachability (behavioral port of
``examples/deprecated/robust_constrained.jl``).

A single-level Nash game (the reference adds NO edges — its edge section is
commented out, robust_constrained.jl:285-291) whose players are coupled
purely through shared constraint rows:

* **s-players** (one per timestep × obstacle, robust_constrained.jl:154-174):
  ``min s[i,t]`` s.t. ``h[j,i,t] = a_j'x_t − b_j`` (equalities defining the
  halfspace clearances of a regular ``num_obj_faces``-gon around obstacle i)
  and ``s[i,t] ≥ h[j,i,t]`` — so ``s = max_j h_j``, the least-violated
  halfspace certificate (avoidance ⟺ s ≥ 0).
* **c-player** (robust_constrained.jl:180-193): ``max c`` s.t.
  ``c ≤ s[i,t]`` ∀(i,t) — the most-violated certificate over the horizon.
* **v-player** (robust_constrained.jl:200-239): ``min ½v²`` s.t. the
  double-integrator dynamics equalities ``x_t = dyn(x_{t−1}, u_t)``
  (Δ = 0.1, robust_constrained.jl:22-25), pinned initial state, obstacle
  centers boxed laterally, and ``v ≥ c`` — the adversary drawing the
  trajectory toward the boundary of infeasibility.
* **u-player** (robust_constrained.jl:262-282):
  ``min Σ_t (u₁ₜ−15)² + u₂ₜ²`` s.t. ``‖u‖∞ ≤ max_accel``.

Analytic equilibrium facts used by the tests: u₁ₜ = min(15, max_accel),
u₂ₜ = 0 (the u-player is uncoupled in cost); s = max_j h_j; c = min_{i,t} s;
v = max(0, c).
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variable, variables, _lift
from . import register


def dyn(xt, ut, delta: float = 0.1):
    """Double-integrator step (robust_constrained.jl:22-25), symbolic-ok."""
    return [xt[0] + delta * (xt[2] + 0.5 * delta * ut[0]),
            xt[1] + delta * (xt[3] + 0.5 * delta * ut[1]),
            xt[2] + delta * ut[0],
            xt[3] + delta * ut[1]]


@register("robust_constrained")
def setup(T: int = 3, num_obj: int = 1, num_obj_faces: int = 4,
          obstacle_spacing: float = 1.0, lane_heading: float = 0.0,
          initial_speed: float = 3.0, lane_width: float = 10.0,
          initial_box_length: float = 6.0, max_accel: float = 10.0,
          **kwargs):
    lane_vec = np.array([np.cos(lane_heading), np.sin(lane_heading)])
    right_normal = np.array([-np.sin(lane_heading), np.cos(lane_heading)])
    R = np.column_stack([lane_vec, right_normal])
    Rinv = np.linalg.inv(R)

    xbar = variables("xbar", 4)
    x = variables("x", 4, T)
    u = variables("u", 2, T)
    h = variables("h", num_obj_faces, num_obj, T)
    s = variables("s", num_obj, T)
    o = variables("o", 2, num_obj)
    c = variable("c")
    v = variable("v")
    w = variable("w")                      # vestigial, kept for layout parity

    b = QPNetBuilder(xbar, x, u, h, s, o, c, v, w)

    # face halfspaces of the regular polygon around obstacle i: the edge from
    # vertex j to j+1 has outward normal (d2, -d1) (clockwise convention,
    # robust_constrained.jl:11-20); vertices o_i + (cosθ_j, sinθ_j)
    def face(i, j, t):
        th1 = (j + 1) * 2 * np.pi / num_obj_faces
        th2 = (j + 2) * 2 * np.pi / num_obj_faces
        v1 = np.array([np.cos(th1), np.sin(th1)])
        v2 = np.array([np.cos(th2), np.sin(th2)])
        d = v2 - v1
        a = np.array([d[1], -d[0]])
        # halfspace value a'(p − o_i) − a'v1:  h = a'x_t − b with b depending
        # on the (variable) obstacle center — expressed symbolically
        expr = (a[0] * (x[0, t] - o[0, i]) + a[1] * (x[1, t] - o[1, i])
                - float(a @ v1))
        return expr

    # ---- s-players -------------------------------------------------------
    s_players = {}
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
            s_players[(t, i)] = b.add_qp(_lift(0.0) + s[i, t], [cid], *pvars)

    # ---- c-player --------------------------------------------------------
    min_cons = [s[i, t] - c for t in range(T) for i in range(num_obj)]
    cid = b.add_constraint(min_cons, np.zeros(len(min_cons)),
                           np.full(len(min_cons), np.inf))
    c_player = b.add_qp(_lift(0.0) - c, [cid], c)

    # ---- v-player --------------------------------------------------------
    dyn_cons = []
    for t in range(T):
        prev = [xbar[k] for k in range(4)] if t == 0 \
            else [x[k, t - 1] for k in range(4)]
        step = dyn(prev, [u[0, t], u[1, t]])
        for k in range(4):
            dyn_cons.append(x[k, t] - step[k])
    dyn_cid = b.add_constraint(dyn_cons, np.zeros(4 * T), np.zeros(4 * T))

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

    dist_along = (np.arange(1, num_obj + 1) * obstacle_spacing
                  + initial_box_length / 2)
    offsets = np.array([(-1) ** (i + 1) for i in range(num_obj)]) \
        * lane_width / 5.0
    obs_cons, obs_lb, obs_ub = [], [], []
    for i in range(num_obj):
        obs_cons.append(Rinv[0, 0] * o[0, i] + Rinv[0, 1] * o[1, i])
        obs_cons.append(Rinv[1, 0] * o[0, i] + Rinv[1, 1] * o[1, i])
        obs_lb += [dist_along[i], offsets[i] - lane_width / 5]
        obs_ub += [dist_along[i], offsets[i] + lane_width / 5]
    obs_cid = b.add_constraint(obs_cons, np.array(obs_lb), np.array(obs_ub))

    v_cid = b.add_constraint([v - c], np.zeros(1), np.full(1, np.inf))
    vvars = ([xbar[k] for k in range(4)]
             + [x[k, t] for t in range(T) for k in range(4)]
             + [o[k, i] for i in range(num_obj) for k in range(2)] + [v])
    v_player = b.add_qp(0.5 * v * v, [dyn_cid, init_cid, obs_cid, v_cid],
                        *vvars)

    # ---- u-player --------------------------------------------------------
    u_cons = [u[k, t] for t in range(T) for k in range(2)]
    u_cid = b.add_constraint(u_cons, np.full(2 * T, -max_accel),
                             np.full(2 * T, max_accel))
    cost_u = _lift(0.0)
    for t in range(T):
        cost_u = cost_u + (u[0, t] - 15.0) * (u[0, t] - 15.0) \
            + u[1, t] * u[1, t]
    u_player = b.add_qp(cost_u, [u_cid],
                        *[u[k, t] for t in range(T) for k in range(2)])

    # no edges: one-level Nash (the reference's edge section is commented
    # out, robust_constrained.jl:285-291)
    b.add_edges([])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    n = b.net.num_vars
    init = np.zeros(n)
    b.net.default_initialization = init
    b.net.problem_data.update(T=T, num_obj=num_obj,
                              num_obj_faces=num_obj_faces,
                              max_accel=max_accel)
    return b.net
