"""Behavioral ports of three small deprecated reference examples.

* ``bilevel_escape`` (examples/deprecated/bilevel_escape.jl): leader
  min y₁−x₁ with x in the radius-2 diamond; follower projects x onto the
  unit diamond (min ½‖y−x‖²).  Analytic equilibrium: x = (2, 0), y = (1, 0)
  (the leader pushes x to the far corner; the follower projects to the
  near corner).
* ``simple_network`` (examples/deprecated/simple_network.jl): three scalar
  players f₁=(x₁)²+(x₂−1)², f₂=(x₂+1)², f₃=x₃² with constraint
  x₂−x₁−x₃ ≥ 0 owned by player 3 (dec {x₂,x₃}); three DAG variants over
  them (``edge_version`` ∈ {1,2,3}, simple_network.jl:30-33).
* ``repeated_variable_control``
  (examples/deprecated/repeated_variable_control.jl): the shared-variable
  reformulation of a constrained QP —
  bottom player min ½s² over (x, s) s.t. (Ax−l)+s ≥ 0, (u−Ax)+s ≥ 0
  (minimal relaxation: s = 0 and l ≤ Ax ≤ u whenever feasible);
  top player min ½x'Qx + q'x with NO private variables (it optimizes
  entirely through the child's solution map — the repeated-variable axis).
  Equilibrium = the solution of min ½x'Qx+q'x s.t. l ≤ Ax ≤ u.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variable, variables, _lift
from . import register


@register("bilevel_escape")
def setup_bilevel_escape(**kwargs):
    x = variables("x", 2)
    y = variables("y", 2)
    b = QPNetBuilder(x, y)

    cid1 = b.add_constraint([y[0] + y[1], y[0] - y[1]],
                            np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
    cid2 = b.add_constraint([x[0] + x[1], x[0] - x[1]],
                            np.array([-2.0, -2.0]), np.array([2.0, 2.0]))

    cost_f = (0.5 * (y[0] - x[0]) * (y[0] - x[0])
              + 0.5 * (y[1] - x[1]) * (y[1] - x[1]))
    follower = b.add_qp(cost_f, [cid1], y[0], y[1])

    cost_l = _lift(0.0) + y[0] - x[0]
    leader = b.add_qp(cost_l, [cid2], x[0], x[1])

    b.add_edges([(leader, follower)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(4)
    return b.net


@register("simple_network")
def setup_simple_network(edge_version: int = 1, **kwargs):
    x = variables("x", 3)
    b = QPNetBuilder(x)

    cid = b.add_constraint([x[1] - x[0] - x[2]],
                           np.array([0.0]), np.array([np.inf]))

    p1 = b.add_qp(x[0] * x[0] + (x[1] - 1.0) * (x[1] - 1.0), [], x[0])
    p2 = b.add_qp((x[1] + 1.0) * (x[1] + 1.0), [], x[1])
    p3 = b.add_qp(x[2] * x[2], [cid], x[1], x[2])

    versions = {1: [(p2, p3)],
                2: [(p1, p3), (p2, p3)],
                3: [(p1, p2), (p2, p3)]}
    b.add_edges(versions[int(edge_version)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(3)
    return b.net


@register("repeated_variable_control")
def setup_repeated_variable_control(n: int = 3, m: int = 2, seed: int = 1,
                                    **kwargs):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.6)
    Q = G.T @ G + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.6)
    A[np.all(A == 0.0, axis=1), 0] = 1.0      # no empty rows
    l = np.full(m, -1.0)
    u = np.full(m, 1.0)

    x = variables("x", n)
    s = variable("s")
    b = QPNetBuilder(x, s)

    cons, lb, ub = [], [], []
    for i in range(m):
        row = _lift(0.0)
        for j in range(n):
            if A[i, j]:
                row = row + float(A[i, j]) * x[j]
        cons.append(row - float(l[i]) + s)
        lb.append(0.0)
        ub.append(np.inf)
        cons.append(float(u[i]) - row + s)
        lb.append(0.0)
        ub.append(np.inf)
    cid = b.add_constraint(cons, np.array(lb), np.array(ub))

    child = b.add_qp(0.5 * s * s, [cid], *(list(x) + [s]))

    cost_top = _lift(0.0)
    for i in range(n):
        for j in range(n):
            if Q[i, j]:
                cost_top = cost_top + 0.5 * float(Q[i, j]) * x[i] * x[j]
        cost_top = cost_top + float(q[i]) * x[i]
    top = b.add_qp(cost_top, [])              # NO private variables

    b.add_edges([(top, child)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(n + 1)
    b.net.problem_data.update(Q=Q, q=q, A=A, l=l, u=u)
    return b.net
