"""Rock–paper–scissors with commitment (behavioral port of the deprecated
examples/deprecated/rock_paper_scissors.jl: a 2-player matrix game over
mixed strategies; as a bilevel QPNet the leader commits to a mixed strategy
and the follower best-responds).

Mixed strategies live on the simplex via box + sum constraints; a small
entropy-like quadratic regularizer (ε‖p‖²) keeps each player's QP strictly
convex so the equilibrium is unique and the solution graphs stay small.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register

RPS = np.array([[0.0, -1.0, 1.0],
                [1.0, 0.0, -1.0],
                [-1.0, 1.0, 0.0]])


@register("rock_paper_scissors")
def setup(bilevel: bool = True, reg: float = 0.1, **kwargs):
    p = variables("p", 3)     # row player mixed strategy
    q = variables("q", 3)     # column player mixed strategy
    b = QPNetBuilder(p, q)

    def simplex_constraint(v):
        cons = [v[0], v[1], v[2], v[0] + v[1] + v[2]]
        lb = np.array([0.0, 0.0, 0.0, 1.0])
        ub = np.array([np.inf, np.inf, np.inf, 1.0])
        return b.add_constraint(cons, lb, ub)

    cid_p = simplex_constraint(p)
    cid_q = simplex_constraint(q)

    # row player minimizes  p' A q + reg ||p||^2 ; column maximizes (minimizes -p'Aq + reg||q||^2)
    cost_p = _lift(0.0)
    cost_q = _lift(0.0)
    for i in range(3):
        for j in range(3):
            if RPS[i, j] != 0.0:
                cost_p = cost_p + float(RPS[i, j]) * p[i] * q[j]
                cost_q = cost_q - float(RPS[i, j]) * p[i] * q[j]
    for i in range(3):
        cost_p = cost_p + reg * p[i] * p[i]
        cost_q = cost_q + reg * q[i] * q[i]

    pid_p = b.add_qp(cost_p, [cid_p], p)
    pid_q = b.add_qp(cost_q, [cid_q], q)

    b.add_edges([(pid_p, pid_q)] if bilevel else [])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.full(6, 1.0 / 3.0)
    return b.net
