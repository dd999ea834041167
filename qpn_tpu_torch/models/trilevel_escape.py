"""Trilevel pursuit/escape (behavioral port of the deprecated
examples/deprecated/trilevel_escape.jl idea): evader → pursuer → predictor.

A predictor (deepest) estimates the evader's position under box limits; the
pursuer moves toward the prediction; the evader (top) moves to maximize
distance from the pursuer while staying in an arena box.  Three strict
Stackelberg levels with quadratic couplings.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, dot
from . import register


@register("trilevel_escape")
def setup(arena: float = 3.0, pursuit_gain: float = 1.0,
          predict_reg: float = 0.5, **kwargs):
    ev = variables("ev", 2)       # evader position
    pu = variables("pu", 2)       # pursuer position
    pr = variables("pr", 2)       # predictor estimate
    b = QPNetBuilder(ev, pu, pr)

    # predictor (level 3): track the evader with regularization, box-limited
    cid_pr = b.add_constraint([pr[0], pr[1]],
                              np.full(2, -arena), np.full(2, arena))
    d_pr = [pr[0] - ev[0], pr[1] - ev[1]]
    cost_pr = dot(d_pr, d_pr) + predict_reg * dot(pr, pr)
    pid_pr = b.add_qp(cost_pr, [cid_pr], pr)

    # pursuer (level 2): move toward the prediction
    cid_pu = b.add_constraint([pu[0], pu[1]],
                              np.full(2, -arena), np.full(2, arena))
    d_pu = [pu[0] - pr[0], pu[1] - pr[1]]
    cost_pu = dot(d_pu, d_pu)
    pid_pu = b.add_qp(cost_pu, [cid_pu], pu)

    # evader (level 1): maximize distance to the pursuer (bounded by arena box
    # + a mild centering term so the QP stays convex)
    cid_ev = b.add_constraint([ev[0], ev[1]],
                              np.full(2, -arena), np.full(2, arena))
    # evader Hessian = (4 − 2·pursuit_gain)·I: convex ONLY for
    # pursuit_gain < 2 — the frontend rejects non-quadratic costs but not
    # indefinite ones, so validate here rather than solve a silent
    # maximization as a min-QP
    if pursuit_gain >= 2.0:
        raise ValueError(
            f"pursuit_gain={pursuit_gain} makes the evader QP non-convex "
            "(requires pursuit_gain < 2)")
    d_ev = [ev[0] - pu[0], ev[1] - pu[1]]
    cost_ev = (-pursuit_gain) * dot(d_ev, d_ev) + 2.0 * dot(ev, ev)
    pid_ev = b.add_qp(cost_ev, [cid_ev], ev)

    b.add_edges([(pid_ev, pid_pu), (pid_pu, pid_pr)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    init = np.zeros(6)
    init[:2] = [1.0, 0.5]
    b.net.default_initialization = init
    return b.net
