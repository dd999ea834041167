"""Bilevel toll setting (behavioral port of the deprecated
examples/deprecated/repeated_toll_setting.jl idea): an authority sets tolls
on parallel routes; commuters split flow to minimize congestion + toll cost;
the authority maximizes revenue minus congestion externality.

Leader: toll vector τ ∈ [0, τ_max]^R.
Follower: flow split f on the simplex, cost Σ_r f_r(a_r f_r + b_r + τ_r).
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register


@register("toll_setting")
def setup(num_routes: int = 3, tau_max: float = 2.0, demand: float = 1.0,
          seed: int = 0, revenue_weight: float = 1.0, **kwargs):
    rng = np.random.default_rng(seed)
    a = 0.5 + rng.random(num_routes)          # congestion slopes
    bb = rng.random(num_routes)               # free-flow costs

    tau = variables("tau", num_routes)
    f = variables("f", num_routes)
    b = QPNetBuilder(tau, f)

    # follower: flow on the demand simplex
    cons_f = [f[r] for r in range(num_routes)]
    cons_f.append(sum(f[r] for r in range(1, num_routes)) + f[0])
    lb = np.concatenate([np.zeros(num_routes), [demand]])
    ub = np.concatenate([np.full(num_routes, np.inf), [demand]])
    cid_f = b.add_constraint(cons_f, lb, ub)
    cost_f = _lift(0.0)
    for r in range(num_routes):
        cost_f = cost_f + float(a[r]) * f[r] * f[r] \
            + float(bb[r]) * f[r] + tau[r] * f[r]
    follower = b.add_qp(cost_f, [cid_f], f)

    # leader: tolls in a box; maximize revenue  Σ τ_r f_r  minus a quadratic
    # toll-variance regularizer (keeps the leader QP convex in τ)
    cid_t = b.add_constraint([tau[r] for r in range(num_routes)],
                             np.zeros(num_routes),
                             np.full(num_routes, tau_max))
    cost_l = _lift(0.0)
    for r in range(num_routes):
        cost_l = cost_l + (-revenue_weight) * tau[r] * f[r] \
            + 0.05 * tau[r] * tau[r]
    leader = b.add_qp(cost_l, [cid_t], tau)

    b.add_edges([(leader, follower)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    init = np.zeros(2 * num_routes)
    init[num_routes:] = demand / num_routes
    b.net.default_initialization = init
    b.net.problem_data.update(a=a, b=bb)
    return b.net
