"""Two-node bilevel example (examples/simple_bilevel.jl).

variables := w1 w2 x y
f1 (follower): (y − x)²  s.t. y ≥ 0          — private var y
f2 (leader):   ‖[x; y] − w‖²                 — private var x, child: node 1
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variable, variables, dot
from . import register


@register("simple_bilevel")
def setup(**kwargs):
    w = variables("w", 2)
    x = variable("x")
    y = variable("y")

    b = QPNetBuilder(w, x, y)

    con_id = b.add_constraint([y], [0.0], [np.inf])

    cost1 = (y - x) ** 2
    qp1 = b.add_qp(cost1, [con_id], y)

    d = np.array([x - w[0], y - w[1]], dtype=object)
    cost2 = dot(d, d)
    qp2 = b.add_qp(cost2, [], x)

    b.add_edges([(qp2, qp1)])
    b.assign_constraint_groups()
    b.set_options(debug_visualize=False, **kwargs)
    b.net.default_initialization = np.zeros(4)

    from .viz import visualize_simple_bilevel
    b.net.visualization_function = visualize_simple_bilevel
    return b.net
