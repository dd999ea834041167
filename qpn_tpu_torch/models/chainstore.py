"""Chain-store entry game (behavioral port of the deprecated
examples/deprecated/chainstore.jl: a 10-town sequential game).

An incumbent chain faces potential entrants in N towns, sequentially: in town
t the entrant chooses entry intensity e_t ∈ [0, 1]; the incumbent then sets a
fight/accommodate response r_t ∈ [0, 1].  Costs are quadratic: entrants trade
entry profit against the incumbent's response; the incumbent trades lost
margin against deterrence that propagates to LATER towns (the chain-store
paradox structure).  The DAG is a 2N-level chain: e_1 → r_1 → e_2 → r_2 → …
— exercising deep level recursion with solution graphs at every layer.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables
from . import register


@register("chainstore")
def setup(num_towns: int = 3, deterrence: float = 0.5, margin: float = 1.0,
          fight_cost: float = 0.4, entry_cost: float = 0.2, **kwargs):
    e = variables("e", num_towns)
    r = variables("r", num_towns)
    b = QPNetBuilder(e, r)

    pids = []
    for t in range(num_towns):
        # entrant t: profit from entry minus response damage
        cid_e = b.add_constraint([e[t]], [0.0], [1.0])
        cost_e = (entry_cost - margin) * e[t] + 0.5 * e[t] * e[t] \
            + 1.0 * e[t] * r[t]
        pid_e = b.add_qp(cost_e, [cid_e], e[t])
        # incumbent response in town t: fighting costs now (fight_cost·r +
        # ½r²), entry costs margin, and fighting deters the NEXT entrant
        # (cross term with e_{t+1})
        cid_r = b.add_constraint([r[t]], [0.0], [1.0])
        cost_r = fight_cost * r[t] + 0.5 * r[t] * r[t] + margin * e[t]
        if t + 1 < num_towns:
            cost_r = cost_r + (-deterrence) * r[t] * e[t + 1]
        pid_r = b.add_qp(cost_r, [cid_r], r[t])
        pids.append((pid_e, pid_r))

    # chain: e_t → r_t → e_{t+1}
    edges = []
    for t in range(num_towns):
        edges.append((pids[t][0], pids[t][1]))
        if t + 1 < num_towns:
            edges.append((pids[t][1], pids[t + 1][0]))
    b.add_edges(edges)
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(2 * num_towns)
    return b.net
