"""The system's side of a robust_avoid configuration: the model built and
its certificate AVI assembled by the program (``qpn_tpu_torch``), as
``models.robust_avoid.scenario_batch_gavis`` does it, with the scenario draw
left to the benchmark's traffic.

``scenario_batch_gavis`` builds the model, the labeled GAVIs of the deepest
level's players, their combination and the box AVI, and drops the ξ block;
then it draws the scenarios from the same seed as the model, and returns
(M, q, l, u) alone.  The benchmark keeps the model at the configuration's
seed and draws scenarios from other seeds (the check ensembles come from the
run's seed), which needs ``q = N w + o`` of any draw, so it repeats the
assembly here (the elimination of ξ is copied; everything else is the
program's own functions).  At the model's seed its lanes equal that
function's to the bit (``tests/test_qpnbench_traffic.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Assembled:
    """The program's certificate AVI of one configuration."""
    M: np.ndarray        # (n, n)
    N: np.ndarray        # (n, params)
    o: np.ndarray        # (n,)
    l: np.ndarray        # (n,)
    u: np.ndarray        # (n,)
    w0: np.ndarray       # (params,) the parameters at the default start
    shifted: int         # the leading parameters a scenario shifts
    structure: dict


def assemble(config: dict) -> Assembled:
    from qpn_tpu_torch.algorithm import (combine_gavis,
                                         create_labeled_gavi_from_qp)
    from qpn_tpu_torch.models.robust_avoid import setup
    from qpn_tpu_torch.ops.avi import convert_gavi

    T, num_obj = config["T"], config["num_obj"]
    net = setup(T=T, num_obj=num_obj,
                num_poly_faces=config["num_poly_faces"],
                seed=config["model_seed"])
    deepest = net.num_levels()
    players = sorted(net.network_depth_map[deepest])
    x = net.default_initialization
    dec_inds = sorted(set().union(*[set(net.decision_inds(i))
                                    for i in players]))
    param_inds = [i for i in range(net.num_vars) if i not in set(dec_inds)]
    labeled = {pid: create_labeled_gavi_from_qp(net, pid, {})
               for pid in players}
    avi = convert_gavi(combine_gavis(net.num_vars, dec_inds, param_inds,
                                     labeled))
    nd = len(dec_inds)
    total_xi = sum(lg.M1.shape[0] for lg in labeled.values())
    if total_xi != nd:
        raise ValueError(f"robust_avoid T={T} num_obj={num_obj}: the "
                         "players' decisions overlap, no KKT layout")
    # drop the ξ rows and columns, and put the stationarity rows in the
    # order of dec_inds (scenario_batch_gavis)
    n_full = avi.M.shape[0]
    keep = np.array([i for i in range(n_full)
                     if not (nd <= i < nd + total_xi)])
    stacked = [d for pid in sorted(players) for d in net.decision_inds(pid)]
    rowperm = [nd + stacked.index(d) for d in dec_inds]
    row_keep = np.array(rowperm + list(range(nd + total_xi, n_full)))
    M = avi.M[np.ix_(row_keep, keep)]
    n = M.shape[0]
    return Assembled(
        M=M, N=avi.N[row_keep], o=avi.o[row_keep], l=avi.l[keep],
        u=avi.u[keep], w0=x[param_inds].copy(), shifted=2 * (1 + num_obj),
        structure={"nd": nd, "m": (n - nd) // 2, "shared_M": True})


def lanes(sys: Assembled, shift: np.ndarray, jitter: np.ndarray):
    """(q, l, u) of every scenario, as ``scenario_batch_gavis`` forms them:
    ``shift`` (S, p) moves the leading parameters, ``jitter`` (S, n) the
    finite lower bounds that are not equalities."""
    q = np.empty(shift.shape[:-1] + (sys.M.shape[0],))
    for i in np.ndindex(*shift.shape[:-1]):
        w = sys.w0.copy()
        w[:sys.shifted] += shift[i]
        q[i] = sys.N @ w + sys.o
    fin_l, fin_u = np.isfinite(sys.l), np.isfinite(sys.u)
    both = fin_l & fin_u & (np.abs(sys.u - sys.l) < 1e-12)
    jittered = fin_l & ~both
    l = np.where(jittered, sys.l + jitter, sys.l)
    u = np.broadcast_to(sys.u, l.shape)
    return q, l, u
