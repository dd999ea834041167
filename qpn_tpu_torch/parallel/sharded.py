"""Level-pipeline sweep of chain networks (PyTorch port of
``stack_chain_avis`` and ``level_sweep_scan`` from
``qpn_tpu/parallel/sharded.py``; the rest of that module is the multi-device
layer, ROADMAP M5).

``algorithm._chain_sweep_warmstart`` stacks a chain network's per-level KKT
AVIs and solves them bottom-up, each level's decision feeding the next
level's q; the JAX package runs the sweep as one ``lax.scan``, the port as a
loop over levels, each level a batch of one on ``CONFIG.device`` through the
hybrid semismooth-Newton solver (``ops.avi.solve_avi_batch``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import numeric_device
from ..ops.avi import solve_avi_batch


def stack_chain_avis(qpn):
    """Stack a chain network's per-level KKT AVIs into uniform tensors for
    :func:`level_sweep_scan`.

    Restricted to the level-pipeline fast class: one player per level, a
    single box-constraint set, and (as in the reference's latent PP axis,
    algorithm.jl:32-43) each level's QP parameterized only by its CHILD's
    decision — so the bottom-up sweep is a pure dataflow.  Returns
    (M, Ncarry, o, l, u, dec_slice) stacked bottom-up with uniform shapes.
    """
    L = qpn.num_levels()
    per_level = []
    for lv in range(L, 0, -1):               # bottom-up
        players = sorted(qpn.network_depth_map[lv])
        assert len(players) == 1, "chain sweep needs one player per level"
        pid = players[0]
        qp = qpn.qps[pid]
        own = sorted(qp.var_indices)
        child = sorted(qpn.network_edges[pid])
        cvars = sorted(qpn.qps[child[0]].var_indices) if child else []
        cons = [qpn.constraints[c].poly for c in qp.constraint_indices]
        A_full = np.vstack([c.A for c in cons])
        # the fast class requires constraints on OWN variables only and
        # objective coupling only to the single child — anything else must
        # fail loudly here, not solve a silently different network
        other = sorted(set(range(A_full.shape[1])) - set(own))
        if other and np.abs(A_full[:, other]).max(initial=0.0) > 0:
            raise ValueError(
                "stack_chain_avis: constraints couple non-own variables — "
                "outside the level-pipeline fast class")
        non_child = sorted(set(range(qp.f.Q.shape[1])) - set(own)
                           - set(cvars))
        if non_child and np.abs(
                qp.f.Q[np.ix_(own, non_child)]).max(initial=0.0) > 0:
            raise ValueError(
                "stack_chain_avis: objective couples variables beyond the "
                "first child — outside the level-pipeline fast class")
        A = A_full[:, own]
        lb = np.concatenate([c.l for c in cons])
        ub = np.concatenate([c.u for c in cons])
        nd, m = len(own), len(lb)
        k = nd + 2 * m
        Q = qp.f.Q[np.ix_(own, own)]
        qlin = qp.f.q[own]
        Qc = (qp.f.Q[np.ix_(own, cvars)] if cvars
              else np.zeros((nd, len(own))))
        # KKT AVI over z=[x; λ; s]:  Qx + Qc·c + q − A'λ ⟂ x free
        #                            Ax − s = 0 (free λ);  λ ⟂ l ≤ s ≤ u
        M = np.zeros((k, k))
        M[:nd, :nd] = Q
        M[:nd, nd:nd + m] = -A.T
        M[nd:nd + m, :nd] = A
        M[nd:nd + m, nd + m:] = -np.eye(m)
        M[nd + m:, nd:nd + m] = np.eye(m)
        Nc = np.zeros((k, Qc.shape[1]))
        Nc[:nd] = Qc
        o = np.concatenate([qlin, np.zeros(2 * m)])
        lo = np.concatenate([np.full(nd + m, -np.inf), lb])
        hi = np.concatenate([np.full(nd + m, np.inf), ub])
        per_level.append((M, Nc, o, lo, hi, nd, own))
    ks = {p[0].shape[0] for p in per_level}
    cs = {p[1].shape[1] for p in per_level}
    assert len(ks) == 1 and len(cs) == 1, "chain sweep needs uniform shapes"
    M = np.stack([p[0] for p in per_level])
    Nc = np.stack([p[1] for p in per_level])
    o = np.stack([p[2] for p in per_level])
    lo = np.stack([p[3] for p in per_level])
    hi = np.stack([p[4] for p in per_level])
    nd = per_level[0][5]
    owns = [p[6] for p in per_level]
    return M, Nc, o, lo, hi, nd, owns


def level_sweep_scan(M, Ncarry, o, l, u, nd, carry0, tol=1e-9, max_iter=60):
    """Bottom-up level pipeline (SURVEY §2.3 row 6 — the PP analogue the
    reference leaves latent at algorithm.jl:32-43).

    Per level: q = Ncarry·carry + o; solve the level's KKT AVI with the
    hybrid semismooth-Newton solver from z = 0; the level's decision block
    becomes the next carry.  Returns (carry, zs (L, k), resids (L,)) as
    numpy arrays."""
    dev = numeric_device()

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    M, Ncarry, o, l, u = (t(a) for a in (M, Ncarry, o, l, u))
    carry = t(carry0)
    zs, resids = [], []
    for lv in range(M.shape[0]):
        q = Ncarry[lv] @ carry + o[lv]
        k = q.shape[0]
        res = solve_avi_batch(M[lv][None], q[None], l[lv][None], u[lv][None],
                              torch.zeros(1, k, dtype=torch.float64,
                                          device=dev),
                              torch.ones(1, k, dtype=torch.bool, device=dev),
                              tol=tol, max_iter=max_iter)
        zs.append(res.z[0])
        resids.append(res.resid[0])
        carry = res.z[0, :nd]
    return (carry.cpu().numpy(), torch.stack(zs).cpu().numpy(),
            torch.stack(resids).cpu().numpy())
