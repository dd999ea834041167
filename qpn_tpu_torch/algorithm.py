"""QEP assembly of the multilevel equilibrium algorithm — slice 1 of the
port holds only the per-player KKT block and the GAVI stacking that the
scenario ensembles are built from (copies of ``qpn_tpu/algorithm.py``'s
``create_labeled_gavi_from_qp`` and ``combine_gavis``, numpy only).  The rest
of the algorithm (``solve`` and its helpers) comes with ROADMAP slice 2.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np

from .geometry.poly import Poly
from .network import QPNet
from .ops.avi import GAVI


# --------------------------------------------------------------------------
#  QEP assembly — avi.jl:205-377
# --------------------------------------------------------------------------

def create_labeled_gavi_from_qp(qpn: QPNet, pid: int,
                                solution_graphs: Dict[int, Poly]):
    """Per-player block with labeled variables Z = [x; ξᵢ; λᵢ; ψᵢ]
    (avi.jl:205-251).  Matches the live reference: the ξ identity block is
    zeroed (avi.jl:244) and ξ is pinned by the consensus top rows instead."""
    dvars = qpn.decision_inds(pid)
    n_dec = len(dvars)
    qp = qpn.qps[pid]
    n_total = qp.f.Q.shape[1]

    labels: Dict[str, int] = {}
    for i in range(n_total):
        labels[f"x_{i}"] = i
    for e, i in enumerate(dvars):
        labels[f"xi_{pid}_{i}"] = n_total + e
    total = n_total + n_dec

    blocks_A, blocks_l, blocks_u = [], [], []
    for ci in qp.constraint_indices:
        c = qpn.constraints[ci].poly
        for i in range(c.m):
            labels[f"lam_{pid}_{ci}_{i}"] = total + i
        total += c.m
        blocks_A.append(c.A)
        blocks_l.append(c.l)
        blocks_u.append(c.u)
    A_i = np.vstack(blocks_A) if blocks_A else np.zeros((0, n_total))
    l_i = np.concatenate(blocks_l) if blocks_l else np.zeros(0)
    u_i = np.concatenate(blocks_u) if blocks_u else np.zeros(0)

    blocks_A, blocks_l, blocks_u = [], [], []
    for j in sorted(qpn.network_edges[pid]):
        Sj = solution_graphs[j]
        for i in range(Sj.m):
            labels[f"psi_{pid}_{j}_{i}"] = total + i
        total += Sj.m
        blocks_A.append(Sj.A)
        blocks_l.append(Sj.l)
        blocks_u.append(Sj.u)
    A_S = np.vstack(blocks_A) if blocks_A else np.zeros((0, n_total))
    l_S = np.concatenate(blocks_l) if blocks_l else np.zeros(0)
    u_S = np.concatenate(blocks_u) if blocks_u else np.zeros(0)

    M1 = np.hstack([
        qp.f.Q[dvars, :],
        0.0 * np.eye(n_dec),            # zeroed ξ block (avi.jl:244)
        -A_i[:, dvars].T,
        -A_S[:, dvars].T,
    ])
    q1 = qp.f.q[dvars]
    M2 = np.vstack([A_i, A_S])
    l2 = np.concatenate([l_i, l_S])
    u2 = np.concatenate([u_i, u_S])
    return SimpleNamespace(dvars=dvars, labels=labels, M1=M1, q1=q1, M2=M2,
                           l2=l2, u2=u2)


def combine_gavis(n: int, dec_inds, param_inds, labeled_gavis,
                  layout: Optional[dict] = None) -> GAVI:
    """Stack per-player blocks into one GAVI over
    Z = [x_dec; ξ…; λψ…] with ξ-consensus top rows (avi.jl:305-377).

    ``layout``, if given, is filled with the combined column indices of the
    ψ variables (per-player solution-graph duals) — the MIN_NORM
    shared-variable mode's revision objective needs them
    (deprecated/avi.jl:148-369 semantics)."""
    nd = len(dec_inds)
    total_dual_dim = 0
    total_xi_dim = 0
    for pid, lg in labeled_gavis.items():
        total_dual_dim += lg.M1.shape[1] - n
        total_xi_dim += lg.M1.shape[0]
    xi_ranges: Dict[int, range] = {}
    lampsi_ranges: Dict[int, range] = {}
    off1, off2 = 0, total_xi_dim

    pool = sorted(labeled_gavis.keys())
    M_rows, N_rows, q_rows = [], [], []
    for pid in pool:
        lg = labeled_gavis[pid]
        M1 = lg.M1
        dual_dim = M1.shape[1] - n
        xi_dim = M1.shape[0]
        lampsi_dim = dual_dim - xi_dim
        xi_ranges[pid] = range(off1, off1 + xi_dim)
        lampsi_ranges[pid] = range(off2, off2 + lampsi_dim)
        Mi = np.zeros((xi_dim, nd + total_dual_dim))
        Mi[:, :nd] = M1[:, dec_inds]
        Mi[:, [nd + r for r in xi_ranges[pid]]] = M1[:, n:n + xi_dim]
        Mi[:, [nd + r for r in lampsi_ranges[pid]]] = M1[:, n + xi_dim:]
        M_rows.append(Mi)
        N_rows.append(M1[:, param_inds])
        q_rows.append(lg.q1)
        off1 += xi_dim
        off2 += lampsi_dim
    M = np.vstack(M_rows)
    N = np.vstack(N_rows)
    q = np.concatenate(q_rows)

    A_rows, B_rows, l2_rows, u2_rows = [], [], [], []
    for pid in pool:
        lg = labeled_gavis[pid]
        A_rows.append(lg.M2[:, dec_inds])
        B_rows.append(lg.M2[:, param_inds])
        l2_rows.append(lg.l2)
        u2_rows.append(lg.u2)
    A = np.vstack(A_rows)
    B = np.vstack(B_rows)
    l2 = np.concatenate(l2_rows)
    u2 = np.concatenate(u2_rows)

    top_M = np.zeros((nd, M.shape[1]))
    top_N = np.zeros((nd, N.shape[1]))
    top_q = np.zeros(nd)
    for pid in pool:
        lg = labeled_gavis[pid]
        xr = xi_ranges[pid]
        for di, d in enumerate(dec_inds):
            if d in lg.dvars:
                col = nd + xr[lg.labels[f"xi_{pid}_{d}"] - n]
                top_M[di, col] = 1.0

    if layout is not None:
        psi_inds = []
        for pid in pool:
            lg = labeled_gavis[pid]
            xi_dim = lg.M1.shape[0]
            lr = lampsi_ranges[pid]
            for key, idx in lg.labels.items():
                if key.startswith("psi_"):
                    psi_inds.append(nd + lr[idx - n - xi_dim])
        layout["psi_inds"] = sorted(psi_inds)
        layout["nd"] = nd

    M = np.vstack([top_M, M])
    N = np.vstack([top_N, N])
    o = np.concatenate([top_q, q])
    l1 = np.full(len(o), -np.inf)
    u1 = np.full(len(o), np.inf)
    A = np.hstack([A, np.zeros((A.shape[0], total_dual_dim))])
    return GAVI(M, N, o, l1, u1, A, B, l2, u2)
