"""Scaled robust trajectory avoidance — the flagship benchmark model.

Port of ``qpn_tpu/models/robust_avoid.py`` (same numpy code, same seeds: the
ensembles equal the JAX package's bit for bit).  Behavioral reference:
examples/deprecated/robust_avoid.jl (T-step trajectory with double-integrator
dynamics, per-obstacle adversaries and separation certificates):

* ego drives a T-step double-integrator trajectory toward +x, dynamics as
  equality constraints (the block-banded KKT structure of
  robust_avoid.jl:72-83);
* per obstacle k and step t, an adversary perturbs the obstacle and a
  certificate node computes the separation inflation ϵ[t,k] (as in
  robust_avoid_simple);
* scenario batching: :func:`scenario_batch_gavis` emits the per-node KKT
  GAVIs of S independent scenarios as padded ``(S·nodes, n, n)`` tensors —
  the batch axis of the batched KKT-AVI solve (``ops.avi.solve_kkt_avi_batch``).
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register
from .robust_avoid_simple import _affine_rows, _poly_faces


@register("robust_avoid")
def setup(T: int = 3, num_obj: int = 1, num_poly_faces: int = 4,
          exploration_vertices: int = 4, max_ego_delta: float = 2.0,
          max_obj_delta: float = 0.5, seed: int = 1, **kwargs):
    """T-step, num_obj-obstacle robust avoidance QPNet.

    Level structure: ego (all ue[·]) → adversaries (uo[·,k]) → certificates
    (s, ϵ).  Sizes stay per-node small (the scenario batch supplies the scale)."""
    rng = np.random.default_rng(seed)

    Ae, be = _poly_faces(rng, num_poly_faces)
    Aos, bos = [], []
    for _ in range(num_obj):
        Ao, bo = _poly_faces(rng, num_poly_faces)
        Aos.append(Ao)
        bos.append(bo)

    ue = variables("ue", 2, T)          # ego velocity deltas per step
    uo = variables("uo", 2, T, num_obj)
    xe = variables("xe", 2)             # initial ego position (parameter-like)
    xo = variables("xo", 2, num_obj)
    s = variables("s", 2, T, num_obj)
    eps = variables("eps", T, num_obj)

    b = QPNetBuilder(xe, xo, ue, uo, s, eps)
    net = b.net
    net.problem_data.update(Ae=Ae, be=be, Ao=Aos, bo=bos, T=T,
                            num_obj=num_obj)

    def ego_pos(t):
        """xe + Σ_{τ≤t} ue[:,τ] (single-integrator position rollout)."""
        px = xe[0]
        py = xe[1]
        for tau in range(t + 1):
            px = px + ue[0, tau]
            py = py + ue[1, tau]
        return [px, py]

    def obj_pos(t, k):
        px = xo[0, k]
        py = xo[1, k]
        for tau in range(t + 1):
            px = px + uo[0, tau, k]
            py = py + uo[1, tau, k]
        return [px, py]

    # one adversary per (timestep, obstacle), each parenting exactly one
    # certificate node — keeps every parent's child-combo product narrow
    # (the reference's combine guard, qp_processing.jl:281-285, aborts wide
    # products; robust_avoid_simple.jl:57-66 uses the same 1:1 structure)
    s_players, a_players = {}, {}
    for k in range(num_obj):
        for t in range(T):
            pe = ego_pos(t)
            po = obj_pos(t, k)
            rel_e = [s[0, t, k] - pe[0], s[1, t, k] - pe[1]]
            rel_o = [s[0, t, k] - po[0], s[1, t, k] - po[1]]
            cons = ([r + eps[t, k] for r in _affine_rows(Ae, rel_e, be)]
                    + [r + eps[t, k] for r in _affine_rows(Aos[k], rel_o, bos[k])])
            cid = b.add_constraint(cons, np.zeros(len(cons)),
                                   np.full(len(cons), np.inf))
            s_players[(t, k)] = b.add_qp(eps[t, k] * 1.0, [cid],
                                         s[:, t, k], eps[t, k])
            adv_cons = [uo[j, t, k] for j in range(2)]
            cid2 = b.add_constraint(adv_cons,
                                    np.full(2, -max_obj_delta),
                                    np.full(2, max_obj_delta))
            a_players[(t, k)] = b.add_qp(eps[t, k] * 1.0, [cid2],
                                         uo[:, t, k])

    ego_cons = ([ue[j, t] for t in range(T) for j in range(2)]
                + [eps[t, k] for k in range(num_obj) for t in range(T)])
    lb = np.concatenate([np.full(2 * T, -max_ego_delta),
                         np.zeros(T * num_obj)])
    ub = np.concatenate([np.full(2 * T, max_ego_delta),
                         np.full(T * num_obj, np.inf)])
    ego_cid = b.add_constraint(ego_cons, lb, ub)
    ego_cost = _lift(0.0)
    for t in range(T):
        pe = ego_pos(t)
        ego_cost = ego_cost + (-1.0) * pe[0] + 0.001 * pe[1] * pe[1]
        ego_cost = ego_cost + 0.1 * (ue[0, t] * ue[0, t] + ue[1, t] * ue[1, t])
    ego_player = b.add_qp(ego_cost, [ego_cid],
                          *[ue[:, t] for t in range(T)])

    edges = ([(ego_player, a_players[(t, k)])
              for k in range(num_obj) for t in range(T)]
             + [(a_players[(t, k)], s_players[(t, k)])
                for k in range(num_obj) for t in range(T)])
    b.add_edges(edges)
    b.assign_constraint_groups()
    b.set_options(exploration_vertices=exploration_vertices, **kwargs)

    init = np.zeros(net.num_vars)
    init[0:2] = [-3.0, 0.0]
    for k in range(num_obj):
        init[2 + 2 * k: 4 + 2 * k] = [2.0 * k, -0.5]
    net.default_initialization = init
    return net


def scenario_batch_gavis(num_scenarios: int = 64, T: int = 3,
                         num_obj: int = 1, num_poly_faces: int = 4,
                         seed: int = 0):
    """Emit the batched KKT AVIs of S uncertainty scenarios (padded tensors).

    One model is built; scenarios vary the *parameter* vector — initial ego /
    obstacle positions (the robust_avoid uncertainty axis) — which enters the
    certificate-level QEP AVI through ``q = N w + o``, plus a small jitter on
    the separation offsets (l2/u2).  Returns dict of stacked
    (M, q, l, u, z0, mask) numpy tensors ready for
    ``ops.avi.solve_kkt_avi_batch`` (via ``ops.avi.batch_from_numpy``)."""
    from ..algorithm import create_labeled_gavi_from_qp, combine_gavis
    from ..ops.avi import convert_gavi

    rng = np.random.default_rng(seed)
    net = setup(T=T, num_obj=num_obj, num_poly_faces=num_poly_faces,
                seed=seed)
    deepest = net.num_levels()
    players = sorted(net.network_depth_map[deepest])
    x = net.default_initialization
    dec_inds = sorted(set().union(*[set(net.decision_inds(i))
                                    for i in players]))
    param_inds = [i for i in range(net.num_vars) if i not in set(dec_inds)]
    labeled = {pid: create_labeled_gavi_from_qp(net, pid, {})
               for pid in players}
    gavi = combine_gavis(net.num_vars, dec_inds, param_inds, labeled)
    avi = convert_gavi(gavi)

    # ξ elimination: with disjoint per-player decisions every consensus row
    # pins one ξ to 0 and ξ columns appear nowhere else (avi.jl:244 zeroes
    # the ξ block), so dropping [top rows, ξ columns] yields the plain
    # stacked-KKT AVI — skew-symmetric + PSD (monotone), smaller, and
    # extragradient-friendly.
    nd = len(dec_inds)
    total_xi = sum(lg.M1.shape[0] for lg in labeled.values())
    if total_xi == nd:
        n_full = avi.M.shape[0]
        keep = np.array([i for i in range(n_full)
                         if not (nd <= i < nd + total_xi)])
        # stationarity rows are stacked per player (each in its own dvars
        # order); realign them to the global dec_inds order so row i pairs
        # with variable i — this is what restores the skew/monotone KKT
        # structure the extragradient pre-pass needs
        stacked = [d for pid in sorted(players) for d in net.decision_inds(pid)]
        rowperm = [nd + stacked.index(d) for d in dec_inds]
        row_keep = np.array(rowperm + list(range(nd + total_xi, n_full)))
        avi.M = avi.M[np.ix_(row_keep, keep)]
        avi.N = avi.N[row_keep]
        avi.o = avi.o[row_keep]
        avi.l = avi.l[keep]
        avi.u = avi.u[keep]

    S = num_scenarios
    n = avi.M.shape[0]
    Mt = np.repeat(avi.M[None], S, axis=0)
    qt = np.zeros((S, n))
    lt = np.repeat(avi.l[None], S, axis=0)
    ut = np.repeat(avi.u[None], S, axis=0)
    for sidx in range(S):
        w = x[param_inds].copy()
        # scenario: perturbed initial positions (the uncertainty axis)
        w[: 2 * (1 + num_obj)] += rng.standard_normal(2 * (1 + num_obj))
        qt[sidx] = avi.N @ w + avi.o
        # jittered separation offsets on finite LOWER bounds (where the
        # clearance offsets live); equality rows and upper bounds stay
        # exact so the dynamics/box structure is identical across scenarios
        fin_l = np.isfinite(lt[sidx])
        fin_u = np.isfinite(ut[sidx])
        jl = 0.05 * rng.standard_normal(n)
        both = fin_l & fin_u & (np.abs(ut[sidx] - lt[sidx]) < 1e-12)
        lt[sidx, fin_l & ~both] += jl[fin_l & ~both]
    zt = np.zeros((S, n))
    mask = np.ones((S, n), dtype=bool)
    out = dict(M=Mt, q=qt, l=lt, u=ut, z0=zt, mask=mask)
    if total_xi == nd:
        # the reduced layout is exactly [x (nd); lambda (m); s (m)] - expose
        # it so structured solvers (ops.avi.solve_kkt_avi_batch) can exploit
        # it.  shared_M: scenarios vary only (q, bounds) — M is one matrix
        # replicated across lanes (the np.repeat above), which the
        # shared-matrix GEMM route (ops.shared_kkt) exploits at trajectory
        # scale where per-lane tableaus no longer fit
        out["structure"] = {"nd": nd, "m": (n - nd) // 2, "shared_M": True}
    return out
