"""Multi-device equilibrium functions: sharded batched AVI solves, the
collective piece prune, the equilibrium superstep, and the level-pipeline
sweep of chain networks (PyTorch port of ``qpn_tpu/parallel/sharded.py``).

The scaling axes are the JAX package's:

* scenario batches (dp): independent QPNet instances solve as one batch
  split over the mesh (``parallel/mesh.py``), each rank its contiguous
  block, with no communication inside the solve and one gather after it;
* branch/piece batches (ep/tp): the piece dedup (``remove_subsets``,
  sets.jl:889-905) needs all-pairs information: each rank decides its block
  of pieces against all of them and the keep-masks are gathered, with the
  deterministic order-based tie-break of the reference's serial loop (which
  its own threading bug note demands); above ``RING_PRUNE_THRESHOLD`` pieces
  the reference set rotates around the ring of ranks instead
  (``parallel/ring.py``);
* global convergence flags reduce over the full, gathered result.

Every rank calls these functions with the same inputs and gets the full
result (the SPMD contract of ``parallel/mesh.py``).

``stack_chain_avis`` and ``level_sweep_scan`` are the level pipeline:
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
from ..ops.avi import AVIResult, inert_avi_lanes, solve_avi_batch
from .mesh import Mesh, block_rows, call_sharded, gather

#: above this many pieces the prune's all-pairs compare against the full set
#: is routed through the ring rotation, O(block) memory a rank
RING_PRUNE_THRESHOLD = 4096


def sharded_avi_solve(mesh: Mesh, M, q, l, u, z0, mask, tol=1e-8,
                      max_iter=840) -> AVIResult:
    """Solve a scenario batch of AVIs with the batch axis split over the
    whole mesh: the hybrid semismooth-Newton solver
    (``ops.avi.solve_avi_batch``, the JAX ``_newton_solve``'s f64 iterates
    lane for lane) on this rank's block, then a gather.  Inputs are host
    numpy (or tensors), the same on every rank; the batch is padded with
    inert lanes to a multiple of the rank count.  Returns an AVIResult of
    tensors on the mesh's device, full on every rank."""
    dev = mesh.device
    f64 = torch.float64
    args = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a, dtype=f64, device=dev)
            for a in (M, q, l, u, z0)]
    args.append(torch.as_tensor(mask, dtype=torch.bool, device=dev))
    n = args[1].shape[1]
    return call_sharded(
        mesh, lambda *a: solve_avi_batch(*a, tol=tol, max_iter=max_iter),
        args, lambda k: inert_avi_lanes(k, n, f64, dev))


def _dominated(act, rq, idx, ref_act, ref_rq, ref_idx):
    """Is each row dominated by a reference row with the same signature:
    strictly smaller (quantized resid, index), lexicographically?"""
    same = (act[:, None, :] == ref_act[None, :, :]).all(-1)
    better = (ref_rq[None, :] < rq[:, None]) | (
        (ref_rq[None, :] == rq[:, None]) & (ref_idx[None, :] < idx[:, None]))
    return (same & better).any(1)


def sharded_containment_prune(mesh: Mesh, act, resid) -> torch.Tensor:
    """Deterministic piece-dedup keep-mask with collectives.

    ``act``  (B, k): quantized active-set signature per piece.
    ``resid`` (B,):  quality score (lower is better).

    Piece i is dropped iff an equivalent piece j (same signature) exists with
    (resid_j, j) < (resid_i, i) lexicographically: the order-based tie-break
    that keeps exactly one of each duplicate group, independent of the split
    (the property the reference's threading bug violated).  The comparison
    is STRICT on round(resid·1e12), a total order, so it is transitive:
    float noise below 12 digits cannot drop a whole chain of near-equal
    pieces.  Every rank holds all pieces (the SPMD contract), decides its
    block against all of them and the keep-masks are gathered; beyond
    ``RING_PRUNE_THRESHOLD`` pieces the ring-rotated prune takes over
    (``ring_prune_waves``) with the identical mask at O(block) memory.
    Returns bool (B,) on the mesh's device, full on every rank; the mask is
    integer logic, bit for bit the JAX package's."""
    B = act.shape[0]
    if B > RING_PRUNE_THRESHOLD:
        from ..utils.metrics import METRICS
        from .ring import ring_containment_prune
        METRICS.bump("ring_prune_waves")
        return ring_containment_prune(mesh, act, resid)
    dev = mesh.device
    act = torch.as_tensor(act, device=dev)
    rq = torch.round(torch.as_tensor(resid, dtype=torch.float64,
                                     device=dev) * 1e12)
    idx = torch.arange(B, device=dev)
    mine = block_rows(mesh, B)
    dom = _dominated(act[mine], rq[mine], idx[mine], act, rq, idx)
    return gather(mesh, ~dom, total=B)


def equilibrium_superstep(mesh: Mesh, batch, tol=1e-8, max_iter=840):
    """One full sharded equilibrium iteration, the framework's "training
    step" analogue, driven by ``entry.dryrun_multichip``:

    1. scenario-sharded batched AVI solve               (dp)
    2. global convergence fraction
    3. active-set signatures per scenario solution
    4. collective duplicate-piece prune                 (ep/tp)

    Trajectory-scale shared-matrix ensembles (``batch["structure"]`` with
    ``shared_M`` at n ≥ ``CONFIG.shared_kkt_min_n``, every variable live)
    go through the shared-matrix route (``ops.shared_kkt``) with the same
    mesh; as in the JAX package, that branch ignores ``max_iter`` and
    ``batch["z0"]`` (the route starts from its own extragradient pre-pass
    and runs its own budgets).  Small ensembles keep the sharded Newton
    solve.  ``batch`` holds numpy arrays or tensors; its shape is read
    without a host copy.  Returns z, resid (tensors on the mesh's device),
    converged_frac (a 0-d tensor) and keep (bool tensor), full on every
    rank."""
    from ..config import CONFIG
    structure = batch.get("structure") if hasattr(batch, "get") else None
    n = batch["M"].shape[-1]
    if (structure is not None and structure.get("shared_M")
            and n >= CONFIG.shared_kkt_min_n
            and bool(torch.as_tensor(batch["mask"]).all())):
        from ..ops.shared_kkt import solve_kkt_avi_shared
        M = batch["M"]
        res = solve_kkt_avi_shared(
            M[0] if M.ndim == 3 else M, batch["q"], batch["l"], batch["u"],
            None, tol=tol, structure=structure, mesh=mesh)
    else:
        res = sharded_avi_solve(mesh, batch["M"], batch["q"], batch["l"],
                                batch["u"], batch["z0"], batch["mask"],
                                tol=tol, max_iter=max_iter)
    z = res.z
    frac = res.converged.to(torch.float64).mean()
    l = torch.as_tensor(batch["l"], dtype=z.dtype, device=z.device)
    u = torch.as_tensor(batch["u"], dtype=z.dtype, device=z.device)
    lq = torch.where(torch.isfinite(l), l, -1e20)
    uq = torch.where(torch.isfinite(u), u, 1e20)
    at_l = (z - lq).abs() < 1e-6
    at_u = (z - uq).abs() < 1e-6
    act = at_l.to(torch.int32) + 2 * at_u.to(torch.int32)
    keep = sharded_containment_prune(mesh, _fetch_global(act),
                                     _fetch_global(res.resid))
    return dict(z=z, resid=res.resid, converged_frac=frac, keep=keep)


def _fetch_global(a) -> np.ndarray:
    """Host copy of a result that is already full on every rank (the JAX
    package needs a process allgather here; the port's gathers have run)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


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
