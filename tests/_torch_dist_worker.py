"""Rank bodies of the port's multi-device tests (``tests/test_torch_parallel
.py``, ``_ring``, ``_multihost``).  Spawned ranks import this module by name
to unpickle :func:`run_cases`, so it imports neither JAX nor the JAX package;
the test files hold the ranks' results against the JAX package.

``run_cases(mesh, cases)`` runs a list of ``(key, name, kwargs)`` on one
rank of one process group and returns ``{key: numpy results}``: one group
serves every case of a test module.
"""

import sys

import numpy as np


def _np(res):
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for k, v in res._asdict().items()}


def case_avi(mesh, M, q, l, u, z0, mask, tol):
    from qpn_tpu_torch.parallel.sharded import sharded_avi_solve
    return _np(sharded_avi_solve(mesh, M, q, l, u, z0, mask, tol=tol))


def case_avi_padded(mesh, M, q, l, u, z0, mask, tol):
    import torch
    from qpn_tpu_torch.ops.avi import solve_avi_batch_padded
    from qpn_tpu_torch.parallel.mesh import scenario_sharding
    t = [torch.as_tensor(a, device=mesh.device) for a in (M, q, l, u, z0)]
    return _np(solve_avi_batch_padded(
        *t, torch.as_tensor(mask, device=mesh.device),
        _sharding=scenario_sharding(mesh), _min_batch=mesh.size, tol=tol))


def case_qp_padded(mesh, P, q, A, l, u, mask, **kw):
    from qpn_tpu_torch.ops.batch_qp import solve_qp_batch_padded
    from qpn_tpu_torch.parallel.mesh import scenario_sharding
    return _np(solve_qp_batch_padded(
        P, q, A, l, u, mask, _sharding=scenario_sharding(mesh),
        _min_batch=mesh.size, **kw))


def case_prune(mesh, act, resid):
    from qpn_tpu_torch.parallel.sharded import sharded_containment_prune
    return sharded_containment_prune(mesh, act, resid).cpu().numpy()


def case_ring_prune(mesh, act, resid):
    from qpn_tpu_torch.parallel.ring import ring_containment_prune
    return ring_containment_prune(mesh, act, resid).cpu().numpy()


def case_ring_dup(mesh, sig, ref):
    from qpn_tpu_torch.parallel.ring import ring_duplicate_mask
    return ring_duplicate_mask(mesh, sig, ref).cpu().numpy()


def case_superstep(mesh, tol, max_iter=840, **spec):
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.parallel.sharded import equilibrium_superstep
    from qpn_tpu_torch.utils.metrics import METRICS
    batch = scenario_batch_gavis(**spec)
    c0 = METRICS.counters.get("shared_kkt_solves", 0)
    out = equilibrium_superstep(mesh, batch, tol=tol, max_iter=max_iter)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["shared_kkt_solves"] = METRICS.counters.get("shared_kkt_solves",
                                                    0) - c0
    return res


def case_shared(mesh, tol, **spec):
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops.shared_kkt import solve_kkt_avi_shared
    sb = scenario_batch_gavis(**spec)
    return _np(solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"],
                                    None, tol=tol, structure=sb["structure"],
                                    mesh=mesh))


def case_lockstep(mesh, ws):
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.parallel.lockstep import solve_many_lockstep
    qpns = [qt.setup("simple_bilevel") for _ in ws]
    x0s = [np.concatenate([w, [0.0, 0.0]]) for w in ws]
    outs, broker = solve_many_lockstep(qpns, x0s, mesh=mesh)
    return dict(solved=[o.solved for o in outs],
                x_opts=np.stack([np.asarray(o.x_opt) for o in outs]),
                pieces=[{k: len(v) for k, v in o.Sol.items()
                         if v is not None} for o in outs],
                waves=broker.waves)


def case_dedup(mesh, n):
    from qpn_tpu_torch.entry import ring_pieces
    from qpn_tpu_torch.geometry import setops
    from qpn_tpu_torch.utils.metrics import METRICS
    METRICS.reset()
    pu = ring_pieces(n)
    ids = {id(p): i for i, p in enumerate(pu.polys)}
    kept = setops._dedup_signatures(pu)
    return dict(kept=np.array([ids[id(p)] for p in kept.polys]),
                counters=dict(METRICS.counters))


def case_dedup_in_broker(mesh, n):
    """The dedup from a lockstep scenario thread: the host loop."""
    from qpn_tpu_torch.parallel.lockstep import LockstepBroker
    (out,) = LockstepBroker(mesh=mesh).run([lambda: case_dedup(mesh, n)])
    return out


def case_remove_subsets(mesh, n):
    from qpn_tpu_torch.entry import ring_pieces
    from qpn_tpu_torch.geometry import setops
    from qpn_tpu_torch.utils.metrics import METRICS
    METRICS.reset()
    out = setops.remove_subsets(ring_pieces(n))
    return dict(n=len(out), counters=dict(METRICS.counters),
                sigs=sorted(setops.piece_signature(p).tobytes()
                            for p in out.polys))


def case_info(mesh):
    from qpn_tpu_torch.parallel.multihost import process_info
    return dict(info=process_info(), shape=dict(mesh.shape),
                axis_names=mesh.axis_names, backend=mesh.backend,
                rank=mesh.rank, device=str(mesh.device),
                jax=sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "qpn_tpu")))


def case_fail(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.barrier()          # rank 0 waits here for a peer that is gone


def case_hang(mesh):
    import time
    time.sleep(3600)


def run_cases(mesh, cases):
    out = {}
    for key, name, kw in cases:
        out[key] = globals()["case_" + name](mesh, **kw)
    return out
