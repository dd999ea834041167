"""Driver entry points of the port (counterparts of the JAX package's
``__graft_entry__.py``).

``entry()``             — the forward step on the flagship model: the
                          batched semismooth-Newton AVI solve over
                          robust_avoid scenario KKT systems, on
                          ``CONFIG.device``.
``dryrun_multichip(n)`` — spawns n ranks of one ``torch.distributed``
                          process group (``parallel.launch``; NCCL when each
                          rank has a card of its own, gloo otherwise) and
                          runs on each the JAX package's four stages: the
                          sharded equilibrium superstep, a lockstep
                          ensemble with its waves split over the ranks, the
                          shared-matrix route with the mesh, and the
                          8192+64-piece ring dedup through
                          ``setops.remove_subsets``.
"""

from __future__ import annotations

import time
from typing import List, Optional


def entry():
    """``(forward, args)``: ``forward(*args)`` returns z of the robust_avoid
    batch at S=4, T=2, num_obj=1, num_poly_faces=4, seed 0, solved to 1e-8
    in at most 420 iterations; ``args`` are tensors on ``CONFIG.device``
    (which raises as ``config.numeric_device()`` does without a card)."""
    from .models.robust_avoid import scenario_batch_gavis
    from .ops.avi import batch_from_numpy, solve_avi_batch

    batch = scenario_batch_gavis(num_scenarios=4, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)

    def forward(M, q, l, u, z0, mask):
        return solve_avi_batch(M, q, l, u, z0, mask, tol=1e-8,
                               max_iter=420).z

    data = batch_from_numpy(batch)
    return forward, tuple(data[k] for k in ("M", "q", "l", "u", "z0",
                                            "mask"))


#: the JAX package's dry-run stages: lockstep weights, shared-route and
#: ring sizes
LOCKSTEP_WS = tuple((0.3 * k - 1.0, 1.0) for k in range(3))
RING_PIECES = 8192 + 64


def ring_pieces(n: int = RING_PIECES):
    """n disjoint unit boxes on a grid, every 4th a copy of its neighbour:
    the dedup does all the work and keeps n − n//4."""
    import numpy as np
    from .geometry.poly import Poly, PolyUnion
    polys = []
    for i in range(n):
        base = i - (i % 4 == 3)
        c = np.array([3.0 * (base % 128), 3.0 * (base // 128)])
        polys.append(Poly(np.eye(2), c, c + 1.0))
    return PolyUnion(polys)


def _dryrun_rank(mesh, superstep: Optional[dict]) -> dict:
    """One rank of :func:`dryrun_multichip`: the four stages, each timed,
    with the bytes its collectives sent and the rank's kernel launches;
    numpy results for the caller."""
    import numpy as np
    from . import setup
    from .geometry import setops
    from .models.robust_avoid import scenario_batch_gavis
    from .ops.shared_kkt import solve_kkt_avi_shared
    from .parallel.lockstep import solve_many_lockstep
    from .parallel.sharded import equilibrium_superstep
    from .utils.metrics import METRICS

    n = mesh.size
    secs, moved = {}, {}

    def stage(name, fn):
        b0 = METRICS.counters.get("dist_bytes", 0.0)
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        moved[name] = int(METRICS.counters.get("dist_bytes", 0.0) - b0)
        return out

    spec = dict(num_scenarios=2 * n, T=1, num_obj=1, num_poly_faces=3,
                seed=0, tol=1e-6, max_iter=420)
    spec.update(superstep or {})
    tol, max_iter = spec.pop("tol"), spec.pop("max_iter")
    batch = scenario_batch_gavis(**spec)
    out = stage("superstep", lambda: equilibrium_superstep(
        mesh, batch, tol=tol, max_iter=max_iter))
    z = out["z"].cpu().numpy()
    keep = out["keep"].cpu().numpy()
    if not (np.isfinite(z).all() and keep.shape == (spec["num_scenarios"],)):
        raise RuntimeError("dryrun: the sharded superstep gave non-finite z "
                           f"or a keep mask of shape {keep.shape}")

    # the whole equilibrium loop as a lockstep ensemble over the same mesh
    ws = [np.array(w) for w in LOCKSTEP_WS]
    qpns = [setup("simple_bilevel") for _ in ws]
    x0s = [np.concatenate([w, [0.0, 0.0]]) for w in ws]
    rets, broker = stage("lockstep",
                         lambda: solve_many_lockstep(qpns, x0s, mesh=mesh))
    if not (all(r.solved for r in rets) and broker.waves >= 1):
        raise RuntimeError("dryrun: a lockstep scenario failed")

    # the trajectory-scale shared-matrix route, split over the same mesh
    sb = scenario_batch_gavis(num_scenarios=4 * n, T=2, num_obj=1,
                              num_poly_faces=4, seed=1)
    shr = stage("shared", lambda: solve_kkt_avi_shared(
        sb["M"], sb["q"], sb["l"], sb["u"], sb["mask"], tol=1e-8,
        mesh=mesh, structure=sb["structure"]))
    if not bool(shr.converged.all()):
        raise RuntimeError("dryrun: the sharded shared route left lanes "
                           "uncertified")

    # the ring prune at scale through the production dedup entry (the
    # counters restart; the kernel launch counts of the whole run stay)
    METRICS.reset(launches=False)
    pu = ring_pieces()
    pruned = stage("ring", lambda: setops.remove_subsets(pu))
    ring_waves = int(METRICS.counters.get("ring_prune_waves", 0))
    if len(pruned) != RING_PIECES - RING_PIECES // 4:
        raise RuntimeError(f"dryrun: the ring dedup kept {len(pruned)} "
                           "pieces, the wrong set")
    if ring_waves < 1:
        raise RuntimeError("dryrun: the ring prune did not fire at "
                           f"{RING_PIECES} pieces")

    frac = float(out["converged_frac"])
    line = (f"dryrun_multichip: mesh={tuple(mesh.shape.items())} "
            f"backend={mesh.backend} device={mesh.device} "
            f"scenarios={spec['num_scenarios']} converged_frac={frac:.2f} "
            f"kept={int(keep.sum())} lockstep_solves={len(rets)} "
            f"waves={broker.waves} "
            f"shared_route_lanes={int(shr.converged.sum())} "
            f"ring_prune_waves={ring_waves} "
            f"ring_pieces={RING_PIECES}->{len(pruned)}")
    if mesh.rank == 0:
        print(line, flush=True)
    return dict(
        line=line, rank=mesh.rank, backend=mesh.backend,
        device=str(mesh.device), z=z, keep=keep,
        resid=out["resid"].cpu().numpy(),
        converged=(out["resid"] <= tol).cpu().numpy(), frac=frac,
        x_opts=np.stack([np.asarray(r.x_opt) for r in rets]),
        pieces=[{k: len(v) for k, v in r.Sol.items() if v is not None}
                for r in rets],
        waves=broker.waves, shared_z=shr.z.cpu().numpy(),
        shared_iters=shr.iters.cpu().numpy(),
        shared_conv=shr.converged.cpu().numpy(),
        ring_kept=len(pruned), ring_waves=ring_waves,
        ring_sigs=sorted(setops.piece_signature(p).tobytes()
                         for p in pruned.polys),
        secs=secs, bytes=moved, launches=dict(METRICS.launches))


def dryrun_multichip(n_devices: int, superstep: Optional[dict] = None,
                     timeout_s: float = 900.0) -> List[dict]:
    """Spawn ``n_devices`` ranks (``parallel.launch.spawn``) and run the dry
    run's four stages on each; rank 0 prints the summary line.  The
    superstep runs on the JAX package's batch (S = 2n, T=1, num_obj=1,
    num_poly_faces=3, seed 0, tol 1e-6, 420 iterations) unless
    ``superstep`` overrides its ``scenario_batch_gavis`` arguments, ``tol``
    or ``max_iter``.  Returns each rank's results (numpy), in rank order;
    raises when a rank fails or the ranks outlast ``timeout_s``."""
    from .parallel.launch import spawn
    return spawn(_dryrun_rank, n_devices, (superstep,), timeout_s=timeout_s)
