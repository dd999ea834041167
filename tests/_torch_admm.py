"""Inputs of the batched ADMM's block kernel (``ops/admm_cuda.py``) for its
CPU and GPU tests: the shared-matrix QPs of robust_avoid T=8 (nd=96, m=256),
and the inputs of the blocks that ``batch_qp.solve_qp_batch`` runs on them.
Imports neither JAX nor the JAX package."""

import pytest
import torch

from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import batch_qp

def shared_qps(S, device, seed=0):
    """The QPs that the shared-matrix route's ADMM rung solves on S lanes
    of robust_avoid T=8, num_obj=4 (``shared_kkt._admm_shared_call``): Q
    and A broadcast over the lanes, (c, lo, hi, row_mask)."""
    b = scenario_batch_gavis(num_scenarios=S, T=8, num_obj=4,
                             num_poly_faces=4, seed=seed)
    nd, m = b["structure"]["nd"], b["structure"]["m"]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    M0, q, l, u = t(b["M"][0]), t(b["q"]), t(b["l"]), t(b["u"])
    off = q[:, nd:nd + m]
    return dict(P=M0[:nd, :nd].expand(S, nd, nd), q=q[:, :nd].contiguous(),
                A=M0[nd:nd + m, :nd].expand(S, m, nd),
                l=(l[:, nd + m:nd + 2 * m] - off).contiguous(),
                u=(u[:, nd + m:nd + 2 * m] - off).contiguous(),
                row_mask=torch.ones(S, m, dtype=torch.bool, device=device))


def plain_block(A, L, R, q, lc, uc, loose, x, z, y, dx, dy, *, sigma, alpha,
                iters):
    """``iters`` calls of ``batch_qp._iterate``, written into x, z, y, dx,
    dy as the kernel writes them."""
    d = batch_qp._Lanes(A=A, q=q, lc=lc, uc=uc, loose=loose)
    state = (x, z, y, dx, dy)
    for _ in range(iters):
        state = batch_qp._iterate(d, batch_qp._DenseFactor(L), R, *state,
                                  sigma=sigma, alpha=alpha)
    for dst, src in zip((x, z, y, dx, dy), state):
        dst.copy_(src)
    return x, z, y, dx, dy


def capture_blocks(qps, **kw):
    """Solve ``qps`` with ``solve_qp_batch(**kw)``, every block by
    :func:`plain_block`, and return the solution and each block's inputs:
    (tensors, sigma, alpha, iters), tensors cloned before the block ran."""
    seen = []

    def record(*tensors, sigma, alpha, iters):
        seen.append(([t.clone() for t in tensors], sigma, alpha, iters))
        return plain_block(*tensors, sigma=sigma, alpha=alpha, iters=iters)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_qp, "_fused_block", lambda *a: record)
        sol = batch_qp.solve_qp_batch(**qps, **kw)
    return sol, seen
