"""A configuration's pool of lanes on the reference's side: the traffic
generator's draw applied to the reference's own statement."""

from __future__ import annotations

import importlib

import numpy as np

from .. import traffic


def lanes(config: dict, mix: dict):
    """(problem, q, l, u) of the mix's pool: q, l, u of shape (pool,
    lanes, n)."""
    model = importlib.import_module(f"qpnbench.reference.{config['model']}")
    prob = model.problem(config)
    n = prob.M.shape[0]
    draws = traffic.draw_pool(mix, prob.dq.shape[1], n)
    q, l, u = model.lanes(prob, draws.shift, draws.jitter)
    return prob, q, l, np.ascontiguousarray(u)


def solve(config: dict, mix: dict, dtype, device):
    """The plain Lemke solve (``reference/lemke.py``) of every ensemble of
    the mix's pool from z = 0, in ``dtype`` (float32: the settings of a
    float32 pivot path; float64: those of a float64 one) on ``device``.
    Returns (problem, q, l, u, [(z, status, pivots) of each ensemble]),
    z in float64 and all on the host."""
    import torch
    from . import lemke
    prob, q, l, u = lanes(config, mix)
    P, S, n = q.shape
    M = torch.as_tensor(prob.M, dtype=dtype, device=device).expand(
        S, n, n).contiguous()
    settings = lemke.F32 if dtype == torch.float32 else lemke.F64
    out = []
    for e in range(P):
        z, status, piv = lemke.solve(
            M, *(torch.as_tensor(a[e], dtype=dtype, device=device)
                 for a in (q, l, u)),
            max_pivots=lemke.max_pivots(n), **settings)
        out.append((z.double().cpu().numpy(), status.cpu().numpy(),
                    piv.cpu().numpy()))
    return prob, q, l, u, out
