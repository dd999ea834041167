"""f32 feasibility screen for batches of polyhedra (PyTorch port of
``qpn_tpu/ops/pallas_kernels.py::feasibility_screen``).

For polyhedra ``l ≤ Ax ≤ u`` of one dimension, ``steps`` projected-
subgradient steps

    v = max(l − Ax, 0) + min(u − Ax, 0),   x ← x + lr · Aᵀv

on the row-normalised rows drive x toward the polyhedron; a polyhedron whose
final max |v| is within ``margin``, and whose closure the host then finds to
contain x within ``margin``, is witnessed nonempty, and
``geometry.setops.is_empty_batch`` skips its exact LP.  The host check makes
the screen safe: a faulty engine can waste it but never flip a verdict.

Layout:

* :func:`screen_prepare` — the host preparation in numpy f32, the JAX
  package's own arithmetic (row norms floored at 1e-6, finite bounds clipped
  to ±1e30 before the divide) at exact shapes: rows are padded only to the
  batch's largest row count (zero rows with infinite bounds, which violate
  nothing), no 128-lane or 8-row padding, no batch tile, and IEEE
  infinities for missing bounds (no 3e38 stand-in).
* The step loop, in two engines with one signature
  ``(A, l, u, x0, steps, lr) -> (x, max|v|)`` on f32 tensors:
  :func:`screen_steps_torch`, the plain batched PyTorch loop, and
  ``ops/screen_cuda.feasibility_screen_cuda``, the hand-written Hopper
  kernel (one thread block per polyhedron, everything in shared memory).
* :func:`feasibility_screen` — prepare, run the engine that
  ``CONFIG.screen_kernel`` picks for ``CONFIG.device``, verify on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import CONFIG, numeric_device


class ScreenProblem(NamedTuple):
    """Prepared f32 inputs of the step loop (numpy, host)."""
    A: np.ndarray     # (B, m, n) row-normalised
    l: np.ndarray     # (B, m) missing bounds -inf
    u: np.ndarray     # (B, m) missing bounds +inf
    x0: np.ndarray    # (B, n)


def screen_prepare(polys, x0=None) -> ScreenProblem:
    """Stack and row-normalise a batch of polyhedra of one dimension."""
    B = len(polys)
    n = polys[0].dim
    m = max(max(p.m, 1) for p in polys)
    f32 = np.float32
    A = np.zeros((B, m, n), dtype=f32)
    l = np.full((B, m), -np.inf, dtype=f32)
    u = np.full((B, m), np.inf, dtype=f32)
    for i, p in enumerate(polys):
        A[i, :p.m] = p.A
        l[i, :p.m] = np.where(np.isfinite(p.l), p.l, -np.inf)
        u[i, :p.m] = np.where(np.isfinite(p.u), p.u, np.inf)
    x = np.zeros((B, n), dtype=f32)
    if x0 is not None:
        x[:] = np.asarray(x0, dtype=f32)
    # row-normalise for a uniform step size
    norms = np.maximum(np.linalg.norm(A, axis=2), 1e-6)     # (B, m)
    A_n = (A / norms[:, :, None]).astype(f32)
    l_n = np.where(np.isfinite(l), np.clip(l, -1e30, 1e30) / norms,
                   l).astype(f32)
    u_n = np.where(np.isfinite(u), np.clip(u, -1e30, 1e30) / norms,
                   u).astype(f32)
    return ScreenProblem(A=A_n, l=l_n, u=u_n, x0=x)


def _violation(A, l, u, x):
    ax = (A @ x[:, :, None])[:, :, 0]
    return torch.clamp_min(l - ax, 0.0) + torch.clamp_max(u - ax, 0.0)


def screen_steps_torch(A, l, u, x0, steps: int, lr: float):
    """``steps`` screen steps of every polyhedron, plain batched PyTorch in
    the inputs' dtype (the engine for CPU tensors, and the version the CUDA
    kernel is held against).  A (B,m,n); l/u (B,m); x0 (B,n).  Returns
    (x (B,n), max |v| (B,)); NaN propagates, as in ``jnp.maximum``."""
    x = x0.clone()
    for _ in range(steps):
        v = _violation(A, l, u, x)
        x = x + lr * (A.transpose(1, 2) @ v[:, :, None])[:, :, 0]
    return x, _violation(A, l, u, x).abs().amax(1)


ScreenEngine = Callable[..., tuple]


def screen_engine(device: torch.device) -> ScreenEngine:
    """The step loop ``CONFIG.screen_kernel`` selects for tensors on
    ``device``: "auto" takes the CUDA kernel for CUDA tensors and the plain
    loop for CPU tensors."""
    mode = CONFIG.screen_kernel
    if mode == "torch" or (mode == "auto" and device.type == "cpu"):
        return screen_steps_torch
    if mode in ("auto", "cuda"):
        from .screen_cuda import feasibility_screen_cuda
        return feasibility_screen_cuda
    raise ValueError(f"unknown CONFIG.screen_kernel {mode!r} "
                     "(expected 'auto', 'cuda' or 'torch')")


def feasibility_screen(polys, x0=None, steps: int = 120, lr: float = 0.05,
                       margin: float = 1e-3, engine: ScreenEngine | None = None):
    """Cheap f32 feasibility witnesses for a batch of polys (same dim), on
    ``CONFIG.device``.

    Returns (witnessed: bool array, witnesses: list).  ``witnessed[i]`` True
    means a point with max violation ≤ margin was found and the host found
    it in the closure of the poly within ``margin``: the poly is certainly
    nonempty (up to margin) and the exact LP can be skipped.  ``engine``
    defaults to :func:`screen_engine`'s pick; an engine that fails raises."""
    B = len(polys)
    if B == 0:
        return np.zeros(0, dtype=bool), []
    prob = screen_prepare(polys, x0)
    dev = numeric_device()
    run = engine or screen_engine(dev)
    xs, vs = run(*(torch.as_tensor(a, device=dev) for a in prob),
                 steps=steps, lr=lr)
    xs = xs.cpu().numpy().astype(np.float64)
    vs = vs.cpu().numpy()
    witnessed = np.zeros(B, dtype=bool)
    witnesses = [None] * B
    for i, p in enumerate(polys):
        # the host verification uses the caller's margin EXACTLY — a looser
        # window would certify witnesses the exact LP would reject
        if vs[i] <= margin and p.closure().contains(xs[i], tol=margin):
            witnessed[i] = True
            witnesses[i] = xs[i]
    return witnessed, witnesses
