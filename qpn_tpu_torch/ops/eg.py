"""Fused extragradient warm start for batches of box AVIs (PyTorch port of
``qpn_tpu/ops/pallas_kernels.py::eg_warmstart``).

Korpelevich's extragradient method

    z½ = Π[l,u](z − τ(Mz + q)),   z⁺ = Π[l,u](z − τ(Mz½ + q))

runs ``steps`` times on every lane in f32, after a complementarity-preserving
Ruiz scaling; the adaptive solver (``ops/avi.solve_avi_batch_adaptive``)
accepts the result per lane only where it lowers the natural residual.

Layout:

* :func:`eg_prepare` — the scaling and masking, in torch on the tensors'
  device (the JAX package does it on the host in numpy).
* The step loop, in two engines with one signature
  ``(M, q, l, u, z0, tau, steps) -> z`` on the prepared f32 tensors:
  :func:`eg_steps_torch`, the plain batched PyTorch loop, and
  ``ops/eg_cuda.eg_warmstart_cuda``, the hand-written Hopper kernel (one
  thread block per lane, the lane's matrix in registers, each row split
  over four threads of a warp).
* :func:`eg_warmstart` — prepare, run the engine that ``CONFIG.eg_kernel``
  picks for the tensors' device, unscale.

The TPU shapes are gone: no padding of n to 128 lanes or of the batch to
16-lane tiles, no first-use probe, and IEEE infinities stand for missing
bounds (no 3e38 stand-in).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import CONFIG

# the JAX package pads every lane's n up to a multiple of this lane width
_TPU_LANE = 128


class EGProblem(NamedTuple):
    """Prepared f32 inputs of the step loop, plus the column scaling."""
    M: torch.Tensor      # (B, n, n) scaled; masked variables identity rows
    q: torch.Tensor      # (B, n)
    l: torch.Tensor      # (B, n) masked variables 0, missing bounds ±inf
    u: torch.Tensor      # (B, n)
    z0: torch.Tensor     # (B, n)
    tau: torch.Tensor    # (B,) step size
    e: torch.Tensor      # (B, n) f64 column scaling: z = e · z_scaled
    mask: torch.Tensor   # (B, n) bool


def ruiz(M: torch.Tensor, iters: int = 8):
    """Complementarity-preserving Ruiz scaling, batched: row scaling d and
    column scaling e with d·M·e balanced (``qpn_tpu/ops/pallas_kernels.py::
    _ruiz_np`` and the solver's own ``ruiz``)."""
    B, n, _ = M.shape
    d = torch.ones(B, n, dtype=M.dtype, device=M.device)
    e = torch.ones_like(d)
    for _ in range(iters):
        Ms = (d[:, :, None] * M * e[:, None, :]).abs()
        r = Ms.amax(2).clamp(1e-8, 1e8)
        c = Ms.amax(1).clamp(1e-8, 1e8)
        d = d / r.sqrt()
        e = e / c.sqrt()
    return d, e


def eg_prepare(M, q, l, u, z0, var_mask) -> EGProblem:
    """Scale in f64, pin masked variables (identity row, l = u = 0), cast to
    f32 and size the step: τ = 0.9 / (1 + ‖M‖∞) per lane."""
    f64 = torch.float64
    M, q, l, u, z0 = (a.to(f64) for a in (M, q, l, u, z0))
    mask = var_mask.to(torch.bool)
    n = q.shape[1]
    mm = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(n, dtype=f64, device=M.device)
    d, e = ruiz(torch.where(mm, M, eye))
    zero = torch.zeros((), dtype=f64, device=M.device)
    Ms = torch.where(mm, d[:, :, None] * M * e[:, None, :], zero)
    Ms = torch.where(~mask[:, :, None] & eye.bool(), 1.0, Ms)
    ls = torch.where(torch.isfinite(l), l / e, l)
    us = torch.where(torch.isfinite(u), u / e, u)
    M32 = Ms.float()
    Linf = M32.abs().sum(2).amax(1)
    if n % _TPU_LANE:
        # The JAX package computes ‖M‖∞ on the lane padded to a multiple of
        # 128, whose padding rows are identity rows: its norm is never below
        # 1 there.  Keep that, so both packages take the same step.
        Linf = Linf.clamp_min(1.0)
    return EGProblem(
        M=M32, q=torch.where(mask, d * q, zero).float(),
        l=torch.where(mask, ls, zero).float(),
        u=torch.where(mask, us, zero).float(),
        z0=torch.where(mask, z0 / e, zero).float(),
        tau=0.9 / (1.0 + Linf), e=e, mask=mask)


def eg_step(M, q, l, u, z, t) -> torch.Tensor:
    """One extragradient step on every lane; t is the step size (B, 1)."""
    F = torch.bmm(M, z[:, :, None])[:, :, 0] + q
    z_half = torch.clamp(z - t * F, l, u)
    F_half = torch.bmm(M, z_half[:, :, None])[:, :, 0] + q
    return torch.clamp(z - t * F_half, l, u)


def eg_steps_torch(M, q, l, u, z0, tau, steps: int) -> torch.Tensor:
    """``steps`` extragradient steps on every lane, plain batched PyTorch in
    the inputs' dtype (the engine for CPU tensors, and the version the CUDA
    kernel is held against).  M (B,n,n); q/l/u/z0 (B,n); tau (B,)."""
    t = tau[:, None]
    z = z0.clone()
    for _ in range(steps):
        z = eg_step(M, q, l, u, z, t)
    return z


EGEngine = Callable[..., torch.Tensor]


def eg_engine(device: torch.device) -> EGEngine:
    """The step loop ``CONFIG.eg_kernel`` selects for tensors on ``device``:
    "auto" takes the CUDA kernel for CUDA tensors and the plain loop for CPU
    tensors."""
    mode = CONFIG.eg_kernel
    if mode == "torch" or (mode == "auto" and device.type == "cpu"):
        return eg_steps_torch
    if mode in ("auto", "cuda"):
        from .eg_cuda import eg_warmstart_cuda
        return eg_warmstart_cuda
    raise ValueError(f"unknown CONFIG.eg_kernel {mode!r} "
                     "(expected 'auto', 'cuda' or 'torch')")


def eg_warmstart(M, q, l, u, z0, var_mask, steps: int = 200,
                 engine: EGEngine | None = None) -> torch.Tensor:
    """Run ``steps`` fused f32 extragradient iterations on each box AVI of
    the batch; returns improved starting points (f64, original scale,
    masked variables 0).  ``engine`` defaults to :func:`eg_engine`'s pick."""
    p = eg_prepare(M, q, l, u, z0, var_mask)
    run = engine or eg_engine(p.M.device)
    z = run(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    return torch.where(p.mask, z.double() * p.e, 0.0)
