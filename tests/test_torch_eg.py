"""Parity of the port's extragradient warm start (qpn_tpu_torch/ops/eg.py,
and the CUDA kernel's lane code built for the host) with the JAX package's
Pallas kernel (qpn_tpu/ops/pallas_kernels.py::eg_warmstart, in interpret
mode on the CPU, as tests/test_pallas.py runs it).

The same numpy inputs go through both packages.  Tolerance on z: 1e-5
relative to the lane scale after at most 300 steps.  Both sides step in
f32, but they sum each matvec in another order (XLA's dot on a lane padded
to 128, PyTorch's bmm, the kernel's column-order loop), so they differ by a
few f32 ulps per step; extragradient contracts, so those differences stay
near 1e-6 of the scale (measured: 3e-6 at scale 5.7 on the flagship lanes).
"""

import numpy as np
import pytest
import torch

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import pallas_kernels as pk

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import eg
from qpn_tpu_torch.ops.eg_cuda import eg_steps_host, eg_warmstart_cuda

Z_RTOL = 1e-5


def _lcp():
    return (np.eye(2)[None], np.array([[-1.0, 2.0]]), np.zeros((1, 2)),
            np.full((1, 2), np.inf), np.zeros((1, 2)),
            np.ones((1, 2), dtype=bool))


def _masked_vars():
    return (np.eye(3)[None], np.array([[-1.0, 2.0, 5.0]]), np.zeros((1, 3)),
            np.full((1, 3), np.inf), np.zeros((1, 3)),
            np.array([[True, True, False]]))


def _flagship():
    b = scenario_batch_gavis(num_scenarios=8, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    return tuple(b[k] for k in ("M", "q", "l", "u", "z0", "mask"))


# the cases of tests/test_pallas.py (with the pinned masked variable), and
# the flagship ensemble's shape (n=38) at S=8
CASES = [("lcp", _lcp), ("masked_vars", _masked_vars),
         ("flagship_S8", _flagship)]


def _tensors(problem):
    return [torch.as_tensor(a) for a in problem]


def _host_engine(M, q, l, u, z0, tau, steps):
    return eg_steps_host(M, q, l, u, z0, tau, steps)


@pytest.mark.parametrize("engine", [eg.eg_steps_torch, _host_engine],
                         ids=["plain", "kernel_lane_host"])
@pytest.mark.parametrize("name,build", CASES, ids=[c[0] for c in CASES])
def test_eg_warmstart_matches_reference(name, build, engine):
    problem = build()
    ref = pk.eg_warmstart(*problem, steps=300)
    z = eg.eg_warmstart(*_tensors(problem), steps=300, engine=engine)
    assert z.dtype == torch.float64 and z.shape == ref.shape
    scale = 1.0 + np.abs(ref).max()
    np.testing.assert_allclose(z.numpy(), ref, rtol=0, atol=Z_RTOL * scale)
    mask = problem[5]
    assert (z.numpy()[~mask] == 0.0).all()


def test_eg_prepare_matches_reference(monkeypatch):
    """The scaled, masked f32 inputs and the step size are those the JAX
    package hands its kernel, including τ from ‖M‖∞ over the lane padded
    to 128 (never below 1 at n=38)."""
    captured = {}

    def capture(M, q, l, u, z0, tau, *, steps):
        captured.update(M=M, q=q, l=l, u=u, z0=z0, tau=tau)
        return z0

    monkeypatch.setattr(pk, "_eg_call", capture)
    problem = _flagship()
    problem[5][:, -2:] = False                    # two masked variables
    pk.eg_warmstart(*problem, steps=1)
    p = eg.eg_prepare(*_tensors(problem))
    B, n = problem[1].shape
    big = np.float32(3e38)
    np.testing.assert_allclose(p.M.numpy(), captured["M"][:B, :n, :n],
                               rtol=1e-6, atol=0)
    for name in ("q", "z0"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   captured[name][:B, :n], rtol=1e-6, atol=0)
    for name, inf in (("l", -np.inf), ("u", np.inf)):
        ref = captured[name][:B, :n]
        ref = np.where(np.abs(ref) == big, inf, ref)
        np.testing.assert_allclose(getattr(p, name).numpy(), ref, rtol=1e-6,
                                   atol=0)
    np.testing.assert_allclose(p.tau.numpy(), captured["tau"][:B, 0],
                               rtol=1e-6, atol=0)
    assert (p.tau <= 0.45).all()


@pytest.mark.parametrize("steps", [0, 1, 7, 300])
def test_kernel_lane_host_matches_plain_loop(steps):
    """The kernel's lane code (g++ build) against the plain loop on the same
    prepared inputs, step for step."""
    p = eg.eg_prepare(*_tensors(_flagship()))
    zh = eg_steps_host(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    zp = eg.eg_steps_torch(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    if steps == 0:
        assert torch.equal(zh, p.z0)
    scale = 1.0 + float(zp.abs().max())
    assert float((zh - zp).abs().max()) <= Z_RTOL * scale


def test_eg_warmstart_examples():
    """tests/test_pallas.py's expectations, on the port."""
    z = eg.eg_warmstart(*_tensors(_lcp()), steps=300)
    assert np.allclose(z[0].numpy(), [1.0, 0.0], atol=1e-2)
    z = eg.eg_warmstart(*_tensors(_masked_vars()), steps=300)
    assert float(z[0, 2]) == 0.0


def test_nan_lane_stays_nan():
    """A diverged lane stays NaN (like torch.clamp and jnp.clip), so the
    caller's residual audit rejects it, in both engines."""
    p = eg.eg_prepare(*_tensors(_lcp()))
    z0 = torch.tensor([[float("nan"), 0.0]], dtype=torch.float32)
    for run in (eg.eg_steps_torch, eg_steps_host):
        z = run(p.M, p.q, p.l, p.u, z0, p.tau, 3)
        assert torch.isnan(z[0, 0])


def test_engine_selection():
    cpu = torch.device("cpu")
    old = CONFIG.eg_kernel
    try:
        assert eg.eg_engine(cpu) is eg.eg_steps_torch
        CONFIG.eg_kernel = "torch"
        assert eg.eg_engine(torch.device("cuda")) is eg.eg_steps_torch
        CONFIG.eg_kernel = "cuda"
        assert eg.eg_engine(cpu) is eg_warmstart_cuda
        CONFIG.eg_kernel = "pallas"
        with pytest.raises(ValueError, match="eg_kernel"):
            eg.eg_engine(cpu)
    finally:
        CONFIG.eg_kernel = old


def test_cuda_wrapper_takes_cuda_tensors_only():
    p = eg.eg_prepare(*_tensors(_lcp()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        eg_warmstart_cuda(p.M, p.q, p.l, p.u, p.z0, p.tau, 10)


def test_wrapper_checks_dtype_and_shape():
    p = eg.eg_prepare(*_tensors(_lcp()))
    with pytest.raises(TypeError, match="float32"):
        eg_steps_host(p.M.double(), p.q, p.l, p.u, p.z0, p.tau, 1)
    with pytest.raises(ValueError, match="tau shape"):
        eg_steps_host(p.M, p.q, p.l, p.u, p.z0, p.tau[:, None], 1)
