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
from qpn_tpu_torch.ops import eg, eg_cuda
from qpn_tpu_torch.ops.eg_cuda import (eg_steps_host, eg_warmstart_cuda,
                                       host_cluster_chunk, host_pick_chunk)
from qpn_tpu_torch.utils.cuda_build import HOPPER_SMEM_OPTIN
from qpn_tpu_torch.utils.metrics import METRICS

Z_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


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


def _box_avi(n, seed, B=4):
    """Seeded monotone box AVIs: PSD M, mixed finite and missing bounds."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    return M, q, l, u, np.zeros((B, n)), np.ones((B, n), dtype=bool)


# one n for each kernel the launcher can pick: the register kernel's four
# chunk lengths (4, 10, 16 and 32 columns a thread), and the block
# instance's chunks of 36 and 48 columns (n = 190: cell 5's lanes)
PARTITION_N = [5, 38, 50, 70, 130, 190]


@pytest.mark.parametrize("steps", [0, 1, 7, 300])
@pytest.mark.parametrize("n", PARTITION_N)
def test_kernel_partitions_match_plain_loop(n, steps):
    """The lane code under each partition of a row's sum that the launcher
    can pick (the register kernel's chunks and butterfly; the block
    instance's longer chunks) against the plain loop on the same prepared
    inputs.  Both step in f32 and differ only in the order of each sum, a
    few ulps a step, and the iteration contracts: within 1e-5 of the lane
    scale."""
    p = eg.eg_prepare(*_tensors(_box_avi(n, seed=n)))
    zh = eg_steps_host(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    zp = eg.eg_steps_torch(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    if steps == 0:
        assert torch.equal(zh, p.z0)
    scale = 1.0 + float(zp.abs().max())
    assert float((zh - zp).abs().max()) <= Z_RTOL * scale


@pytest.mark.parametrize("n", PARTITION_N)
def test_kernel_partitions_match_pallas_reference(n):
    """The same lane code against the JAX package's Pallas kernel (interpret
    mode) from the unprepared problem, 300 steps, same bound."""
    problem = _box_avi(n, seed=100 + n)
    ref = pk.eg_warmstart(*problem, steps=300)
    z = eg.eg_warmstart(*_tensors(problem), steps=300, engine=eg_steps_host)
    scale = 1.0 + np.abs(ref).max()
    np.testing.assert_allclose(z.numpy(), ref, rtol=0, atol=Z_RTOL * scale)


def _row_sums(M, x, chunk):
    """(M x) in f32 with each row's sum in the kernel's order: four chunks of
    ``chunk`` columns, each from 0 in column order, joined by the butterfly
    (p0 + p2) + (p1 + p3)."""
    f = np.float32
    B, n, _ = M.shape
    out = np.zeros((B, n), dtype=f)
    for b in range(B):
        for i in range(n):
            part = []
            for g in range(4):
                acc = f(0)
                for j in range(g * chunk, min((g + 1) * chunk, n)):
                    acc = f(acc + f(M[b, i, j] * x[b, j]))
                part.append(acc)
            out[b, i] = f(f(part[0] + part[2]) + f(part[1] + part[3]))
    return out


@pytest.mark.parametrize("n,chunk", [(16, 4), (38, 10), (64, 16), (128, 32),
                                     (129, 0), (190, 0), (238, 0)])
def test_partition_the_launcher_picks(n, chunk):
    """The launcher's pick from n: rows split over 4 threads in the
    register kernel up to n = 128 (10 columns a thread at the flagship
    n = 38); beyond that no register instance (0: the hop kernel shares
    that pick) and the block instance's four chunks of
    ``host_cluster_chunk(n)`` columns (36 at n = 129, 48 at 190, 60 at
    238).  One step of the host lane code gives the bits of that order
    spelled out in numpy."""
    assert host_pick_chunk(n) == chunk
    if chunk == 0:
        chunk = host_cluster_chunk(n)
        assert chunk == {129: 36, 190: 48, 238: 60}[n]
    p = eg.eg_prepare(*_tensors(_box_avi(n, seed=n, B=2)))
    inf = torch.full_like(p.q, float("inf"))
    z1 = eg_steps_host(p.M, p.q, -inf, inf, p.z0 + 1, p.tau, 1).numpy()
    f = np.float32
    M, q, tau = p.M.numpy(), p.q.numpy(), p.tau.numpy()[:, None]
    z = (p.z0 + 1).numpy()
    zh = (z - tau * (_row_sums(M, z, chunk) + q).astype(f)).astype(f)
    want = (z - tau * (_row_sums(M, zh, chunk) + q).astype(f)).astype(f)
    np.testing.assert_array_equal(z1, want)


@pytest.mark.parametrize("n", [5, 130], ids=["register", "generic"])
def test_nan_lane_stays_nan_in_every_partition(n):
    p = eg.eg_prepare(*_tensors(_box_avi(n, seed=9)))
    z0 = p.z0.clone()
    z0[1, 2] = float("nan")
    z = eg_steps_host(p.M, p.q, p.l, p.u, z0, p.tau, 4)
    assert torch.isnan(z[1]).any() and not torch.isnan(z[0]).any()


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


@pytest.mark.parametrize("n,block", [(38, False), (190, True)],
                         ids=["register", "block"])
def test_launch_counts_its_lanes(monkeypatch, n, block):
    """A K2 launch adds its lanes to ``eg_lanes``, and a launch of the block
    instance to ``eg_block_lanes`` too, as plain numbers (no read of the
    device).  No card here: the launch is mocked, the inputs' device check
    skipped, and the pick is the header's built for the host at an H100's
    limit."""
    p = eg.eg_prepare(*_tensors(_box_avi(n, seed=1, B=3)))
    launched = []
    monkeypatch.setattr(eg_cuda, "_INPUTS", lambda *a, **k: None)
    monkeypatch.setattr(eg_cuda, "card_instance", lambda n, device, lanes=1: (
        eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN), 1))
    monkeypatch.setattr(eg_cuda.LIB, "cuda", eg_cuda.LIB.host)
    monkeypatch.setattr(eg_cuda.LIB, "launch",
                        lambda counted, *args: launched.append(counted))
    METRICS.reset()
    eg_cuda._launch(p.M, p.q, p.l, p.u, p.z0, p.tau, 5)
    eg_cuda._launch(p.M[:2], p.q[:2], p.l[:2], p.u[:2], p.z0[:2], p.tau[:2],
                    5)
    assert launched == [eg_cuda.KERNEL] * 2
    counters = METRICS.counters
    assert counters[eg_cuda.LANES] == 5
    assert counters[eg_cuda.BLOCK_LANES] == (5 if block else 0)


def test_wrapper_checks_dtype_and_shape():
    p = eg.eg_prepare(*_tensors(_lcp()))
    with pytest.raises(TypeError, match="float32"):
        eg_steps_host(p.M.double(), p.q, p.l, p.u, p.z0, p.tau, 1)
    with pytest.raises(ValueError, match="tau shape"):
        eg_steps_host(p.M, p.q, p.l, p.u, p.z0, p.tau[:, None], 1)
