"""The cluster instances of K1 (``csrc/lemke_lane.cuh``) and K2
(``csrc/eg_lane.cuh``), through their host emulation.

A lane that does not fit one block's shared memory is spread over a cluster
of R blocks: rank k holds a band of the lane's rows, and the phases read
across ranks.  The g++ host build carves R buffers as the card's blocks are
carved and runs each phase for rank 0, 1, ..., R-1 in turn between the
points where the card's ranks meet at the cluster's barrier.  Each rank's
sums walk the same order as one block's, so the emulation at any R gives
the bits of the host instance at R = 1 (the shared and global instances'
lane code): status, pivots, basis, nonbasic values and basic values for
K1, z for K2.  At R = 2, K1 also lands where the JAX package's KKT solve
does on the same numpy inputs.

Lanes: a few of robust_avoid's ensembles at num_obj=2, seed 0 (T=4, 5: n =
152, 190 for K1 in f32 at the hot route's tolerances and n = 152 in f64 at
the re-pivot's; T=8: n = 304 for K2, 300 steps).
"""

import functools

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, lemke_cuda
from qpn_tpu_torch.utils.cuda_build import HOPPER_SMEM_OPTIN

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
JAX_Z_TOL = 1e-8
PICKED = None              # the ranks the launcher picks at an H100's limit


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@functools.lru_cache(maxsize=None)
def _ensemble(S, T):
    return scenario_batch_gavis(num_scenarios=S, T=T, num_obj=2,
                                num_poly_faces=4, seed=0)


def _k1_init(T, dtype, kw, S=4):
    b = _ensemble(S, T)
    M, q, l, u, z0 = (torch.as_tensor(b[k]).to(dtype) for k in
                      ("M", "q", "l", "u", "z0"))
    return lemke.lemke_setup(M, q, l, u, z0, torch.as_tensor(b["mask"]),
                             tol=kw["tol"])


@pytest.mark.parametrize("ranks", [2, 3, PICKED], ids=["R2", "R3", "picked"])
@pytest.mark.parametrize("T,n,dtype,kw", [
    (4, 152, torch.float32, HOT), (5, 190, torch.float32, HOT),
    (4, 152, torch.float64, F64)], ids=["f32_n152", "f32_n190", "f64_n152"])
def test_k1_cluster_emulation_gives_the_host_instance_bits(T, n, dtype, kw,
                                                           ranks):
    init = _k1_init(T, dtype, kw)
    itemsize = init.T.element_size()
    assert init.T.shape[1] == n
    assert lemke_cuda.host_lane_instance(
        n, itemsize, HOPPER_SMEM_OPTIN) == lemke_cuda.LANE_CLUSTER
    one = lemke_cuda.lemke_pivot_host(init, ranks=1, **kw)
    spread = lemke_cuda.lemke_pivot_host(init, ranks=ranks, **kw)
    assert (one.status == lemke.LEMKE_SUCCESS).all()
    for name in one._fields:
        assert torch.equal(getattr(spread, name), getattr(one, name)), name


def test_k1_cluster_emulation_matches_the_jax_package():
    """The f32 pivot path of the KKT route (``avi.solve_kkt_avi_batch``'s
    setup, tolerances and pivot budget) at R = 2, then the f64
    refactorization, against the JAX package's KKT solve at S=8, n=190:
    status and pivot counts lane for lane, z within 1e-8 (bases are never
    compared)."""
    from qpn_tpu.ops import avi as ref_avi
    b = _ensemble(8, 5)
    ref = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                      b["mask"], b["structure"], tol=1e-8)
    M, q, l, u = (torch.as_tensor(b[k]) for k in ("M", "q", "l", "u"))
    vm = torch.as_tensor(b["mask"])
    B, n = q.shape
    assert n == 190
    assert lemke_cuda.host_cluster_ranks(n, 4, HOPPER_SMEM_OPTIN) == 2
    max_pivots = 256
    while max_pivots < min(4096, 16 * n + 256):
        max_pivots *= 2
    f32 = torch.float32
    _, status, piv, basis, val = lemke.solve_lemke_batch_state(
        M.to(f32), q.to(f32), l.to(f32), u.to(f32), torch.zeros(B, n,
                                                                 dtype=f32),
        vm, pivot=functools.partial(lemke_cuda.lemke_pivot_host, ranks=2),
        tol=1e-6, piv_tol=1e-5, max_pivots=max_pivots)
    z, ok = lemke.refactor_batch(M, q, l, u, basis, val, vm)
    assert bool(np.all(np.asarray(ref.converged)))
    assert (status == lemke.LEMKE_SUCCESS).all() and bool(ok.all())
    np.testing.assert_array_equal(piv.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=JAX_Z_TOL)


@pytest.mark.parametrize("ranks", [2, 3, PICKED], ids=["R2", "R3", "picked"])
def test_k2_cluster_emulation_gives_the_host_instance_bits(ranks):
    b = _ensemble(2, 8)
    p = eg.eg_prepare(*(torch.as_tensor(b[k]) for k in
                        ("M", "q", "l", "u", "z0", "mask")))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    n = p.M.shape[1]
    assert n == 304
    assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == eg_cuda.EG_CLUSTER
    one = eg_cuda.eg_steps_host(*ins, 300, ranks=1)
    assert bool(torch.isfinite(one).all())
    assert torch.equal(eg_cuda.eg_steps_host(*ins, 300, ranks=ranks), one)


def test_a_lane_needs_at_least_one_rank():
    init = _k1_init(4, torch.float32, HOT, S=1)
    with pytest.raises(ValueError, match="ranks"):
        lemke_cuda.lemke_pivot_host(init, ranks=0, **HOT)
    p = eg.eg_prepare(*(torch.as_tensor(a) for a in
                        (np.eye(3)[None], np.ones((1, 3)), np.zeros((1, 3)),
                         np.ones((1, 3)), np.zeros((1, 3)))),
                      torch.ones(1, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="ranks"):
        eg_cuda.eg_steps_host(p.M, p.q, p.l, p.u, p.z0, p.tau, 1, ranks=0)
