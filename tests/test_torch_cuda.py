"""Tests of the port that need a CUDA device (marked ``gpu``; they skip
without one).  This file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX, where the repository's conftest (which
imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import lemke
from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_kkt_avi_batch
from qpn_tpu_torch.ops.lemke_cuda import KERNEL, lemke_pivot_cuda
from qpn_tpu_torch.utils.metrics import METRICS

HOT = dict(tol=1e-6, piv_tol=1e-5)
F64 = dict(tol=1e-11, piv_tol=1e-11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _data(device, S=64, seed=0):
    b = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                             num_poly_faces=4, seed=seed)
    return batch_from_numpy(b, device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kw", [(torch.float32, HOT),
                                      (torch.float64, F64)],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_loop(cuda_device, dtype, kw):
    """Kernel and plain loop from one setup: identical status, pivot counts
    and terminal nonbasic values; one counted launch."""
    t = _data(cuda_device)
    init = lemke.lemke_setup(*(t[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=kw["tol"])
    before = METRICS.launches[KERNEL]
    rk = lemke_pivot_cuda(init, max_pivots=1024, **kw)
    torch.cuda.synchronize()
    assert METRICS.launches[KERNEL] == before + 1
    rp = lemke.lemke_pivot_torch(init, max_pivots=1024, **kw)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    assert (rk.status == lemke.LEMKE_SUCCESS).all()
    z, ok = lemke.refactor_batch(t["M"], t["q"], t["l"], t["u"], rk.basis,
                                 rk.val, t["mask"])
    assert bool(ok.all())


@pytest.mark.gpu
@pytest.mark.parametrize("max_pivots", [4, 8])
def test_kernel_pivot_budget(cuda_device, max_pivots):
    t = _data(cuda_device, S=16)
    init = lemke.lemke_setup(*(t[k].float() for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=HOT["tol"])
    rk = lemke_pivot_cuda(init, max_pivots=max_pivots, **HOT)
    rp = lemke.lemke_pivot_torch(init, max_pivots=max_pivots, **HOT)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    assert (rk.status == lemke.LEMKE_MAX).all()


@pytest.mark.gpu
def test_main_path_goes_through_the_kernel(cuda_device):
    t = _data(cuda_device, S=32, seed=1)
    METRICS.reset()
    res = solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"], t["mask"],
                              t["structure"], tol=1e-8)
    assert METRICS.launches[KERNEL] >= 1
    assert bool(res.converged.all())
    assert float(res.resid.max()) <= 1e-8
    assert res.z.device.type == "cuda"


@pytest.mark.gpu
def test_kernel_rejects_a_lane_too_large_for_shared_memory(cuda_device):
    n = 140                                   # f32 lane of ~246 KB
    M = torch.eye(n, device=cuda_device)[None]
    q = -torch.ones(1, n, device=cuda_device)
    zeros = torch.zeros(1, n, device=cuda_device)
    init = lemke.lemke_setup(M, q, zeros, torch.full_like(zeros, 1.0), zeros,
                             torch.ones(1, n, dtype=torch.bool,
                                        device=cuda_device), tol=1e-6)
    with pytest.raises(ValueError, match="shared memory"):
        lemke_pivot_cuda(init, max_pivots=16, **HOT)
