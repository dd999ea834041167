"""Tests of the port that need a CUDA device (marked ``gpu``; they skip
without one).  This file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX, where the repository's conftest (which
imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from qpn_tpu_torch.config import CONFIG, banded_min_blocks
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, screen, screen_cuda
from qpn_tpu_torch.ops.avi import (batch_from_numpy, solve_avi_batch_adaptive,
                                   solve_kkt_avi_batch)
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
def test_solve_lemke_batch_launches_k1(cuda_device, monkeypatch):
    """The public solve_lemke_batch on numpy inputs runs on the card (the
    default device) through K1: one launch a call, the plain loop's status
    and pivot counts."""
    monkeypatch.setattr(CONFIG, "device", "cuda")
    b = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    args = [b[k] for k in ("M", "q", "l", "u", "z0", "mask")]
    for call in range(2):
        before = METRICS.launches[KERNEL]
        res = lemke.solve_lemke_batch(*args)
        torch.cuda.synchronize()
        assert METRICS.launches[KERNEL] == before + 1
        assert res.z.device.type == "cuda"
    t = [torch.from_numpy(a) for a in args]
    plain = lemke.solve_lemke_batch(*t)
    assert torch.equal(res.status.cpu(), plain.status)
    assert torch.equal(res.pivots.cpu(), plain.pivots)


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
@pytest.mark.parametrize("dtype,kw", [(torch.float32, HOT),
                                      (torch.float64, F64)],
                         ids=["f32", "f64"])
def test_kernel_takes_a_lane_too_large_for_shared_memory(cuda_device, dtype,
                                                         kw):
    """robust_avoid lanes of n=152 (T=4, num_obj=2: 0.47 MB of working set
    in f64, 0.29 MB in f32) run in the kernel's cluster instance: one launch
    counted under its own name, the plain loop's status and pivot counts,
    and the bits of the host emulation of its ranks."""
    from qpn_tpu_torch.ops.lemke_cuda import (KERNEL_CLUSTER, KERNEL_GLOBAL,
                                              card_optin, lemke_pivot_host)
    b = scenario_batch_gavis(num_scenarios=8, T=4, num_obj=2,
                             num_poly_faces=4, seed=0)
    t = batch_from_numpy(b, cuda_device)
    init = lemke.lemke_setup(*(t[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=kw["tol"])
    METRICS.reset()
    rk = lemke_pivot_cuda(init, max_pivots=1024, **kw)
    torch.cuda.synchronize()
    assert METRICS.launches[KERNEL_CLUSTER] == 1
    assert METRICS.launches[KERNEL] == 0
    assert METRICS.launches[KERNEL_GLOBAL] == 0
    rp = lemke.lemke_pivot_torch(init, max_pivots=1024, **kw)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    assert (rk.status == lemke.LEMKE_SUCCESS).all()
    rh = lemke_pivot_host(lemke.LemkeInit(*(a.cpu() for a in init)),
                          max_pivots=1024, optin=card_optin(cuda_device),
                          **kw)
    for name in ("status", "piv", "basis", "val", "xB"):
        assert torch.equal(getattr(rk, name).cpu(), getattr(rh, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("source,n,dtype,kw", [
    ("box", 136, torch.float32, HOT), (4, 152, torch.float32, HOT),
    (5, 190, torch.float32, HOT), ("ra95", 95, torch.float64, F64),
    (4, 152, torch.float64, F64)],
    ids=["f32_n136", "f32_n152", "f32_n190", "f64_n95", "f64_n152"])
def test_k1_cluster_fused_loop_gives_the_shared_instance_bits(
        cuda_device, source, n, dtype, kw):
    """K1's cluster instance (one pass over its band a pivot, each rank's
    least ratio published) at the first n of its domain in f32 and f64 and
    at phase 20's: status, pivots, basis, values and basic values equal to
    the g++ host instance at R = 1 (the shared instance's phases apart) on
    8 lanes, bit for bit."""
    from qpn_tpu_torch.ops import lemke_cuda
    if source == "box":
        rng = np.random.default_rng(136)
        A = rng.standard_normal((8, n, n)) / np.sqrt(n)
        M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
        arrays = (M, rng.standard_normal((8, n)),
                  np.where(rng.random((8, n)) < 0.5, 0.0, -np.inf),
                  np.where(rng.random((8, n)) < 0.3, 1.0, np.inf),
                  np.zeros((8, n)))
        t = dict(zip(("M", "q", "l", "u", "z0"),
                     (torch.as_tensor(a, device=cuda_device)
                      for a in arrays)))
        t["mask"] = torch.ones(8, n, dtype=torch.bool, device=cuda_device)
    else:
        T, num_obj = (5, 1) if source == "ra95" else (source, 2)
        t = batch_from_numpy(scenario_batch_gavis(
            num_scenarios=8, T=T, num_obj=num_obj, num_poly_faces=4,
            seed=0), cuda_device)
    init = lemke.lemke_setup(*(t[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=kw["tol"])
    assert init.T.shape[1] == n
    assert lemke_cuda.card_instance(n, init.T.element_size(),
                                    cuda_device)[0] == lemke_cuda.LANE_CLUSTER
    rk = lemke_pivot_cuda(init, max_pivots=1024, **kw)
    torch.cuda.synchronize()
    rh = lemke_cuda.lemke_pivot_host(
        lemke.LemkeInit(*(a.cpu() for a in init)), max_pivots=1024,
        ranks=1, **kw)
    assert (rh.status == lemke.LEMKE_SUCCESS).all()
    for name in rk._fields:
        assert torch.equal(getattr(rk, name).cpu(), getattr(rh, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("T,dtype,kw,lanes", [
    (4, torch.float32, HOT, 256), (5, torch.float32, HOT, 256),
    (4, torch.float64, F64, 16)], ids=["f32_n152", "f32_n190", "f64_n152"])
def test_cluster_instance_against_plain_loop_host_and_global(
        cuda_device, T, dtype, kw, lanes):
    """K1's cluster instance on phase 20's lanes: the plain loop's status
    and pivot counts, the bits of the host emulation of its ranks on 8
    lanes, and the bits of the global instance (the private launcher) on
    all of them."""
    from qpn_tpu_torch.ops import lemke_cuda
    b = scenario_batch_gavis(num_scenarios=lanes, T=T, num_obj=2,
                             num_poly_faces=4, seed=0)
    t = batch_from_numpy(b, cuda_device)
    init = lemke.lemke_setup(*(t[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=kw["tol"])
    n = init.T.shape[1]
    instance, ranks = lemke_cuda.card_instance(n, init.T.element_size(),
                                               cuda_device)
    assert instance == lemke_cuda.LANE_CLUSTER and ranks >= 2
    rk = lemke_pivot_cuda(init, max_pivots=1024, **kw)
    rg = lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL,
                            max_pivots=1024, **kw)
    torch.cuda.synchronize()
    rp = lemke.lemke_pivot_torch(init, max_pivots=1024, **kw)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    for name in rk._fields:
        assert torch.equal(getattr(rk, name), getattr(rg, name)), name
    rh = lemke_cuda.lemke_pivot_host(
        lemke.LemkeInit(*(a[:8].cpu() for a in init)), max_pivots=1024,
        ranks=ranks, **kw)
    for name in rk._fields:
        assert torch.equal(getattr(rk, name)[:8].cpu(),
                           getattr(rh, name)), name


@pytest.mark.gpu
def test_a_refused_cluster_launch_raises(cuda_device):
    """A cluster of 16 blocks is past the portable size the kernels do not
    opt out of: the card refuses the launch and the three wrappers raise
    with CUDA's message, without running another instance."""
    from qpn_tpu_torch.ops import lemke_cuda
    t = _data(cuda_device, S=4)
    init = lemke.lemke_setup(*(t[k].float() for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=HOT["tol"])
    METRICS.reset()
    with pytest.raises(RuntimeError, match="launch failed"):
        lemke_cuda._launch(init, instance=lemke_cuda.LANE_CLUSTER, ranks=16,
                           max_pivots=64, **HOT)
    p = _eg_random(cuda_device, 304, B=2)
    with pytest.raises(RuntimeError, match="launch failed"):
        eg_cuda._launch(p.M, p.q, p.l, p.u, p.z0, p.tau, 10,
                        instance=eg_cuda.EG_CLUSTER, ranks=16)
    polys, _ = _screen_polys(4, 260, 240, seed=4)
    ins = [torch.as_tensor(a, device=cuda_device)
           for a in screen.screen_prepare(polys)]
    with pytest.raises(RuntimeError, match="launch failed"):
        screen_cuda._launch_cluster(*ins, 10, 0.05, ranks=16)
    torch.cuda.synchronize()
    assert sum(METRICS.launches.values()) == 0
    # the refusal leaves no error behind for the next launches to report
    lemke_pivot_cuda(init, max_pivots=64, **HOT)
    eg_cuda.eg_warmstart_cuda(p.M, p.q, p.l, p.u, p.z0, p.tau, 10)
    screen_cuda.feasibility_screen_cuda(*ins, 10, 0.05)
    torch.cuda.synchronize()
    assert METRICS.launches[KERNEL] == 1
    assert METRICS.launches[eg_cuda.KERNEL_CLUSTER] == 1
    assert METRICS.launches[screen_cuda.KERNEL_CLUSTER] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [None, 3], ids=["picked", "R3"])
def test_k1_spread_global_instance_against_one_block_and_host(cuda_device,
                                                              ranks):
    """K1's global instance on (g)'s lanes, f64 at n=304 (robust_avoid T=8,
    num_obj=2) on 16 lanes, spread over the ranks the wrapper picks (8 on an
    H100; also 3 through the private launcher): bit for bit the global
    instance at R = 1 (the private launcher), the plain loop's status and
    pivots, and the host emulation of the same ranks on 4 lanes."""
    from qpn_tpu_torch.ops import lemke_cuda
    b = scenario_batch_gavis(num_scenarios=16, T=8, num_obj=2,
                             num_poly_faces=4, seed=0)
    t = batch_from_numpy(b, cuda_device)
    init = lemke.lemke_setup(*(t[k].double() for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=F64["tol"])
    n = init.T.shape[1]
    instance, picked = lemke_cuda.card_instance(n, 8, cuda_device, lanes=16)
    assert n == 304 and instance == lemke_cuda.LANE_GLOBAL and picked > 1
    METRICS.reset()
    if ranks is None:
        ranks = picked
        rk = lemke_pivot_cuda(init, max_pivots=1024, **F64)
    else:
        rk = lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL,
                                ranks=ranks, max_pivots=1024, **F64)
    torch.cuda.synchronize()
    assert METRICS.launches[lemke_cuda.KERNEL_GLOBAL] == 1
    assert METRICS.counters[lemke_cuda.GLOBAL_RANKS] == ranks
    r1 = lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL, ranks=1,
                            max_pivots=1024, **F64)
    torch.cuda.synchronize()
    for name in rk._fields:
        assert torch.equal(getattr(rk, name), getattr(r1, name)), name
    rp = lemke.lemke_pivot_torch(init, max_pivots=1024, **F64)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    assert (rk.status == lemke.LEMKE_SUCCESS).all()
    rh = lemke_cuda.lemke_pivot_host(
        lemke.LemkeInit(*(a[:4].cpu() for a in init)), max_pivots=1024,
        optin=lemke_cuda.card_optin(cuda_device), ranks=ranks, **F64)
    for name in rk._fields:
        assert torch.equal(getattr(rk, name)[:4].cpu(),
                           getattr(rh, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [None, 4], ids=["picked", "R4_in_place"])
def test_k2_spread_global_instance_against_one_block_and_host(cuda_device,
                                                              ranks):
    """K2's global instance on (h)'s shape, n=684 on 4 lanes, 300 steps,
    spread over the ranks the wrapper picks (9 on an H100, each band of M
    in shared memory; also 4 through the private launcher, the bands read
    in place): bit for bit the global instance at R = 1 and the host
    emulation of the same ranks, the plain loop within 1e-5 of the lane
    scale."""
    p = _eg_random(cuda_device, 684, B=4, seed=684)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    optin = eg_cuda.card_optin(cuda_device)
    instance, picked = eg_cuda.card_instance(684, cuda_device, lanes=4)
    assert instance == eg_cuda.EG_GLOBAL and picked > 1
    METRICS.reset()
    if ranks is None:
        ranks = picked
        assert eg_cuda.host_global_band_fits(684, ranks, optin)
        zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    else:
        assert not eg_cuda.host_global_band_fits(684, ranks, optin)
        zk = eg_cuda._launch(*ins, 300, instance=eg_cuda.EG_GLOBAL,
                             ranks=ranks)
    torch.cuda.synchronize()
    assert METRICS.launches[eg_cuda.KERNEL_GLOBAL] == 1
    assert METRICS.counters[eg_cuda.GLOBAL_RANKS] == ranks
    z1 = eg_cuda._launch(*ins, 300, instance=eg_cuda.EG_GLOBAL, ranks=1)
    torch.cuda.synchronize()
    assert torch.equal(zk, z1)
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300, optin=optin,
                               ranks=ranks)
    assert torch.equal(zk.cpu(), zh)
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_k2_global_instance_on_a_full_batch(cuda_device):
    """K2's global instance at n=684 on 67 lanes, which fill an H100 (R =
    1, one block a lane reading M from its column-major copy): 300 steps
    bit for bit the host emulation of one block a lane on 4 lanes, the
    plain loop within 1e-5 of the lane scale."""
    p = _eg_random(cuda_device, 684, B=67, seed=685)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    assert eg_cuda.card_instance(684, cuda_device, lanes=67) == (
        eg_cuda.EG_GLOBAL, 1)
    METRICS.reset()
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    torch.cuda.synchronize()
    assert METRICS.launches[eg_cuda.KERNEL_GLOBAL] == 1
    assert METRICS.counters[eg_cuda.GLOBAL_RANKS] == 1
    zh = eg_cuda.eg_steps_host(*(a[:4].cpu() for a in ins), 300,
                               optin=eg_cuda.card_optin(cuda_device),
                               ranks=1)
    assert torch.equal(zk[:4].cpu(), zh)
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_a_refused_cooperative_launch_raises(cuda_device):
    """A spread global lane of 4096 blocks does not fit the card at once:
    the card refuses the cooperative launch and both wrappers raise with
    CUDA's message, without running another instance or a smaller grid;
    the next launches work."""
    from qpn_tpu_torch.ops import lemke_cuda
    t = _data(cuda_device, S=4)
    init = lemke.lemke_setup(*(t[k].float() for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=HOT["tol"])
    METRICS.reset()
    # cudaGetErrorString(cudaErrorCooperativeLaunchTooLarge)
    refusal = "launch failed: too many blocks in cooperative launch"
    with pytest.raises(RuntimeError, match=refusal):
        lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL,
                           ranks=4096, max_pivots=64, **HOT)
    p = _eg_random(cuda_device, 304, B=2)
    with pytest.raises(RuntimeError, match=refusal):
        eg_cuda._launch(p.M, p.q, p.l, p.u, p.z0, p.tau, 10,
                        instance=eg_cuda.EG_GLOBAL, ranks=4096)
    torch.cuda.synchronize()
    assert sum(METRICS.launches.values()) == 0
    # the refusal leaves no error behind for the next launches to report
    lemke_pivot_cuda(init, max_pivots=64, **HOT)
    eg_cuda.eg_warmstart_cuda(p.M, p.q, p.l, p.u, p.z0, p.tau, 10)
    torch.cuda.synchronize()
    assert METRICS.launches[KERNEL] == 1
    assert METRICS.launches[eg_cuda.KERNEL_CLUSTER] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("dtype,kw", [(torch.float32, HOT),
                                      (torch.float64, F64)],
                         ids=["f32", "f64"])
def test_kernel_bits_match_its_host_instance(cuda_device, dtype, kw, seed):
    """The kernel's warp votes, shuffles and butterflies give the bits of
    the loops that walk the same order on the host (the g++ instance), and
    the plain loop's status and pivot counts."""
    from qpn_tpu_torch.ops.lemke_cuda import lemke_pivot_host
    t = _data(cuda_device, S=32, seed=seed)
    init = lemke.lemke_setup(*(t[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), t["mask"],
                             tol=kw["tol"])
    rk = lemke_pivot_cuda(init, max_pivots=1024, **kw)
    torch.cuda.synchronize()
    rp = lemke.lemke_pivot_torch(init, max_pivots=1024, **kw)
    assert torch.equal(rk.status, rp.status)
    assert torch.equal(rk.piv, rp.piv)
    cpu = lemke.LemkeInit(*(a.cpu() for a in init))
    rh = lemke_pivot_host(cpu, max_pivots=1024, **kw)
    for name in ("status", "piv", "basis", "val", "xB"):
        assert torch.equal(getattr(rk, name).cpu(), getattr(rh, name)), name


@pytest.mark.gpu
def test_default_device_puts_the_ensemble_on_the_card(cuda_device):
    from qpn_tpu_torch.config import NumericConfig
    assert NumericConfig().device == "cuda" and CONFIG.device == "cuda"
    b = scenario_batch_gavis(num_scenarios=2, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    assert batch_from_numpy(b)["M"].device.type == "cuda"


# --- the extragradient kernel (csrc/eg_warmstart.cu) -----------------------

def _eg_random(device, n, B=8, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    arrays = (M, rng.standard_normal((B, n)), l, u, np.zeros((B, n)))
    return eg.eg_prepare(*(torch.as_tensor(a, device=device) for a in arrays),
                         torch.ones(B, n, dtype=torch.bool, device=device))


# one n for each kernel the launcher can pick: the register kernel's four
# templated sizes, and the generic kernel beyond them
@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 38, 50, 100, 130])
def test_eg_instances_match_plain_loop_and_host_bits(cuda_device, n):
    """Each instance of the kernel against the plain loop (1e-5 of the lane
    scale after 300 steps: f32 sums in another order) and, bit for bit,
    against the host loop that walks the same partition of every sum."""
    p = _eg_random(cuda_device, n, seed=n)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    torch.cuda.synchronize()
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-5 * scale
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300)
    assert torch.equal(zk.cpu(), zh)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [38, 130], ids=["register", "generic"])
def test_eg_kernel_keeps_nan(cuda_device, n):
    p = _eg_random(cuda_device, n, B=3)
    z0 = p.z0.clone()
    z0[1, 5] = float("nan")
    z = eg_cuda.eg_warmstart_cuda(p.M, p.q, p.l, p.u, z0, p.tau, 4)
    assert bool(torch.isnan(z[1]).any())
    assert bool(torch.isfinite(z[[0, 2]]).all())


def _eg_inputs(t, S=None):
    keys = ("M", "q", "l", "u", "z0", "mask")
    return eg.eg_prepare(*(t[k][:S] for k in keys))


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 300])
def test_eg_kernel_matches_plain_loop(cuda_device, steps):
    """Kernel and plain loop on the same prepared f32 inputs: z within 1e-5
    of the lane scale (f32 sums in another order); one counted launch."""
    p = _eg_inputs(_data(cuda_device))
    before = METRICS.launches[eg_cuda.KERNEL]
    zk = eg_cuda.eg_warmstart_cuda(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    torch.cuda.synchronize()
    assert METRICS.launches[eg_cuda.KERNEL] == before + 1
    zp = eg.eg_steps_torch(p.M, p.q, p.l, p.u, p.z0, p.tau, steps)
    scale = 1.0 + float(zp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-5 * scale
    if steps == 0:
        assert torch.equal(zk, p.z0)


@pytest.mark.gpu
def test_eg_kernel_pins_masked_variables(cuda_device):
    M = torch.eye(3, device=cuda_device, dtype=torch.float64)[None]
    q = torch.tensor([[-1.0, 2.0, 5.0]], device=cuda_device,
                     dtype=torch.float64)
    zeros = torch.zeros_like(q)
    mask = torch.tensor([[True, True, False]], device=cuda_device)
    z = eg.eg_warmstart(M, q, zeros, torch.full_like(q, float("inf")), zeros,
                        mask, steps=300)
    assert float(z[0, 2]) == 0.0
    assert np.allclose(z[0, :2].cpu().numpy(), [1.0, 0.0], atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [239, 304])
def test_eg_kernel_takes_a_lane_too_large_for_shared_memory(cuda_device, n):
    """Past shared memory (n = 239: M of 233 KB with its odd stride) the
    kernel spreads M over a cluster's blocks: one launch counted under the
    cluster instance's name, the plain loop within 1e-5 of the lane scale
    after 300 steps, the bits of the host emulation of its ranks, and the
    global instance (the private launcher; one chunk a row where the
    cluster instance sums four) within 1e-5 of the lane scale."""
    p = _eg_random(cuda_device, n, B=4, seed=n)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    METRICS.reset()
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    torch.cuda.synchronize()
    assert METRICS.launches[eg_cuda.KERNEL_CLUSTER] == 1
    assert METRICS.launches[eg_cuda.KERNEL] == 0
    assert METRICS.launches[eg_cuda.KERNEL_GLOBAL] == 0
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zk - zp).abs().max()) <= 1e-5 * scale
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300,
                               optin=eg_cuda.card_optin(cuda_device))
    assert torch.equal(zk.cpu(), zh)
    zg = eg_cuda._launch(*ins, 300, instance=eg_cuda.EG_GLOBAL)
    assert float((zk - zg).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n", [239, 304, 480, 671])
def test_k2_cluster_instance_gives_the_host_bits(cuda_device, n):
    """K2's cluster instance at the first and last n of its domain and two
    between, at the ranks the wrapper picks (2, 2, 3, 6 on an H100): z after
    300 steps equal to the g++ emulation of those ranks in the cluster's
    partition, bit for bit; one launch counted under its name."""
    p = _eg_random(cuda_device, n, B=4, seed=n + 7)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    instance, ranks = eg_cuda.card_instance(n, cuda_device)
    assert instance == eg_cuda.EG_CLUSTER and 2 <= ranks <= 8
    METRICS.reset()
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    torch.cuda.synchronize()
    assert METRICS.launches[eg_cuda.KERNEL_CLUSTER] == 1
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300,
                               optin=eg_cuda.card_optin(cuda_device))
    assert torch.equal(zk.cpu(), zh)


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [3, 8])
def test_k2_cluster_instance_at_other_ranks(cuda_device, ranks):
    """The private launcher spreads n=304 over 3 and 8 blocks: the bits of
    the emulation of those ranks, which are the bits at the picked 2."""
    p = _eg_random(cuda_device, 304, B=4, seed=11)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    zk = eg_cuda._launch(*ins, 300, instance=eg_cuda.EG_CLUSTER,
                         ranks=ranks)
    z2 = eg_cuda.eg_warmstart_cuda(*ins, 300)
    torch.cuda.synchronize()
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300, ranks=ranks)
    assert torch.equal(zk.cpu(), zh)
    assert torch.equal(zk, z2)


@pytest.mark.gpu
def test_k2_cluster_refuses_a_chunk_shorter_than_its_registers(cuda_device):
    """At n=130 a thread's chunk (36 columns) is shorter than the entries it
    holds in registers: the private launcher's cluster launch raises, and
    counts nothing."""
    p = _eg_random(cuda_device, 130, B=2)
    METRICS.reset()
    with pytest.raises(RuntimeError, match="launch failed"):
        eg_cuda._launch(p.M, p.q, p.l, p.u, p.z0, p.tau, 10,
                        instance=eg_cuda.EG_CLUSTER, ranks=2)
    assert sum(METRICS.launches.values()) == 0


@pytest.mark.gpu
def test_adaptive_path_goes_through_both_kernels(cuda_device):
    """The generic route on the card: the EG pre-pass launches its kernel;
    far starts with one short budget stage leave every lane to
    lemke_escalate, whose f64 pivot loop launches the Lemke kernel."""
    t = _data(cuda_device, S=16)
    args = [t[k] for k in ("M", "q", "l", "u", "z0", "mask")]
    METRICS.reset()
    res = solve_avi_batch_adaptive(*args, tol=1e-8, mixed=True,
                                   onchip_eg_steps=2000)
    assert METRICS.launches[eg_cuda.KERNEL] == 1
    assert bool(res.converged.all()) and res.z.device.type == "cuda"
    rng = np.random.default_rng(0)
    args[4] = torch.as_tensor(1e4 * rng.standard_normal(tuple(t["q"].shape)),
                              device=cuda_device)
    METRICS.reset()
    res = solve_avi_batch_adaptive(*args, tol=1e-8, budgets=(1,), mixed=True)
    assert METRICS.counters["escalated_lanes"] > 0
    assert METRICS.launches[KERNEL] >= 1
    assert bool(res.converged.any())


@pytest.mark.gpu
def test_eg_kernel_setting_torch_skips_the_kernel(cuda_device):
    p = _eg_inputs(_data(cuda_device, S=4))
    old = CONFIG.eg_kernel
    try:
        CONFIG.eg_kernel = "torch"
        METRICS.reset()
        eg.eg_engine(p.M.device)(p.M, p.q, p.l, p.u, p.z0, p.tau, 5)
        assert METRICS.launches[eg_cuda.KERNEL] == 0
    finally:
        CONFIG.eg_kernel = old


# --- the hybrid hop kernel (csrc/hybrid_hop.cu) ----------------------------

def _hop_random(device, n, dtype, B=4, seed=0):
    """Monotone lanes with lower bounds 0 or -inf and upper 1 or +inf,
    Ruiz-scaled as solve_avi_batch scales them, from random starts."""
    from qpn_tpu_torch.ops.eg import ruiz
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    K = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = (np.einsum("bij,bkj->bik", A, A) + K - K.transpose(0, 2, 1)
         + 0.1 * np.eye(n)[None])
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    M, q, l, u, z = (torch.as_tensor(a, device=device) for a in (
        M, rng.standard_normal((B, n)), l, u, rng.standard_normal((B, n))))
    d, e = ruiz(M)
    Mm = d[:, :, None] * M * e[:, None, :]
    ls = torch.where(torch.isfinite(l), l / e, l)
    us = torch.where(torch.isfinite(u), u / e, u)
    tau = 0.9 / (1.0 + Mm.abs().sum(2).amax(1))
    return tuple(a.to(dtype).contiguous() for a in (
        Mm, d * q, ls, us, tau, torch.clamp(z / e, ls, us)))


HOP_DTYPES = [torch.float32, torch.float64]
# the kernel against the plain loop, relative to the lane's scale: z, and
# ||Phi|| of the best merit (tests/test_torch_hop.py's bounds: the same
# arithmetic, other orders of sums)
HOP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _hop_close(got, want, z0):
    scale = 1.0 + z0.abs().amax(1)
    tol = HOP_TOL[z0.dtype]
    assert float(((got[0] - want[0]).abs().amax(1) / scale).max()) <= tol
    err = ((2 * got[2]).sqrt() - (2 * want[2]).sqrt()).abs() / scale
    assert float(err.max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("instance", [0, 1, 2],
                         ids=["register", "shared", "global"])
@pytest.mark.parametrize("dtype", HOP_DTYPES, ids=["f32", "f64"])
def test_hop_instances_give_the_host_bits(cuda_device, dtype, instance):
    """Each instance through the private launcher on the flagship's first
    hop (n=38, 16 lanes, 60 steps): the g++ build's bits in that
    instance's order of sums, and the plain loop's results within
    HOP_TOL; one launch counted."""
    from qpn_tpu_torch.ops import avi, hop_cuda
    t = _data(cuda_device, S=16)
    ins = chip_smoke.first_hop([t[k] for k in chip_smoke.KEYS], dtype)
    METRICS.reset()
    got = hop_cuda._launch(*ins, 60, instance=instance)
    torch.cuda.synchronize()
    assert METRICS.launches[hop_cuda.KERNEL] == 1
    host = hop_cuda.hybrid_hop_host(*(a.cpu() for a in ins), 60,
                                    instance=instance)
    assert all(chip_smoke.same_bits(g.cpu(), h) for g, h in zip(got, host))
    _hop_close(got, avi._eg_phase(*ins, 60), ins[5])


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 60])
@pytest.mark.parametrize("n", [5, 38, 64, 100, 200, 240])
@pytest.mark.parametrize("dtype", HOP_DTYPES, ids=["f32", "f64"])
def test_hop_picked_instance_matches_host_bits_and_plain_loop(
        cuda_device, dtype, n, steps):
    """The wrapper's pick for n and the precision (register up to 64 in
    f32 and 40 in f64, shared, and M read in place at f64 n=200 and at
    n=240) against the g++ build's bits at the card's limit, and the plain
    loop within HOP_TOL."""
    from qpn_tpu_torch.ops import avi, hop_cuda
    ins = _hop_random(cuda_device, n, dtype, seed=n)
    got = hop_cuda.hybrid_hop_cuda(*ins, steps)
    torch.cuda.synchronize()
    host = hop_cuda.hybrid_hop_host(*(a.cpu() for a in ins), steps,
                                    optin=eg_cuda.card_optin(cuda_device))
    assert all(chip_smoke.same_bits(g.cpu(), h) for g, h in zip(got, host))
    _hop_close(got, avi._eg_phase(*ins, steps), ins[5])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HOP_DTYPES, ids=["f32", "f64"])
def test_hop_kernel_keeps_nan_as_the_host(cuda_device, dtype):
    """A lane that overflows to inf, then NaN, beside a finite one: the
    host's bits and NaNs (a NaN merit takes over the best merit, the best z
    stays finite)."""
    from qpn_tpu_torch.ops import hop_cuda
    ins = list(_hop_random(cuda_device, 6, dtype, B=2, seed=1))
    ins[4] = ins[4].clone()
    ins[4][1] = 1e6             # far past 1 / ||M||: the lane diverges
    got = hop_cuda.hybrid_hop_cuda(*ins, 60)
    torch.cuda.synchronize()
    host = hop_cuda.hybrid_hop_host(*(a.cpu() for a in ins), 60)
    assert all(chip_smoke.same_bits(g.cpu(), h) for g, h in zip(got, host))
    assert bool(torch.isnan(got[2][1])) and bool(torch.isfinite(got[2][0]))
    assert bool(torch.isfinite(got[1]).all())


@pytest.mark.gpu
def test_generic_route_on_the_cells_pool_runs_every_hop_in_the_kernel(
        cuda_device, monkeypatch):
    """The benchmark cell ra_T2o1.generic_s256's 32 pool ensembles through
    solve_avi_batch_adaptive as the cell calls it: every lane at or below
    1e-8 (the route's residual and a numpy audit), one hop kernel launch
    for every round of every precision pass, and every hop lane fused."""
    from qpn_tpu_torch.ops import hop_cuda
    M, q, l, u, z0, mask, mix = chip_smoke.cell_pool("ra_T2o1.generic_s256",
                                                     cuda_device)
    rounds = []
    real = hop_cuda.hybrid_hop_cuda

    def counted(*a):
        rounds.append(a[0].shape[0])
        return real(*a)
    monkeypatch.setattr(hop_cuda, "hybrid_hop_cuda", counted)
    METRICS.reset()
    for e in range(mix["pool"]):
        res = solve_avi_batch_adaptive(M, q[e], l[e], u, z0, mask,
                                       tol=mix["tol"],
                                       onchip_eg_steps=mix["onchip_eg_steps"])
        assert float(res.resid.max()) <= mix["tol"]
        F = (M @ res.z[:, :, None])[:, :, 0] + q[e]
        phi = res.z - torch.minimum(torch.maximum(res.z - F, l[e]), u)
        assert float(phi.abs().max()) <= mix["tol"]
    torch.cuda.synchronize()
    assert rounds and METRICS.launches[hop_cuda.KERNEL] == len(rounds)
    c = METRICS.counters
    assert c["hop_lanes"] == c["hop_fused_lanes"] == sum(rounds)


# --------------------------------------------------------------------------
#  feasibility screen kernel (csrc/screen.cu)
# --------------------------------------------------------------------------

def _screen_polys(B, m, n, seed=0):
    """Seeded polyhedra, every odd one empty by two rows with one normal and
    bounds 2 apart; returns (polys, empty truth)."""
    from qpn_tpu_torch.geometry import Poly
    rng = np.random.default_rng(seed)
    polys, truth = [], np.zeros(B, dtype=bool)
    for b in range(B):
        A = rng.standard_normal((m, n))
        ax = A @ (0.1 * rng.standard_normal(n))
        w = 0.5 + rng.random(m)
        l, u = ax - w, ax + w
        u[2] = np.inf                   # a one-sided row
        if b % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, np.inf
            l[1], u[1] = -np.inf, ax[0] - 1.0
            truth[b] = True
        polys.append(Poly(A, l, u, normalize=False, dedupe=False))
    return polys, truth


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,n", [(8, 5, 3), (512, 18, 18), (64, 300, 40)],
                         ids=["small", "wide", "tall"])
def test_screen_kernel_matches_plain_loop(cuda_device, B, m, n):
    """Kernel and plain loop on the same prepared inputs: x and max |v|
    within 1e-4 of the scale (f32, sums in another order over 120
    contracting steps); one counted launch."""
    polys, _ = _screen_polys(B, m, n)
    ins = [torch.as_tensor(a, device=cuda_device)
           for a in screen.screen_prepare(polys)]
    before = METRICS.launches[screen_cuda.KERNEL]
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, 120, 0.05)
    torch.cuda.synchronize()
    assert METRICS.launches[screen_cuda.KERNEL] == before + 1
    xp, vp = screen.screen_steps_torch(*ins, 120, 0.05)
    scale = 1.0 + xp.abs().amax(1, keepdim=True)
    assert float(((xk - xp).abs() / scale).max()) <= 1e-4
    assert float(((vk - vp).abs() / (1.0 + vp)).max()) <= 1e-4


def _ragged_screen(B, m, n, seed):
    """Prepared inputs of polyhedra whose row counts run from 1 to m (zero
    rows pad the batch), with one-sided and free rows."""
    from qpn_tpu_torch.geometry import Poly
    rng = np.random.default_rng(seed)
    polys = []
    for b in range(B):
        mb = m if b == 0 else 1 + (b * 5) % m
        A = rng.standard_normal((mb, n))
        ax = A @ (0.3 * rng.standard_normal(n))
        w = 0.2 + rng.random(mb)
        l, u = ax - w, ax + w
        u[rng.random(mb) < 0.3] = np.inf
        l[rng.random(mb) < 0.2] = -np.inf
        polys.append(Poly(A, l, u, normalize=False, dedupe=False))
    return [torch.as_tensor(a) for a in screen.screen_prepare(polys)]


# the warp kernel's register ceilings are multiples of 4 up to 32: shapes
# at, below and above an edge, and the first ones the generic kernel takes
@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 5), (5, 1), (8, 8), (9, 8), (8, 9),
                                 (18, 18), (18, 26), (32, 32), (33, 5),
                                 (5, 33), (32, 33)])
def test_screen_kernel_bits_match_its_host_instance(cuda_device, m, n):
    """Both kernels sum in the order of the g++ instance (registers, shared-
    memory lines and the zero padding change no bit), on ragged row counts
    and a batch that does not fill its last block; within 1e-4 of the plain
    loop."""
    cpu = _ragged_screen(37, m, n, seed=m * 100 + n)
    ins = [a.to(cuda_device) for a in cpu]
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, 120, 0.05)
    torch.cuda.synchronize()
    xh, vh = screen_cuda.screen_steps_host(*cpu, 120, 0.05)
    assert torch.equal(xk.cpu(), xh) and torch.equal(vk.cpu(), vh)
    xp, vp = screen.screen_steps_torch(*ins, 120, 0.05)
    scale = 1.0 + xp.abs().amax(1, keepdim=True)
    assert float(((xk - xp).abs() / scale).max()) <= 1e-4
    assert float(((vk - vp).abs() / (1.0 + vp)).max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("m,n", [(9, 8), (18, 18), (33, 5), (260, 240)])
def test_screen_kernel_nan_and_inf_as_its_host_instance(cuda_device, m, n,
                                                        bad):
    """A NaN or infinite start entry: NaN where the host instance has NaN,
    its bits elsewhere (260 x 240: the cluster instance)."""
    cpu = _ragged_screen(5, m, n, seed=7)
    cpu[3][1, n - 1] = bad
    xk, vk = screen_cuda.feasibility_screen_cuda(
        *(a.to(cuda_device) for a in cpu), 10, 0.05)
    xh, vh = screen_cuda.screen_steps_host(*cpu, 10, 0.05)
    xk, vk = xk.cpu(), vk.cpu()
    assert torch.equal(torch.isnan(xk), torch.isnan(xh))
    assert torch.equal(torch.isnan(vk), torch.isnan(vh))
    assert torch.equal(xk[~torch.isnan(xk)], xh[~torch.isnan(xh)])
    assert torch.equal(vk[~torch.isnan(vk)], vh[~torch.isnan(vh)])


@pytest.mark.gpu
def test_screen_kernel_keeps_nan(cuda_device):
    """A NaN start stays NaN in x and max |v| (no fmaxf/fminf)."""
    polys, _ = _screen_polys(4, 6, 3)
    A, l, u, x0 = (torch.as_tensor(a, device=cuda_device)
                   for a in screen.screen_prepare(polys))
    x0[1, 0] = float("nan")
    xk, vk = screen_cuda.feasibility_screen_cuda(A, l, u, x0, 10, 0.05)
    assert bool(torch.isnan(vk[1])) and bool(torch.isnan(xk[1]).any())
    assert bool(torch.isfinite(vk[[0, 2, 3]]).all())


@pytest.mark.gpu
def test_screen_kernel_takes_a_block_too_large_for_shared_memory(
        cuda_device):
    """Polyhedra of 260 rows in dimension 240 (A of 245 KB with its odd
    stride) run in the cluster instance (3 blocks a polyhedron on an H100):
    one launch counted under its name, the bits of the host emulation of
    those ranks and of the global instance (the private launcher), the
    plain loop within 1e-4 (relative)."""
    polys, _ = _screen_polys(4, 260, 240, seed=4)
    prob = screen.screen_prepare(polys)
    ins = [torch.as_tensor(a, device=cuda_device) for a in prob]
    instance, ranks = screen_cuda.card_instance(260, 240, cuda_device)
    assert instance == screen_cuda.SCREEN_CLUSTER and ranks >= 2
    METRICS.reset()
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, 120, 0.05)
    torch.cuda.synchronize()
    assert METRICS.launches[screen_cuda.KERNEL_CLUSTER] == 1
    assert METRICS.launches[screen_cuda.KERNEL_GLOBAL] == 0
    assert METRICS.launches[screen_cuda.KERNEL] == 0
    xh, vh = screen_cuda.screen_steps_host(
        *(a.cpu() for a in ins), 120, 0.05,
        optin=screen_cuda.card_optin(cuda_device))
    assert torch.equal(xk.cpu(), xh) and torch.equal(vk.cpu(), vh)
    xg, vg = screen_cuda._launch_global(*ins, 120, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(xk, xg) and torch.equal(vk, vg)
    xp, vp = screen.screen_steps_torch(*ins, 120, 0.05)
    assert float(((xk - xp).abs().amax(1)
                  / (1.0 + xp.abs().amax(1))).max()) <= 1e-4
    assert float(((vk - vp).abs() / (1.0 + vp)).max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [2, 8], ids=["R2", "R8"])
def test_screen_cluster_instance_at_other_sizes(cuda_device, ranks):
    """The cluster instance at 2 and 8 blocks a polyhedron through the
    private launcher (where one rank fits the card: 2 at 120 rows in
    dimension 100, 8 at 260 x 240): the bits of the host emulation of those
    ranks, and of the picked instance."""
    m, n = (120, 100) if ranks == 2 else (260, 240)
    cpu = _ragged_screen(9, m, n, seed=ranks)
    ins = [a.to(cuda_device) for a in cpu]
    METRICS.reset()
    xk, vk = screen_cuda._launch_cluster(*ins, 120, 0.05, ranks=ranks)
    torch.cuda.synchronize()
    assert METRICS.launches[screen_cuda.KERNEL_CLUSTER] == 1
    xh, vh = screen_cuda.screen_steps_host(*cpu, 120, 0.05, ranks=ranks)
    assert torch.equal(xk.cpu(), xh) and torch.equal(vk.cpu(), vh)
    xs, vs = screen_cuda.feasibility_screen_cuda(*ins, 120, 0.05)
    assert torch.equal(xk, xs) and torch.equal(vk, vs)


@pytest.mark.gpu
def test_screen_global_instance_past_the_cluster_reach(cuda_device):
    """Polyhedra of 520 rows in dimension 500, past a cluster of 8 blocks:
    the global instance, one launch counted under its name, the bits of
    its host build, the plain loop within 1e-4 (relative)."""
    polys, _ = _screen_polys(2, 520, 500, seed=5)
    ins = [torch.as_tensor(a, device=cuda_device)
           for a in screen.screen_prepare(polys)]
    assert screen_cuda.card_instance(520, 500, cuda_device) == (
        screen_cuda.SCREEN_GLOBAL, 1)
    METRICS.reset()
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, 120, 0.05)
    torch.cuda.synchronize()
    assert METRICS.launches[screen_cuda.KERNEL_GLOBAL] == 1
    assert sum(METRICS.launches.values()) == 1
    xh, vh = screen_cuda.screen_steps_host(*(a.cpu() for a in ins), 120,
                                           0.05)
    assert torch.equal(xk.cpu(), xh) and torch.equal(vk.cpu(), vh)
    xp, vp = screen.screen_steps_torch(*ins, 120, 0.05)
    assert float(((xk - xp).abs().amax(1)
                  / (1.0 + xp.abs().amax(1))).max()) <= 1e-4
    assert float(((vk - vp).abs() / (1.0 + vp)).max()) <= 1e-4


@pytest.mark.gpu
def test_is_empty_batch_on_the_card_goes_through_the_screen(
        cuda_device, monkeypatch):
    """geometry.is_empty_batch on the default device (the card) with the
    screen on: the verdicts of the exact LPs, at least one screen launch."""
    from qpn_tpu_torch.geometry import is_empty_batch
    from qpn_tpu_torch.geometry.query_cache import CACHE
    polys, truth = _screen_polys(64, 18, 18, seed=1)
    assert CONFIG.device == "cuda"
    monkeypatch.setattr(CONFIG, "use_screen", True)
    CACHE.clear()
    before = METRICS.launches[screen_cuda.KERNEL]
    out = is_empty_batch(polys)
    assert METRICS.launches[screen_cuda.KERNEL] > before
    np.testing.assert_array_equal(out, truth)


def _pieces(ret):
    return {k: len(list(v)) for k, v in ret.Sol.items() if v is not None}


@pytest.mark.gpu
def test_lockstep_ensemble_on_the_card(cuda_device):
    """chip_smoke.py phase 15 at 6 scenarios: each lockstep scenario on the
    card ends at its serial solve's x_opt (1e-6) and pieces, in fused
    waves with fewer ADMM calls than the serial runs together."""
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.parallel.lockstep import solve_many_lockstep
    assert CONFIG.device == "cuda"
    x0s = [np.array([0.1 * i, 1.0, 0.0, 0.0]) for i in range(6)]
    serial, calls = [], 0.0
    for x0 in x0s:
        serial.append(qt.solve(qt.setup("simple_bilevel"), x0))
        calls += METRICS.counters["admm_calls"]
    METRICS.reset()
    outs, broker = solve_many_lockstep(
        [qt.setup("simple_bilevel") for _ in x0s], x0s)
    assert broker.waves >= 1
    assert METRICS.counters["admm_calls"] < calls
    for o, s in zip(outs, serial):
        assert o.solved and s.solved
        np.testing.assert_allclose(o.x_opt, s.x_opt, rtol=0, atol=1e-6)
        assert _pieces(o) == _pieces(s)


@pytest.mark.gpu
def test_banded_x_update_on_the_card(cuda_device, monkeypatch):
    """chip_smoke.py phase 16 at one size: the banded and the dense
    x-update give one solution on the card, and the automatic route of
    solve_qp_batch_padded takes the banded one when switched on."""
    from qpn_tpu_torch.ops import batch_qp
    from qpn_tpu_torch.ops.banded import dense_from_blocks, horizon_kkt_blocks
    rng = np.random.default_rng(0)
    B, T, k = 8, 16, 6
    n = T * k
    Ps, qs = [], []
    for _ in range(B):
        A_, B_, C_, g = horizon_kkt_blocks(T, k, rng)
        Q = dense_from_blocks(A_, B_, C_)
        Ps.append(0.5 * (Q + Q.T) + 0.5 * np.eye(n))
        qs.append(g.flatten())
    host = (np.stack(Ps), np.stack(qs), np.repeat(np.eye(n)[None], B, 0),
            np.full((B, n), -2.0), np.full((B, n), 2.0),
            np.ones((B, n), bool))
    t = [torch.as_tensor(a, device=cuda_device) for a in host]
    dense = batch_qp.solve_qp_batch(*t)
    band = batch_qp.solve_qp_batch(*t, banded_k=k)
    assert bool((band.status == batch_qp.SOLVED).all())
    assert float((dense.x - band.x).abs().max()) <= 1e-6
    assert banded_min_blocks() == 0     # the automatic route: off on the card
    monkeypatch.setattr(batch_qp, "banded_min_blocks", lambda: 8)
    before = METRICS.counters.get("banded_route", 0.0)
    sol = batch_qp.solve_qp_batch_padded(*host)
    assert METRICS.counters["banded_route"] == before + B
    np.testing.assert_allclose(sol.x, dense.x.cpu().numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
def test_checkpoint_and_resume_on_the_card(cuda_device, tmp_path):
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.utils.checkpoint import load_state, resume
    x0 = np.array([1.0, 0.0, 0.0, 0.0])
    plain = qt.solve(qt.setup("simple_bilevel", gen_solution_map=True), x0)
    path = str(tmp_path / "run")
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    ret = qt.solve(qpn, x0, checkpoint_path=path)
    assert ret.solved and load_state(path)["meta"] == {"solved": True}
    np.testing.assert_allclose(ret.x_opt, plain.x_opt, rtol=0, atol=1e-6)
    res = resume(qpn, path)
    assert res.solved and _pieces(res) == _pieces(plain)
    np.testing.assert_allclose(res.x_opt, plain.x_opt, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_map_processes_from_a_cuda_parent(cuda_device):
    """Workers spawned from a parent that holds a CUDA context run on the
    card (the parent's CONFIG.device) and give the parent's own result."""
    from qpn_tpu_torch.config import numeric_device
    from qpn_tpu_torch.models.robust_avoid import hard_chunk_job
    from qpn_tpu_torch.parallel.procpool import map_processes
    torch.zeros(1, device=cuda_device)
    assert map_processes(numeric_device, [()] * 2, n_workers=2) == \
        [torch.device("cuda")] * 2
    job = (2, 2, 1, 3, 0, 1e-8)
    out = map_processes(hard_chunk_job, [job] * 2, n_workers=2)
    want = hard_chunk_job(*job)
    assert out[0] == out[1] and out[0][0] == 1.0 == want[0]
    np.testing.assert_allclose(out[0][2], want[2], rtol=1e-9)


def _host_prune(act, resid):
    """The keep mask of the strict (round(resid·1e12), index) prune, as a
    plain numpy loop."""
    rq = np.round(resid * 1e12)
    keep = np.ones(len(act), dtype=bool)
    for i in range(len(act)):
        for j in range(len(act)):
            if (act[j] == act[i]).all() and (
                    rq[j] < rq[i] or (rq[j] == rq[i] and j < i)):
                keep[i] = False
                break
    return keep


@pytest.mark.gpu
def test_world_size_one_nccl_superstep_is_the_single_process_solve(
        cuda_device, tmp_path):
    """One rank over NCCL on the card: the sharded superstep's z and
    convergence are the single-process solve_avi_batch's bit for bit, its
    keep mask the host prune's."""
    import torch.distributed as dist
    from qpn_tpu_torch.ops.avi import solve_avi_batch
    from qpn_tpu_torch.parallel import multihost
    from qpn_tpu_torch.parallel.sharded import equilibrium_superstep
    batch = scenario_batch_gavis(num_scenarios=64, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    assert multihost.init("file://" + str(tmp_path / "rdv"), 1, 0) == "nccl"
    try:
        mesh = multihost.global_mesh()
        assert mesh.device.type == "cuda" and mesh.backend == "nccl"
        out = equilibrium_superstep(mesh, batch, tol=1e-8)
    finally:
        dist.destroy_process_group()
    d = batch_from_numpy(batch, cuda_device)
    one = solve_avi_batch(d["M"], d["q"], d["l"], d["u"], d["z0"],
                          d["mask"], tol=1e-8, max_iter=840)
    assert torch.equal(out["z"], one.z)
    assert torch.equal(out["resid"], one.resid)
    z = one.z.cpu().numpy()
    lq = np.where(np.isfinite(batch["l"]), batch["l"], -1e20)
    uq = np.where(np.isfinite(batch["u"]), batch["u"], 1e20)
    act = ((np.abs(z - lq) < 1e-6).astype(np.int32)
           + 2 * (np.abs(z - uq) < 1e-6).astype(np.int32))
    np.testing.assert_array_equal(out["keep"].cpu().numpy(),
                                  _host_prune(act, one.resid.cpu().numpy()))


@pytest.mark.gpu
def test_dryrun_multichip_two_gloo_ranks_on_one_card(cuda_device):
    """Two ranks and one card: gloo, both ranks on cuda:0; the four stages
    pass and the lockstep scenarios end at their serial solves on the card
    (x_opt to 1e-6, equal pieces)."""
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.entry import LOCKSTEP_WS, RING_PIECES
    from qpn_tpu_torch.entry import dryrun_multichip
    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks take NCCL on a machine with two cards")
    outs = dryrun_multichip(2, timeout_s=600)
    for r in outs:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert r["ring_kept"] == RING_PIECES - RING_PIECES // 4
        assert r["ring_waves"] >= 1 and r["shared_conv"].all()
    np.testing.assert_array_equal(outs[0]["z"], outs[1]["z"])
    for k, w in enumerate(LOCKSTEP_WS):
        s = qt.solve(qt.setup("simple_bilevel"),
                     np.concatenate([w, [0.0, 0.0]]))
        for r in outs:
            np.testing.assert_allclose(r["x_opts"][k], s.x_opt, rtol=0,
                                       atol=1e-6)
            assert r["pieces"][k] == _pieces(s)
