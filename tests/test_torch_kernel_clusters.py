"""The cluster instances of K1 (``csrc/lemke_lane.cuh``), K2
(``csrc/eg_lane.cuh``) and K3 (``csrc/screen_lane.cuh``), through their host
emulation.

A lane that does not fit one block's shared memory is spread over a cluster
of R blocks: rank k holds a band of the lane's rows, and the phases read
across ranks.  The g++ host build carves R buffers as the card's blocks are
carved and runs each phase for rank 0, 1, ..., R-1 in turn between the
points where the card's ranks meet at the cluster's barrier.  Each rank's
sums walk the same order as one block's, so the emulation at any R gives
the bits of the host instance at R = 1: status, pivots, basis, nonbasic
values and basic values for K1 (whose cluster instance fuses a pivot's
update with the next step's basic values and ratios, and whose decision
reads each rank's least ratio: the bits of the shared instance's phases
apart), z for K2 (in the cluster instance's partition of every row's sum:
four chunks joined by a butterfly, not the shared and global instances'
one chunk), x and max |v| for K3 (whose rank k also holds a band of A's
columns for phase 2).  At R = 2, K1 also lands where the JAX package's KKT
solve does on the same numpy inputs, K2 where its Pallas kernel does in
interpret mode, and at R = 3 K3 where the JAX package's Pallas screen does
in interpret mode.

Lanes: a few of robust_avoid's ensembles at num_obj=2, seed 0 (T=4, 5: n =
152, 190 for K1 in f32 at the hot route's tolerances and n = 152 in f64 at
the re-pivot's; T=8: n = 304 for K2, 300 steps), at num_obj=1, T=5 (n = 95,
K1 in f64), and seeded monotone box AVIs (K1 f32 at n = 136; K2 at n = 239,
304, 480, 671); for K3, 4 seeded polyhedra of 260 rows in dimension 240
(every second one empty), 120 steps.
"""

import functools

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, lemke_cuda, screen
from qpn_tpu_torch.ops import screen_cuda
from qpn_tpu_torch.utils.cuda_build import HOPPER_SMEM_OPTIN

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
JAX_Z_TOL = 1e-8
# K2 against the plain loop (300 steps) and the JAX package's Pallas kernel
# (20000 steps): f32 sums in another order, as chip_smoke.py's EG_TOL
EG_RTOL = {300: 1e-5, 20000: 1e-4}
# K3 against the JAX package's screen (tests/test_torch_screen.py): f32
# sums in another order, a few ulps a step over 120 contracting steps
SCREEN_TOL = 1e-5
SCREEN_STEPS, SCREEN_LR = 120, 0.05
PICKED = None              # the ranks the launcher picks at an H100's limit


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@functools.lru_cache(maxsize=None)
def _ensemble(S, T, num_obj=2):
    return scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                                num_poly_faces=4, seed=0)


def _box_avi(n, B, seed):
    """Seeded monotone box AVIs (``test_torch_eg.py``'s recipe) as numpy
    arrays M, q, l, u, z0."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    return M, q, l, u, np.zeros((B, n))


def _k1_init(T, dtype, kw, S=4, num_obj=2):
    """K1's setup on S lanes of robust_avoid at T (T = 0: seeded box AVIs
    of n = 136, which no robust_avoid size gives)."""
    if T == 0:
        arrays, mask = _box_avi(136, S, 136), np.ones((S, 136), dtype=bool)
    else:
        b = _ensemble(S, T, num_obj)
        arrays = [b[k] for k in ("M", "q", "l", "u", "z0")]
        mask = b["mask"]
    M, q, l, u, z0 = (torch.as_tensor(a).to(dtype) for a in arrays)
    return lemke.lemke_setup(M, q, l, u, z0, torch.as_tensor(mask),
                             tol=kw["tol"])


@pytest.mark.parametrize("ranks", [2, 3, PICKED], ids=["R2", "R3", "picked"])
@pytest.mark.parametrize("T,num_obj,n,dtype,kw", [
    (4, 2, 152, torch.float32, HOT), (5, 2, 190, torch.float32, HOT),
    (4, 2, 152, torch.float64, F64), (0, 0, 136, torch.float32, HOT),
    (5, 1, 95, torch.float64, F64)],
    ids=["f32_n152", "f32_n190", "f64_n152", "f32_n136", "f64_n95"])
def test_k1_cluster_emulation_gives_the_host_instance_bits(T, num_obj, n,
                                                           dtype, kw, ranks):
    """The cluster instance's fused loop at R ranks (the lane's first and
    last n in f32 and f64 among them: 136 and 95) against the shared
    instance's phases at R = 1, bit for bit."""
    init = _k1_init(T, dtype, kw, num_obj=num_obj)
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


@pytest.mark.parametrize("ranks", [2, 3, 4, 5, 6, 7, 8],
                         ids=[f"R{r}" for r in range(2, 9)])
@pytest.mark.parametrize("n", [239, 304, 480, 671])
def test_k2_cluster_partition_gives_the_one_rank_bits(n, ranks):
    """K2's cluster instance at the first and last n of its domain and two
    between: the emulation of R ranks in the cluster's partition (a row's
    sum in four chunks joined by a butterfly) gives the bits of one rank in
    that partition, 40 steps on 2 seeded lanes."""
    p = eg.eg_prepare(*(torch.as_tensor(a) for a in _box_avi(n, 2, n)),
                      torch.ones(2, n, dtype=torch.bool))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == eg_cuda.EG_CLUSTER
    one = eg_cuda.eg_steps_host(*ins, 40, ranks=1)
    assert bool(torch.isfinite(one).all())
    assert torch.equal(eg_cuda.eg_steps_host(*ins, 40, ranks=ranks), one)


@pytest.mark.parametrize("n", [239, 304, 480, 671])
def test_k2_cluster_partition_matches_plain_loop(n):
    """The cluster instance's partition at the ranks an H100 picks is still
    the plain loop's iteration: z within 1e-5 of the lane scale after 300
    steps."""
    p = eg.eg_prepare(*(torch.as_tensor(a) for a in _box_avi(n, 2, n + 1)),
                      torch.ones(2, n, dtype=torch.bool))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    zh = eg_cuda.eg_steps_host(*ins, 300)
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zh - zp).abs().max()) <= EG_RTOL[300] * scale


def test_k2_cluster_emulation_matches_the_jax_package():
    """One lane of robust_avoid at T=8, num_obj=2 (n=304, the cluster
    instance at R = 2 on an H100) through the port's warm start on the
    cluster's emulation and through the JAX package's Pallas kernel in
    interpret mode (as ``tests/test_pallas.py`` runs it), 20000 steps: z
    within 1e-4 of the lane scale."""
    from qpn_tpu.ops import pallas_kernels as pk
    b = _ensemble(1, 8)
    problem = tuple(b[k] for k in ("M", "q", "l", "u", "z0", "mask"))
    assert problem[1].shape == (1, 304)
    assert eg_cuda.host_cluster_ranks(304, HOPPER_SMEM_OPTIN) == 2
    ref = pk.eg_warmstart(*problem, steps=20000)
    z = eg.eg_warmstart(*(torch.as_tensor(a) for a in problem), steps=20000,
                        engine=eg_cuda.eg_steps_host)
    scale = 1.0 + np.abs(ref).max()
    assert np.abs(z.numpy() - ref).max() <= EG_RTOL[20000] * scale


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


# --- K3 ---------------------------------------------------------------------

def _k3_polys(P, B=4, m=260, n=240, seed=0):
    """Seeded polyhedra of the class ``P`` (the port's or the JAX
    package's Poly) without strict rows around a centre of scale 0.1,
    ~30 % of the rows one-sided, every odd one empty by two rows with one
    normal and bounds 2 apart."""
    rng = np.random.default_rng(seed)
    polys = []
    for b in range(B):
        A = rng.standard_normal((m, n))
        ax = A @ (0.1 * rng.standard_normal(n))
        w = 0.5 + rng.random(m)
        l, u = ax - w, ax + w
        u[rng.random(m) < 0.3] = np.inf
        if b % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, np.inf
            l[1], u[1] = -np.inf, ax[0] - 1.0
        polys.append(P(A, l, u, normalize=False, dedupe=False))
    return polys


@functools.lru_cache(maxsize=None)
def _k3_inputs():
    from qpn_tpu_torch.geometry import Poly
    return tuple(torch.as_tensor(a) for a in
                 screen.screen_prepare(_k3_polys(Poly)))


def _same_bits(a, b):
    """Equal bit for bit, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("ranks", [2, 3, 8], ids=["R2", "R3", "R8"])
def test_k3_cluster_emulation_gives_the_host_instance_bits(ranks):
    """The emulation of R ranks, picked by the launcher's rule under a
    limit (an H100's picks R = 3 at 260 x 240; a limit that just holds a
    rank at R = 2 or at 8 picks those) and forced by ``ranks``: x and max
    |v| of the one-block host instance, bit for bit."""
    ins = _k3_inputs()
    optin = (HOPPER_SMEM_OPTIN if ranks == 3
             else screen_cuda.host_cluster_bytes(260, 240, ranks))
    assert screen_cuda.host_instance(260, 240, optin) == (
        screen_cuda.SCREEN_CLUSTER)
    assert screen_cuda.host_cluster_ranks(260, 240, optin) == ranks
    one = screen_cuda.screen_steps_host(*ins, SCREEN_STEPS, SCREEN_LR,
                                        generic=True)
    assert bool(torch.isfinite(one[0]).all())
    for kw in (dict(optin=optin), dict(ranks=ranks)):
        x, v = screen_cuda.screen_steps_host(*ins, SCREEN_STEPS, SCREEN_LR,
                                             **kw)
        assert torch.equal(x, one[0]) and torch.equal(v, one[1]), kw


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_k3_cluster_emulation_keeps_nan_and_inf(bad):
    """A NaN or an infinity in l and in u at a small shape (40 rows in
    dimension 36, 3 ranks; infinite bounds are also the one-sided rows):
    NaN where the one-block host instance has NaN, its bits elsewhere."""
    from qpn_tpu_torch.geometry import Poly
    A, l, u, x0 = (torch.as_tensor(a) for a in screen.screen_prepare(
        _k3_polys(Poly, B=4, m=40, n=36, seed=3)))
    l[1, 5] = bad
    u[2, 7] = bad
    one = screen_cuda.screen_steps_host(A, l, u, x0, 10, SCREEN_LR,
                                        generic=True)
    spread = screen_cuda.screen_steps_host(A, l, u, x0, 10, SCREEN_LR,
                                           ranks=3)
    if bad != bad:
        assert bool(torch.isnan(one[1][1])) and bool(torch.isnan(one[1][2]))
    for a, b in zip(spread, one):
        assert _same_bits(a, b)


def test_k3_cluster_emulation_matches_the_jax_package(monkeypatch):
    """The emulation at R = 3 (the pick at 260 x 240 on an H100) against
    the JAX package's screen, its Pallas kernel in interpret mode, on the
    same numpy polyhedra: x within 1e-5 of 1 + max |x|, max |v| within 1e-5
    relative, the same polyhedra witnessed outside the margin band."""
    from qpn_tpu.geometry.poly import Poly as RefPoly
    from qpn_tpu_torch.geometry import Poly
    from test_torch_screen import _reference
    w_ref, x_ref, v_ref, _ = _reference(monkeypatch, _k3_polys(RefPoly))
    assert screen_cuda.host_cluster_ranks(260, 240, HOPPER_SMEM_OPTIN) == 3

    def run(*args, **kw):
        return screen_cuda.screen_steps_host(*args, **kw, ranks=3)

    x, v = run(*_k3_inputs(), steps=SCREEN_STEPS, lr=SCREEN_LR)
    x, v = x.numpy(), v.numpy()
    scale = 1.0 + np.abs(x_ref).max(axis=1, keepdims=True)
    assert (np.abs(x - x_ref) / scale).max() <= SCREEN_TOL
    assert (np.abs(v - v_ref) / (1.0 + v_ref)).max() <= SCREEN_TOL
    w, _ = screen.feasibility_screen(_k3_polys(Poly), engine=run)
    near = np.abs(v_ref - 1e-3) <= SCREEN_TOL * (1 + 1e-3)
    assert not ((w != w_ref) & ~near).any()


def test_k3_host_ranks_must_be_positive():
    ins = _k3_inputs()
    with pytest.raises(ValueError, match="ranks"):
        screen_cuda.screen_steps_host(*ins, 1, SCREEN_LR, ranks=0)
