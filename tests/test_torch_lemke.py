"""Parity of the port's batched Lemke engine (qpn_tpu_torch/ops/lemke.py)
with the JAX package's (qpn_tpu/ops/lemke.py, lemke_pallas.py).

The same numpy inputs, made from a seed, go through both packages in f32
with the hot-route settings (tol 1e-6, piv_tol 1e-5).  The contract is the
one ``tests/test_lemke_pallas.py`` holds the Pallas kernel to: identical
status and pivot counts on every lane, and terminal bases that refactorize
(in f64, on the original data) to natural residuals below 1e-9.  Bases may
differ on degenerate lanes, where f32 summation order decides ties.

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, marked ``gpu``.
"""

import numpy as np
import pytest
import torch

from qpn_tpu.ops.lemke import (refactor_batch_np,
                               solve_lemke_batch as ref_solve_lemke_batch,
                               solve_lemke_batch_state as ref_state)
from qpn_tpu.ops.lemke_pallas import solve_lemke_batch_state_pallas

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import lemke
from qpn_tpu_torch.ops.avi import natural_residual
from qpn_tpu_torch.ops.lemke_cuda import lemke_pivot_cuda
from qpn_tpu_torch.utils.metrics import METRICS

HOT = dict(tol=1e-6, piv_tol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _rand_psd_lcp(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    return M, q, np.zeros((B, n)), np.full((B, n), np.inf), \
        np.ones((B, n), bool)


def _random_pd():
    rng = np.random.default_rng(3)
    B, n = 8, 12
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.full((B, n), -np.inf)
    u = np.full((B, n), np.inf)
    l[:, :4] = 0.0
    u[:, 4:7] = 0.5          # finite boxes exercise bound flips
    l[:, 7] = u[:, 7] = 0.3  # pinned row
    return M, q, l, u, np.ones((B, n), bool)


def _padded_solved_at_start():
    rng = np.random.default_rng(7)
    B, n, nv = 4, 10, 6                      # last 4 vars are padding
    A = rng.standard_normal((B, nv, nv))
    M = np.zeros((B, n, n))
    M[:, :nv, :nv] = np.einsum("bij,bkj->bik", A, A) + 0.2 * np.eye(nv)
    q = np.zeros((B, n))
    q[:, :nv] = rng.standard_normal((B, nv))
    q[0, :nv] = np.abs(q[0, :nv]) + 0.1      # lane 0: z=0 solves it
    vm = np.zeros((B, n), dtype=bool)
    vm[:, :nv] = True
    return M, q, np.zeros((B, n)), np.full((B, n), np.inf), vm


# (name, problem factory, max_pivots): the cases of test_lemke_pallas.py
CASES = [
    ("random_pd", _random_pd, 1024),
    ("padded_solved_at_start", _padded_solved_at_start, 1024),
    ("batch_3", lambda: _rand_psd_lcp(3, 7, seed=3), 1024),
    ("batch_13", lambda: _rand_psd_lcp(13, 7, seed=13), 1024),
    ("budget_4", lambda: _rand_psd_lcp(8, 12, seed=7), 4),
    ("budget_8", lambda: _rand_psd_lcp(8, 12, seed=7), 8),
    ("budget_1024", lambda: _rand_psd_lcp(8, 12, seed=7), 1024),
]


def tensors(dtype, *arrays):
    return [torch.as_tensor(np.asarray(a, dtype=dtype)) for a in arrays]


def reference_state(M, q, l, u, vm, max_pivots, dtype=np.float32, **kw):
    """The JAX package's XLA engine: (z, status, pivots, basis, val)."""
    B, n = q.shape
    kw = kw or HOT
    f = [np.asarray(a, dtype=dtype) for a in (M, q, l, u)]
    return tuple(np.asarray(a) for a in ref_state(
        *f, np.zeros((B, n), dtype), np.asarray(vm, bool),
        max_pivots=max_pivots, **kw))


def port_state(M, q, l, u, vm, max_pivots, pivot, dtype=np.float32, **kw):
    """The port's engine with the given pivot loop, on CPU tensors."""
    B, n = q.shape
    kw = kw or HOT
    return lemke.solve_lemke_batch_state(
        *tensors(dtype, M, q, l, u, np.zeros((B, n))),
        torch.as_tensor(np.asarray(vm, bool)), pivot=pivot,
        max_pivots=max_pivots, **kw)


def refactor_resid(M, q, l, u, vm, basis, val):
    data = tensors(np.float64, M, q, l, u)
    vmt = torch.as_tensor(np.asarray(vm, bool))
    z, ok = lemke.refactor_batch(*data, basis, val, vmt)
    return z, ok, natural_residual(*data, z, vmt)


def assert_same_path(port, ref, problem, check_resid=True):
    """Equal status and pivot counts lane for lane; SUCCESS lanes refactor
    to residual < 1e-9."""
    z, st, piv, basis, val = port
    np.testing.assert_array_equal(st.numpy(), ref[1])
    np.testing.assert_array_equal(piv.numpy(), ref[2])
    if check_resid:
        _, ok, r = refactor_resid(*problem, basis, val)
        succ = st == lemke.LEMKE_SUCCESS
        assert bool(ok[succ].all())
        assert bool((r[succ] < 1e-9).all())


@pytest.mark.parametrize("name,build,max_pivots", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_loop_matches_xla_engine(name, build, max_pivots):
    problem = build()
    ref = reference_state(*problem, max_pivots)
    port = port_state(*problem, max_pivots, lemke.lemke_pivot_torch)
    assert_same_path(port, ref, problem)
    assert (port[2].numpy() <= max_pivots).all()
    if max_pivots == 1024:
        assert (port[1] == lemke.LEMKE_SUCCESS).all()
    if name == "padded_solved_at_start":
        assert int(port[2][0]) == 0           # solved-at-start short-circuit
        assert (port[0][:, 6:] == 0).all()    # padded variables stay 0


def test_plain_loop_matches_pallas_interpret_on_scenarios():
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    b = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    problem = (b["M"], b["q"], b["l"], b["u"], b["mask"])
    B, n = b["q"].shape
    f = [np.asarray(a, np.float32) for a in problem[:4]]
    ref = tuple(np.asarray(a) for a in solve_lemke_batch_state_pallas(
        *f, np.zeros((B, n), np.float32), b["mask"], max_pivots=1024,
        interpret=True, **HOT))
    port = port_state(*problem, 1024, lemke.lemke_pivot_torch)
    assert_same_path(port, ref, problem)
    assert (port[1] == lemke.LEMKE_SUCCESS).all()


@pytest.mark.parametrize("name,build", [CASES[0][:2], CASES[3][:2]],
                         ids=[CASES[0][0], CASES[3][0]])
def test_plain_loop_f64_matches_numpy_oracle(name, build):
    """In f64 the batched loop follows the port's single-instance numpy
    oracle (solve_lemke_np, the JAX package's host reference) lane for
    lane; the refactorized z equals the oracle's."""
    M, q, l, u, vm = build()
    F64 = dict(tol=1e-11, piv_tol=1e-11)
    z, st, piv, basis, val = port_state(M, q, l, u, vm, 1024,
                                        lemke.lemke_pivot_torch,
                                        dtype=np.float64, **F64)
    zr, _, _ = refactor_resid(M, q, l, u, vm, basis, val)
    for b in range(q.shape[0]):
        z_o, st_o, piv_o = lemke.solve_lemke_np(M[b], q[b], l[b], u[b],
                                                max_pivots=1024, **F64)
        assert (int(st[b]), int(piv[b])) == (st_o, piv_o)
        np.testing.assert_allclose(zr[b].numpy(), z_o, rtol=0, atol=1e-9)


@pytest.mark.parametrize("max_pivots", [4, 1024])
def test_refactor_batch_matches_numpy(max_pivots):
    """refactor_batch (torch, f64) equals the JAX package's host
    refactor_batch_np; the budget-4 outcomes keep t basic (ok=False)."""
    problem = _random_pd()
    M, q, l, u, vm = problem
    _, _, _, basis, val = port_state(*problem, max_pivots,
                                     lemke.lemke_pivot_torch)
    z, ok = lemke.refactor_batch(*tensors(np.float64, M, q, l, u), basis,
                                 val, torch.as_tensor(vm))
    z_ref, ok_ref = refactor_batch_np(M, q, l, u, basis.numpy(), val.numpy(),
                                      vm)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    if max_pivots == 4:
        assert not ok_ref.any()
    # the same LU solve up to summation order: 1e-12 relative (the
    # budget-4 lanes solve garbage bases with entries near 1e4)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-12, atol=1e-12)


def test_setup_matches_reference_lane():
    """lemke_setup (batched torch) builds the JAX package's start state."""
    import jax
    from qpn_tpu.ops.lemke import _lemke_setup
    M, q, l, u, vm = _random_pd()
    B, n = q.shape
    init = lemke.lemke_setup(*tensors(np.float64, M, q, l, u,
                                      np.zeros((B, n))),
                             torch.as_tensor(vm), tol=1e-9)
    ref = jax.vmap(lambda *a: _lemke_setup(*a, tol=1e-9, synth_scale=1e4,
                                           cover="viol"))(
        M, q, l, u, np.zeros((B, n)), vm)
    np.testing.assert_allclose(init.T.numpy(), np.asarray(ref.T1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(init.basis.numpy(), np.asarray(ref.basis1))
    np.testing.assert_array_equal(init.ent.numpy(), np.asarray(ref.ent0))
    np.testing.assert_array_equal(init.var_lb.numpy(), np.asarray(ref.var_lb))
    np.testing.assert_array_equal(init.var_ub.numpy(), np.asarray(ref.var_ub))
    np.testing.assert_allclose(init.ev.numpy(), np.asarray(ref.ev0), rtol=0,
                               atol=1e-12)


def test_auto_dispatch_takes_plain_loop_for_cpu_tensors(monkeypatch):
    """CONFIG.lemke_kernel="auto" runs CPU tensors through the plain loop
    (no kernel launch counted); "cuda" raises on CPU tensors instead of
    falling back."""
    problem = _rand_psd_lcp(3, 7, seed=3)
    B, n = problem[1].shape
    args = (*tensors(np.float32, *problem[:4], np.zeros((B, n))),
            torch.as_tensor(problem[4]))
    before = METRICS.launches["lemke_pivot"]
    z, st, piv, _, _ = lemke.solve_lemke_batch_state_auto(
        *args, max_pivots=1024, **HOT)
    assert (st == lemke.LEMKE_SUCCESS).all()
    assert METRICS.launches["lemke_pivot"] == before
    monkeypatch.setattr(CONFIG, "lemke_kernel", "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        lemke.solve_lemke_batch_state_auto(*args, max_pivots=1024, **HOT)
    monkeypatch.setattr(CONFIG, "lemke_kernel", "bogus")
    with pytest.raises(ValueError, match="lemke_kernel"):
        lemke.solve_lemke_batch_state_auto(*args, max_pivots=1024, **HOT)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    problem = _rand_psd_lcp(3, 7, seed=3)
    B, n = problem[1].shape
    init = lemke.lemke_setup(*tensors(np.float32, *problem[:4],
                                      np.zeros((B, n))),
                             torch.as_tensor(problem[4]), tol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lemke_pivot_cuda(init, max_pivots=16, **HOT)
    from qpn_tpu_torch.ops import lemke_cuda
    with pytest.raises(ValueError, match="basis"):
        lemke_cuda._INPUTS(init._replace(basis=init.basis.long()), "cpu")
    with pytest.raises(ValueError, match="not contiguous"):
        lemke_cuda._INPUTS(init._replace(val=init.val.t().contiguous().t()),
                           "cpu")
    with pytest.raises(TypeError, match="dtype"):
        lemke_cuda._INPUTS(init._replace(T=init.T.half()), "cpu")


# Natural-residual bounds of solve_lemke_batch's z, set from the dtype:
# f64 pivoting lands ~1e-14; f32 about a thousand ulps at these magnitudes.
Z_AUDIT = {np.float64: 1e-10, np.float32: 1e-4}


def _natural_residual_np(M, q, l, u, z, vm):
    F = np.einsum("bij,bj->bi", M, z) + q
    return np.abs(np.where(vm, z - np.clip(z - F, l, u), 0.0)).max(1)


@pytest.mark.parametrize("cover", ["viol", "all"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("data", ["psd", "pd_boxes"])
def test_solve_lemke_batch_matches_reference(data, dtype, cover):
    """The public (z, status, pivots) view against the JAX package's on
    seeded lanes: equal status and pivot counts; z audited by natural
    residual (bases are never compared, ROADMAP queue 3)."""
    M, q, l, u, vm = (_rand_psd_lcp(16, 10, 0) if data == "psd"
                      else _random_pd())
    kw = HOT if dtype == np.float32 else {}
    args = [a.astype(dtype) for a in (M, q, l, u)] + \
        [np.zeros(q.shape, dtype), vm]
    got = lemke.solve_lemke_batch(*args, cover=cover, **kw)
    want = ref_solve_lemke_batch(*args, cover=cover, **kw)
    assert isinstance(got, lemke.LemkeResult)
    assert got.z.dtype == torch.from_numpy(args[1]).dtype
    assert got.z.device.type == "cpu"
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got.pivots.numpy(), np.asarray(want[2]))
    assert (got.status.numpy() == lemke.LEMKE_SUCCESS).all()
    res = _natural_residual_np(M, q, l, u, got.z.numpy().astype(float), vm)
    assert res.max() <= Z_AUDIT[dtype]


def test_solve_lemke_batch_follows_the_numeric_device(monkeypatch):
    """Numpy inputs go to config.numeric_device(): with the card asked for
    and none here, the call raises; tensors keep their own device."""
    M, q, l, u, vm = _rand_psd_lcp(4, 6, 1)
    z0 = np.zeros_like(q)
    monkeypatch.setattr(CONFIG, "device", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CONFIG.device"):
            lemke.solve_lemke_batch(M, q, l, u, z0, vm)
    t = [torch.from_numpy(a) for a in (M, q, l, u, z0, vm)]
    res = lemke.solve_lemke_batch(*t)
    assert res.z.device.type == "cpu"
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(ref_solve_lemke_batch(
                                      M, q, l, u, z0, vm)[1]))
