"""The port's batched ADMM engine (``qpn_tpu_torch/ops/batch_qp.py``), its LP
pivot engines (``ops/lemke.solve_lp_host_batch`` / ``solve_lp_lemke_batch``)
and the native host helpers, against the JAX package on the same seeded
numpy inputs (JAX on the CPU).

Tolerances: both engines iterate in f64 and polish on the active set, so a
solved lane's x, y and objective agree to the polish's accuracy; the port
factors with LU where the JAX package takes QR, and its batched products sum
in another order, so a lane close to the eps test at a check boundary may stop
one 25-iteration block apart (seen: 775 against 750 iterations), which moves
x by at most the stopping tolerance.  The bound is 1e-7, two orders above the
largest difference measured (4e-10).  Statuses must be equal.
"""

import numpy as np
import pytest
import torch

from qpn_tpu.config import CONFIG as JCONFIG
from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import avi as ref_avi
from qpn_tpu.ops import batch_qp as ref_qp
from qpn_tpu.ops import lemke as ref_lemke
from qpn_tpu.utils import native as ref_native

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import avi, batch_qp, lemke
from qpn_tpu_torch.utils import native
from qpn_tpu_torch.utils.metrics import METRICS

# the engines run many tiny batched ops: intra-op threads make them no
# faster and contend with the other test workers
torch.set_num_threads(1)

TOL = 1e-7


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture(autouse=True)
def _reference_native_loaded(monkeypatch):
    """Load the JAX package's native library again where this worker lost
    the build race of its loader (``qpn_tpu/utils/native.py``: test workers
    build through one shared temporary name, and a loser keeps the
    pure-Python fallback for its life, whose ``quantize_hash`` is another
    hash).  By test time the winner's library is on disk."""
    if ref_native._LIB is None:
        monkeypatch.setattr(ref_native, "_TRIED", False)
        ref_native._load()


def _problems(kind, B=8, m=10, n=5, seed=1):
    """Seeded QPs/LPs with one masked padding row; ``pinf`` adds two
    contradictory rows, ``dinf`` leaves an LP unbounded below."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    c = rng.standard_normal((B, n))
    if kind == "qp":
        R = rng.standard_normal((B, n, n))
        P = np.einsum("bij,bkj->bik", R, R) / n
    else:
        P = np.zeros((B, n, n))
    ax = np.einsum("bmn,bn->bm", A, rng.standard_normal((B, n)))
    l = ax - rng.random((B, m))
    u = ax + rng.random((B, m))
    l[:, :2] = -np.inf
    if kind == "pinf":
        A[:, 1] = A[:, 0]
        l[:, 0], u[:, 0] = 1.0, np.inf
        l[:, 1], u[:, 1] = -np.inf, 0.0
    if kind == "dinf":
        l[:] = -np.inf
        u[:] = np.inf
        l[:, 2] = 0.0
    mask = np.ones((B, m), dtype=bool)
    mask[:, -1] = False
    A[:, -1] = 0.0
    return P, c, A, l, u, mask


def _assert_same(got, want):
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    ok = np.isin(got.status, (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE))
    for f in ("x", "y", "obj"):
        np.testing.assert_allclose(getattr(got, f)[ok],
                                   np.asarray(getattr(want, f))[ok],
                                   rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("kind", ["qp", "lp", "pinf", "dinf"])
def test_padded_solve_matches_reference(kind):
    args = _problems(kind)
    got = batch_qp.solve_qp_batch_padded(*args)
    want = ref_qp.solve_qp_batch_padded(*args)
    _assert_same(got, want)
    expect = {"qp": batch_qp.SOLVED, "lp": batch_qp.SOLVED,
              "pinf": batch_qp.PRIMAL_INFEASIBLE,
              "dinf": batch_qp.DUAL_INFEASIBLE}[kind]
    assert (got.status == expect).all()


@pytest.mark.parametrize("tier1", [25, 100])
def test_two_tier_stragglers_match_reference(monkeypatch, tier1):
    """A short first tier leaves stragglers that re-solve with the full
    budget; statuses, values and iteration counts (tier 1 included) follow
    the JAX package's."""
    monkeypatch.setattr(CONFIG, "admm_tier1_iters", tier1)
    monkeypatch.setattr(JCONFIG, "admm_tier1_iters", tier1)
    args = _problems("lp", B=12, seed=4)
    got = batch_qp.solve_qp_batch_padded(*args)
    want = ref_qp.solve_qp_batch_padded(*args)
    assert (got.iters >= tier1).any()
    _assert_same(got, want)
    assert (np.abs(got.iters - np.asarray(want.iters)) <= 25).all()


def _engine_both(args, **kw):
    """solve_qp_batch of both packages on the same numpy inputs."""
    t = [torch.as_tensor(a) for a in args]
    init = {k: torch.as_tensor(v) for k, v in kw.items()
            if k in ("x_init", "y_init")}
    rest = {k: v for k, v in kw.items() if k not in init}
    got = batch_qp.solve_qp_batch(*t, **init, **rest)
    want = ref_qp.solve_qp_batch(*args, **kw)
    return (batch_qp.QPSolution(*(v.numpy() for v in got)),
            batch_qp.QPSolution(*(np.asarray(v) for v in want)))


# x to 1e-9 where both polish (the polish lands the active set's solution);
# without the polish x is the ADMM iterate at its stopping block, which the
# two packages reach through sums in another order: 1e-9 still holds when
# they stop in the same block, and the stopping tolerance eps otherwise
@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("start", ["x", "y", "xy", "zeros"])
def test_warm_start_and_polish_flag_match_reference(start, polish):
    """x_init / y_init and polish=False against the JAX package: equal
    statuses, iteration counts within one 25-iteration block, x within 1e-9
    (same block) or eps."""
    args = _problems("qp", B=8, seed=11)
    P, c, A, l, u, mask = args
    cold, _ = _engine_both(args)
    rng = np.random.default_rng(5)
    kw = {}
    if "x" in start:
        kw["x_init"] = cold.x + 1e-3 * rng.standard_normal(cold.x.shape)
    if "y" in start:
        kw["y_init"] = cold.y + 1e-3 * rng.standard_normal(cold.y.shape)
    if start == "zeros":
        kw = dict(x_init=np.zeros_like(cold.x), y_init=np.zeros_like(cold.y))
    eps = 1e-6
    got, want = _engine_both(args, eps=eps, polish=polish, **kw)
    np.testing.assert_array_equal(got.status, want.status)
    assert np.isin(got.status, (batch_qp.SOLVED,
                                batch_qp.SOLVED_INACCURATE)).all()
    dk = np.abs(got.iters - want.iters)
    assert (dk <= 25).all()
    same = dk == 0
    assert same.any()
    tight = same | polish
    np.testing.assert_allclose(got.x[tight], want.x[tight], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=10 * eps)
    if start == "xy":
        # a start near the primal and dual solution pays: fewer iterations
        # than the cold solve's
        cold_eps, _ = _engine_both(args, eps=eps, polish=polish)
        assert got.iters.sum() < cold_eps.iters.sum()


def test_zero_start_is_not_the_cold_start():
    """Given x_init = 0 the engine starts z at clip(0, l, u), not at 0, as
    the JAX package does: other iterates than a call without a start."""
    args = _problems("qp", B=4, seed=12)
    t = [torch.as_tensor(a) for a in args]
    z0 = torch.zeros(4, 5, dtype=torch.float64)
    cold = batch_qp.solve_qp_batch(*t, max_iter=25, polish=False)
    warm = batch_qp.solve_qp_batch(*t, max_iter=25, polish=False, x_init=z0)
    assert not torch.equal(cold.x, warm.x)
    ref = ref_qp.solve_qp_batch(*args, max_iter=25, polish=False,
                                x_init=z0.numpy())
    np.testing.assert_allclose(warm.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)


def test_polish_false_leaves_the_admm_iterate():
    """polish=False returns the unpolished iterate: its residuals are those
    of the eps test (1e-4), where the polished solve is near 1e-9 (the polish
    regularises its KKT system by 1e-9)."""
    args = _problems("qp", B=6, seed=13)
    t = [torch.as_tensor(a) for a in args]
    raw = batch_qp.solve_qp_batch(*t, eps=1e-4, polish=False)
    pol = batch_qp.solve_qp_batch(*t, eps=1e-4, polish=True)
    assert torch.equal(raw.iters, pol.iters)
    assert float((pol.prim_res + pol.dual_res).max()) <= 1e-7
    assert float((raw.prim_res + raw.dual_res).min()) > 1e-7


def test_single_problem_wrapper_matches_reference():
    P, c, A, l, u, mask = _problems("qp", B=1, seed=7)
    got = batch_qp.solve_qp_np(P[0], c[0], A[0], l[0], u[0])
    want = ref_qp.solve_qp_np(P[0], c[0], A[0], l[0], u[0])
    assert int(got.status) == int(want.status) == batch_qp.SOLVED
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=TOL)
    assert got.x.shape == (5,) and got.obj.shape == ()


def test_admm_counts_its_work():
    before = dict(METRICS.counters)
    batch_qp.solve_qp_batch_padded(*_problems("lp", B=3))
    for key in ("admm_calls", "admm_lanes", "admm_blocks"):
        assert METRICS.counters[key] > before.get(key, 0.0)


@pytest.mark.parametrize("engine", ["host", "lemke"])
def test_lp_pivot_engines_match_reference(engine):
    """The native exact-shape engine and the batched pivot engine (with
    their ADMM fallbacks) against the JAX package's, on feasible and
    unbounded LPs: equal statuses, objectives within TOL."""
    P, c, A, l, u, mask = _problems("lp", B=6, seed=3)
    P2, c2, A2, l2, u2, mask2 = _problems("dinf", B=2, seed=5)
    args = (np.concatenate([c, c2]), np.concatenate([A, A2]),
            np.concatenate([l, l2]), np.concatenate([u, u2]),
            np.concatenate([mask, mask2]))
    if engine == "host":
        # the reference returns None without its native library
        assert ref_native.native_available()
        got = lemke.solve_lp_host_batch(*args)
        want = ref_lemke.solve_lp_host_batch(*args)
    else:
        got = lemke.solve_lp_lemke_batch(*args)
        want = ref_lemke.solve_lp_lemke_batch(*args)
    _assert_same(got, want)
    assert (got.status[:6] == batch_qp.SOLVED).all()
    assert (got.status[6:] == batch_qp.DUAL_INFEASIBLE).all()


@pytest.mark.parametrize("route", ["prefer", "config"])
def test_prefer_lemke_routes_pure_lps(monkeypatch, route):
    """_prefer_lemke, or lp_engine="lemke", sends pure LPs to the pivot
    engine: same statuses and objectives as the ADMM route."""
    args = _problems("lp", B=4, seed=9)
    admm = batch_qp.solve_qp_batch_padded(*args)
    before = METRICS.counters.get("lp_lemke", 0.0)
    if route == "config":
        monkeypatch.setattr(CONFIG, "lp_engine", "lemke")
    piv = batch_qp.solve_qp_batch_padded(*args,
                                         _prefer_lemke=route == "prefer")
    assert METRICS.counters["lp_lemke"] == before + 4
    np.testing.assert_array_equal(piv.status, admm.status)
    np.testing.assert_allclose(piv.obj, admm.obj, rtol=0, atol=TOL)


def test_native_helpers_match_reference():
    assert native.library_path().exists()
    # the reference's pure-Python fallback hashes with Python's hash
    assert ref_native.native_available()
    sets = [[0, 2], [1], [3, 4, 5]]
    np.testing.assert_array_equal(native.recipe_product(sets, 4),
                                  ref_native.recipe_product(sets, 4))
    rng = np.random.default_rng(0)
    data = np.round(rng.standard_normal((6, 3)), 3)
    np.testing.assert_array_equal(native.quantize_hash(data),
                                  ref_native.quantize_hash(data))
    M = np.eye(3)[None] * 2.0
    q = np.array([[-1.0, 2.0, 0.5]])
    lo, hi = np.zeros((1, 3)), np.full((1, 3), np.inf)
    for a, b in zip(native.lemke_batch(M, q, lo, hi),
                    ref_native.lemke_batch(M, q, lo, hi)):
        np.testing.assert_array_equal(a, b)


def test_kkt_admm_route_matches_reference():
    """solve_kkt_avi_batch(method="admm"): the QP recovered from the KKT
    blocks, ADMM, (λ, s) rebuilt and polished — every lane certified, z
    within 1e-8 of the JAX package's (the KKT solution is unique)."""
    b = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    want = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                       b["mask"], b["structure"], tol=1e-8,
                                       method="admm")
    t = avi.batch_from_numpy(b)
    got = avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"], t["mask"],
                                  t["structure"], tol=1e-8, method="admm")
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0,
                               atol=1e-8)
