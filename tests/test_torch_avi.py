"""Parity of the port's batched KKT-AVI ensemble solve
(qpn_tpu_torch/ops/avi.py) with the JAX package's (qpn_tpu/ops/avi.py).

Small robust_avoid scenario ensembles (S=8 and S=16, T=2, num_obj=1; n=38
per lane) go through both packages from the same numpy arrays.  Every lane
must certify at ``tol``, and where both packages took the same number of
pivots, z must agree to 1e-9 (both land on an exact f64 refactorization of
a complementary basis).
"""

import numpy as np
import pytest
import torch

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import avi as ref_avi

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import avi, linalg
from qpn_tpu_torch.utils.metrics import METRICS

TOL = 1e-8


def _ensemble(S, seed):
    return scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                                num_poly_faces=4, seed=seed)


def _solve(b, **kw):
    t = avi.batch_from_numpy(b)
    return avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"],
                                   t["mask"], t["structure"], **kw)


@pytest.mark.parametrize("S,seed", [(8, 0), (16, 1)])
def test_solve_kkt_avi_batch_matches_reference(S, seed):
    b = _ensemble(S, seed)
    ref = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                      b["mask"], b["structure"], tol=TOL)
    res = _solve(b, tol=TOL)
    assert res.z.shape == (S, 38) and res.z.dtype == torch.float64
    assert bool(res.converged.all())
    assert float(res.resid.max()) <= TOL
    same = res.iters.numpy() == np.asarray(ref.iters)
    assert same.any()
    np.testing.assert_allclose(res.z.numpy()[same], np.asarray(ref.z)[same],
                               rtol=0, atol=1e-9)


def test_natural_residual_matches_reference():
    b = _ensemble(8, 0)
    rng = np.random.default_rng(5)
    z = rng.standard_normal(b["q"].shape)
    vm = b["mask"].copy()
    vm[:, -3:] = False
    t = avi.batch_from_numpy(b)
    r = avi.natural_residual(t["M"], t["q"], t["l"], t["u"],
                             torch.as_tensor(z), torch.as_tensor(vm))
    np.testing.assert_allclose(
        r.numpy(), ref_avi.natural_residual_np(b["M"], b["q"], b["l"],
                                               b["u"], z, vm),
        rtol=1e-13, atol=0)


def test_polish_matches_reference_on_perturbed_starts():
    """The f64 semismooth-Newton polish (batched in torch) follows the JAX
    package's vmapped one from starts perturbed off the solution."""
    b = _ensemble(8, 0)
    sol = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                      b["mask"], b["structure"], tol=TOL)
    rng = np.random.default_rng(11)
    z0 = np.asarray(sol.z) + 1e-3 * rng.standard_normal(b["q"].shape)
    ref = ref_avi.solve_avi_batch_polish(b["M"], b["q"], b["l"], b["u"], z0,
                                         b["mask"], tol=1e-10, max_iter=60)
    t = avi.batch_from_numpy(b)
    res = avi.solve_avi_batch_polish(t["M"], t["q"], t["l"], t["u"],
                                     torch.as_tensor(z0), t["mask"],
                                     tol=1e-10, max_iter=60)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.resid.numpy(), np.asarray(ref.resid),
                               rtol=0, atol=1e-10)


def test_admm_method_is_not_ported():
    with pytest.raises(NotImplementedError, match="ADMM route"):
        _solve(_ensemble(8, 0), tol=TOL, method="admm")


def test_shared_route_is_not_ported(monkeypatch):
    """A shared_M ensemble at or above shared_kkt_min_n belongs to the
    shared-matrix route (ROADMAP slice 3): the port raises instead of
    pivoting it."""
    monkeypatch.setattr(CONFIG, "shared_kkt_min_n", 38)
    with pytest.raises(NotImplementedError, match="slice 3"):
        _solve(_ensemble(8, 0), tol=TOL)
    monkeypatch.setattr(CONFIG, "shared_kkt_min_n", 39)
    assert bool(_solve(_ensemble(8, 0), tol=TOL).converged.all())


def test_uncertified_lanes_are_reported():
    """Lanes no stage can certify (here: a tolerance below f64 resolution)
    go through the polish and the f64 re-pivot, then come back with
    converged=False and are counted, where the JAX package would go on to
    ADMM."""
    b = _ensemble(8, 0)
    before = dict(METRICS.counters)
    res = _solve(b, tol=1e-300)
    bad = int((~res.converged).sum())
    assert bad > 0
    assert bool(torch.isfinite(res.z).all())
    for key, lanes in (("kkt_uncertified_lanes", bad),
                       ("kkt_repivot_lanes", bad)):
        assert METRICS.counters[key] - before.get(key, 0.0) == lanes
    assert METRICS.counters["kkt_polish_lanes"] > before.get(
        "kkt_polish_lanes", 0.0)


def test_batch_from_numpy_types():
    b = _ensemble(8, 0)
    t = avi.batch_from_numpy(b)
    for k in ("M", "q", "l", "u", "z0"):
        assert t[k].dtype == torch.float64
        np.testing.assert_array_equal(t[k].numpy(), b[k])
    assert t["mask"].dtype == torch.bool
    assert t["structure"] == b["structure"]


def test_ridge_solve_matches_normal_equations():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 6, 6))
    A[0, :, 0] = 0.0                       # rank-deficient lane
    rhs = rng.standard_normal((4, 6))
    eps = 1e-8
    want = np.stack([np.linalg.solve(a.T @ a + eps * np.eye(6), a.T @ r)
                     for a, r in zip(A, rhs)])
    got = linalg.ridge_solve(torch.as_tensor(A), torch.as_tensor(rhs), eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)
    # a factorization that fails gives NaN for its lane only
    K = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    K[1] = -K[1]
    x = linalg.chol_solve(K, torch.ones(2, 3, dtype=torch.float64))
    assert torch.equal(x[0], torch.ones(3, dtype=torch.float64))
    assert bool(torch.isnan(x[1]).all())
