"""Parity of the port's generic AVI ensemble solve (qpn_tpu_torch/ops/avi.py:
the hybrid solver and its mixed, padded and adaptive wrappers; ops/lemke.py:
``solve_lemke_batch_padded`` and ``lemke_escalate``) with the JAX package's
(qpn_tpu/ops/avi.py, qpn_tpu/ops/lemke.py).

The same numpy inputs, made from a seed, go through both packages:
robust_avoid scenario ensembles at S=8 (n=38 per lane), and the
non-monotone batch of ``tests/test_ops.py::test_adaptive_onchip_guard``.

Tolerances and why:
* f64 hybrid solve: ``iters`` and ``converged`` equal lane for lane, and z
  to 1e-9 on certified lanes (both end on the same Newton iterate; sums in
  another order move it by a few ulps).  No lane of these cases sits at an
  Armijo tie; a lane that did would be named here and compared by z and
  residual only.
* Mixed precision: f32 Cholesky factorizations and f32 sums differ between
  XLA and PyTorch, so f32 iteration counts may differ; every lane must
  certify and z agree within 1e-6 (the solution is unique to that
  precision on these ensembles).
* Lemke escalation: residuals no worse than the JAX package's, up to the
  tolerance (both end on exact complementary bases refactorized in f64).
"""

import numpy as np
import pytest
import torch

from qpn_tpu import config as ref_config
from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import avi as ref_avi
from qpn_tpu.ops import lemke as ref_lemke
from qpn_tpu.ops import pallas_kernels as ref_pk

from qpn_tpu_torch import config
from qpn_tpu_torch.ops import avi, eg, lemke
from qpn_tpu_torch.utils.metrics import METRICS

TOL = 1e-8
KEYS = ("M", "q", "l", "u", "z0", "mask")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(config.CONFIG, "device", "cpu")


def _flagship(S=8, seed=0):
    b = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                             num_poly_faces=4, seed=seed)
    return tuple(b[k] for k in KEYS)


def _non_monotone():
    """tests/test_ops.py::test_adaptive_onchip_guard's batch."""
    rng = np.random.default_rng(0)
    B, n = 8, 6
    Ms, qs = [], []
    for _ in range(B):
        G = rng.standard_normal((n, n))
        Ms.append(G - G.T + rng.standard_normal((n, n)))
        qs.append(rng.standard_normal(n))
    return (np.array(Ms), np.array(qs), np.zeros((B, n)),
            np.full((B, n), np.inf), np.zeros((B, n)),
            np.ones((B, n), dtype=bool))


def _far_start(problem, scale=1e4, seed=0):
    """The same lanes from z0 = scale·N(0, 1): stragglers for a short
    budget."""
    rng = np.random.default_rng(seed)
    z0 = scale * rng.standard_normal(problem[1].shape)
    return problem[:4] + (z0,) + problem[5:]


def _t(problem):
    return [torch.as_tensor(a) for a in problem]


@pytest.mark.parametrize("buckets", [(16, 64, 256, 1024),
                                     (1, 8, 64, 512, 2048)])
@pytest.mark.parametrize("n", [-1, 0, 1, 8, 9, 38, 64, 65, 1024, 1025, 5000])
def test_bucket_matches_reference(n, buckets):
    assert config.bucket(n, buckets) == ref_config.bucket(n, buckets)


def test_bucket_tuples_match_reference():
    assert config.CONFIG.row_buckets == ref_config.CONFIG.row_buckets
    assert config.CONFIG.batch_buckets == ref_config.CONFIG.batch_buckets


@pytest.mark.parametrize("case,max_iter", [
    ("flagship_seed0", 390), ("flagship_seed1", 390),
    ("flagship_seed0", 1), ("non_monotone", 390)])
def test_solve_avi_batch_matches_reference(case, max_iter):
    problem = (_non_monotone() if case == "non_monotone"
               else _flagship(seed=int(case[-1])))
    ref = ref_avi.solve_avi_batch(*problem, tol=TOL, max_iter=max_iter)
    res = avi.solve_avi_batch(*_t(problem), tol=TOL, max_iter=max_iter)
    assert res.z.dtype == torch.float64
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    conv = np.asarray(ref.converged)
    np.testing.assert_array_equal(res.converged.numpy(), conv)
    np.testing.assert_allclose(res.z.numpy()[conv], np.asarray(ref.z)[conv],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.resid.numpy()[~conv],
                               np.asarray(ref.resid)[~conv], rtol=1e-6)
    if case.startswith("flagship"):
        assert conv.all()


def test_solve_avi_batch_masked_variables():
    """Padded variables stay pinned at 0 and the real lanes solve as
    before."""
    problem = list(_flagship())
    problem[5] = problem[5].copy()
    problem[5][:, -2:] = False
    ref = ref_avi.solve_avi_batch(*problem, tol=TOL, max_iter=390)
    res = avi.solve_avi_batch(*_t(problem), tol=TOL, max_iter=390)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert (res.z.numpy()[:, -2:] == 0.0).all()
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-9)


def test_solve_avi_batch_mixed_matches_reference():
    problem = _flagship()
    ref = ref_avi.solve_avi_batch_mixed(*problem, tol=TOL, max_iter=390)
    res = avi.solve_avi_batch_mixed(*_t(problem), tol=TOL, max_iter=390)
    assert res.z.dtype == torch.float64
    assert np.asarray(ref.converged).all() and bool(res.converged.all())
    assert float(res.resid.max()) <= TOL
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-6)


def test_solve_avi_batch_padded_matches_reference():
    """n=38 pads to 64 in both packages; the padding rows enter the
    extragradient step, and the lanes end as in the JAX package."""
    problem = _flagship()
    ref = ref_avi.solve_avi_batch_padded(*problem, tol=TOL, max_iter=390)
    res = avi.solve_avi_batch_padded(*_t(problem), tol=TOL, max_iter=390)
    assert res.z.shape == (8, 38)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-9)


def test_solve_avi_batch_padded_at_a_bucket_size():
    """n already a bucket size: no padding, the plain solve."""
    rng = np.random.default_rng(2)
    B, n = 3, 16
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)
    problem = (M, rng.standard_normal((B, n)), np.zeros((B, n)),
               np.full((B, n), np.inf), np.zeros((B, n)),
               np.ones((B, n), dtype=bool))
    res = avi.solve_avi_batch_padded(*_t(problem), tol=TOL, max_iter=390)
    plain = avi.solve_avi_batch(*_t(problem), tol=TOL, max_iter=390)
    assert torch.equal(res.z, plain.z) and bool(res.converged.all())


def test_solve_avi_batch_padded_rejects_sharding():
    """``_sharding`` takes a ``parallel.mesh`` Sharding (or Mesh) and
    rejects anything else; over a one-rank mesh it is the plain padded
    solve (the multi-rank cases are in ``test_torch_parallel.py``)."""
    from qpn_tpu_torch.parallel import mesh
    with pytest.raises(TypeError, match="Sharding"):
        avi.solve_avi_batch_padded(*_t(_flagship(S=1)), _sharding=object())
    one = mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                    device=torch.device("cpu"), backend="gloo")
    args = _t(_flagship(S=3))
    res = avi.solve_avi_batch_padded(*args, tol=TOL, max_iter=390,
                                     _sharding=mesh.scenario_sharding(one))
    plain = avi.solve_avi_batch_padded(*args, tol=TOL, max_iter=390)
    assert all(torch.equal(a, b) for a, b in zip(res, plain))


def _accepted(problem, z_eg):
    M, q, l, u, z0, mask = problem
    r_eg = ref_avi.natural_residual_np(M, q, l, u, z_eg, mask)
    r_0 = ref_avi.natural_residual_np(M, q, l, u, z0, mask)
    return np.isfinite(r_eg) & (r_eg < r_0)


@pytest.mark.parametrize("case", ["flagship", "non_monotone"])
def test_adaptive_matches_reference(case):
    """The EG pre-pass (300 steps) accepts the same lanes in both packages,
    and the same lanes certify."""
    problem = _flagship() if case == "flagship" else _non_monotone()
    acc_ref = _accepted(problem, ref_pk.eg_warmstart(*problem, steps=300))
    acc = _accepted(problem, eg.eg_warmstart(*_t(problem), steps=300)
                    .numpy())
    np.testing.assert_array_equal(acc, acc_ref)
    ref = ref_avi.solve_avi_batch_adaptive(*problem, tol=TOL,
                                           onchip_eg_steps=300)
    METRICS.reset()
    res = avi.solve_avi_batch_adaptive(*_t(problem), tol=TOL,
                                       onchip_eg_steps=300)
    assert METRICS.counters["eg_accepted_lanes"] == acc_ref.sum()
    conv = np.asarray(ref.converged)
    np.testing.assert_array_equal(res.converged.numpy(), conv)
    assert np.isfinite(res.resid.numpy()).all()
    np.testing.assert_allclose(res.z.numpy()[conv], np.asarray(ref.z)[conv],
                               rtol=0, atol=1e-6)
    r_ref = np.asarray(ref.resid)
    assert (res.resid.numpy() <= np.maximum(r_ref * (1 + 1e-6), TOL)).all()
    if case == "flagship":
        assert conv.all()


def test_adaptive_f64_iters_match_reference():
    """mixed=False, no pre-pass: the first budget stage is the f64 hybrid
    solve, so iteration counts match lane for lane."""
    problem = _flagship(seed=1)
    ref = ref_avi.solve_avi_batch_adaptive(*problem, tol=TOL, mixed=False)
    res = avi.solve_avi_batch_adaptive(*_t(problem), tol=TOL, mixed=False)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-9)


def test_adaptive_forced_stragglers_escalate():
    """Far starts and one budget stage leave the lanes to lemke_escalate,
    which certifies them as in the JAX package."""
    problem = _far_start(_flagship())
    ref = ref_avi.solve_avi_batch_adaptive(*problem, tol=TOL, budgets=(1,))
    METRICS.reset()
    res = avi.solve_avi_batch_adaptive(*_t(problem), tol=TOL, budgets=(1,))
    assert METRICS.counters["escalated_lanes"] > 0
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    assert bool(res.converged.all())
    r = ref_avi.natural_residual_np(*problem[:4], res.z.numpy(), problem[5])
    assert r.max() <= TOL


@pytest.mark.parametrize("case", ["flagship_far", "non_monotone"])
def test_lemke_escalate_matches_reference(case):
    problem = (_far_start(_flagship()) if case == "flagship_far"
               else _non_monotone())
    z_ref, r_ref = ref_lemke.lemke_escalate(*problem, tol=TOL)
    z, r = lemke.lemke_escalate(*_t(problem), tol=TOL)
    assert z.dtype == torch.float64 and z.shape == z_ref.shape
    r = r.numpy()
    assert (r <= np.maximum(np.asarray(r_ref) * (1 + 1e-6), TOL)).all()
    np.testing.assert_array_equal(r <= TOL, np.asarray(r_ref) <= TOL)
    audit = ref_avi.natural_residual_np(*problem[:4], z.numpy(), problem[5])
    np.testing.assert_allclose(audit, r, rtol=1e-6, atol=1e-15)


def test_solve_lemke_batch_padded_matches_reference():
    """f64 pivoting at the exact shape takes the path the JAX package takes
    on the lane padded to 64: same status and pivots, z to 1e-9."""
    problem = _flagship()
    z_ref, st_ref, piv_ref = ref_lemke.solve_lemke_batch_padded(*problem,
                                                                tol=TOL)
    z, st, piv = lemke.solve_lemke_batch_padded(*_t(problem), tol=TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(piv_ref))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("n,expected", [(7, 512), (38, 1280), (200, 4096)])
def test_solve_lemke_batch_padded_pivot_budget(monkeypatch, n, expected):
    """The pivot budget is sized from the row bucket of n, as in the JAX
    package: min(4096, 16·bucket(n) + 256)."""
    seen = {}
    real = lemke.solve_lemke_batch_state_auto

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(lemke, "solve_lemke_batch_state_auto", spy)
    M = torch.eye(n, dtype=torch.float64)[None]
    v = torch.zeros(1, n, dtype=torch.float64)
    lemke.solve_lemke_batch_padded(M, v - 1.0, v, v + 2.0, v,
                                   torch.ones(1, n, dtype=torch.bool))
    assert seen["max_pivots"] == expected
