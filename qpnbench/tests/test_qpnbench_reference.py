"""The plain reference: its statement of the model equals the program's
assembly, it judges the program's answers on a tiny ensemble as solved, its
own float64 solve passes the check and the control (its float32 solve in the
program's place) fails it."""

import numpy as np
import pytest
import torch

from qpnbench import traffic
from qpnbench.reference import check, lemke
from qpnbench.reference import robust_avoid as ref
from qpnbench.tests.small_bench import one_thread

MIX = {"lanes": 8, "pool": 2, "pool_seed": 0, "position_sigma": 1.0,
       "bound_jitter": 0.05}
TOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def config(T, K):
    return dict(T=T, num_obj=K, num_poly_faces=4, model_seed=0)


@pytest.mark.parametrize("T, K, n", [(2, 1, 38), (5, 2, 190), (3, 3, 171)])
def test_statement_equals_the_programs_assembly(T, K, n):
    from qpnbench.models import robust_avoid as model
    sys_ = model.assemble(config(T, K))
    prob = ref.problem(config(T, K))
    assert prob.M.shape == (n, n)
    assert np.array_equal(prob.M, sys_.M)
    draws = traffic.draw_pool(dict(MIX, pool_seed=3001234567), sys_.shifted,
                              n)
    q, l, u = model.lanes(sys_, draws.shift, draws.jitter)
    rq, rl, ru = ref.lanes(prob, draws.shift, draws.jitter)
    assert np.abs(q - rq).max() <= 1e-14 * (1 + np.abs(q).max())
    assert np.array_equal(l, rl) and np.array_equal(u, ru)
    assert (prob.nd, prob.m) == (sys_.structure["nd"], sys_.structure["m"])


def _lanes(T, K, seed):
    prob = ref.problem(config(T, K))
    draws = traffic.draw_pool(dict(MIX, pool_seed=seed), prob.dq.shape[1],
                              prob.M.shape[0])
    q, l, u = ref.lanes(prob, draws.shift, draws.jitter)
    return prob, q[0], l[0], np.ascontiguousarray(u[0])


def _reference_solve(prob, q, l, u, dtype):
    n = prob.M.shape[0]
    M = torch.as_tensor(prob.M, dtype=dtype).expand(len(q), n, n)
    settings = lemke.F32 if dtype == torch.float32 else lemke.F64
    z, status, _ = lemke.solve(
        M.contiguous(), *(torch.as_tensor(a, dtype=dtype) for a in (q, l, u)),
        max_pivots=lemke.max_pivots(n), **settings)
    assert bool((status == lemke.SUCCESS).all())
    return z.double().numpy()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 1])
def test_reference_float64_solve_passes(seed):
    prob, q, l, u = _lanes(2, 1, seed)
    z = _reference_solve(prob, q, l, u, torch.float64)
    assert check.residuals(prob.M, q, l, u, z).max() <= TOL


@pytest.mark.parametrize("T, K", [(2, 1), (5, 2)])
def test_control_float32_fails(T, K):
    """The control: the reference in float32 in the program's place."""
    prob, q, l, u = _lanes(T, K, 5)
    z = _reference_solve(prob, q, l, u, torch.float32)
    assert check.residuals(prob.M, q, l, u, z).max() > 10 * TOL


def test_programs_answers_pass_on_a_tiny_ensemble(monkeypatch):
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.ops.avi import solve_kkt_avi_batch
    from qpnbench.models import robust_avoid as model
    monkeypatch.setattr(CONFIG, "device", "cpu")
    sys_ = model.assemble(config(2, 1))
    prob, q, l, u = _lanes(2, 1, 17)
    n = prob.M.shape[0]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  dtype=torch.float64)
    res = solve_kkt_avi_batch(t(sys_.M).expand(len(q), n, n).contiguous(),
                              t(q), t(l), t(u),
                              torch.ones(len(q), n, dtype=torch.bool),
                              sys_.structure, tol=TOL)
    assert bool(res.converged.all())
    r = check.residuals(prob.M, q, l, u, res.z.numpy())
    assert r.max() <= TOL
    # a z moved off the solution is judged unsolved
    bad = res.z.numpy().copy()
    bad[3, 7] += 1e-6 * (1 + abs(bad[3, 7]))
    r = check.residuals(prob.M, q, l, u, bad)
    assert r[3] > TOL and np.delete(r, 3).max() <= TOL


def test_non_finite_answer_is_unsolved():
    prob, q, l, u = _lanes(2, 1, 1)
    z = np.full(q.shape, np.nan)
    assert np.isinf(check.residuals(prob.M, q, l, u, z)).all()
