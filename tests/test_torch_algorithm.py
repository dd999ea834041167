"""The port's algorithm layer against the JAX package's, on the cases of
``tests/test_algorithm.py``: ``verify_solution`` (interior, active, the
feasibility gate), the convexity audits, cycling detection and its
perturbation recovery, the combine width guard and shortcut,
``intersection_iter``, ``solve_qep``, variable elimination,
``get_single_solution`` and the MIN_NORM shared-variable mode.

Each case is one function of a package's modules, run on both packages with
the same numpy inputs.  Verdicts, counts, statuses and messages must be
equal; numbers from an engine (duals, QEP points, eliminated polyhedra)
agree within ``TOL`` = 1e-6, the x_opt tolerance of the zoo's parity tests
(both packages solve to ~1e-10).  Each case also checks the JAX test's own
property on the port's result.
"""

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG

from _torch_parity import assert_same, clear_query_caches, run_both

torch.set_num_threads(1)

TOL = 1e-6
INF = np.inf


@pytest.fixture(autouse=True)
def _cpu_and_fresh_caches(monkeypatch):
    """The port runs on the CPU here (its default is the card); both
    packages' content-keyed query caches start empty."""
    monkeypatch.setattr(CONFIG, "device", "cpu")
    clear_query_caches()


def _qp(M, Q, q, cons, vars_):
    net = M("network")
    return net.QP(f=net.Quadratic(np.asarray(Q), np.asarray(q), 0.0),
                  constraint_indices=cons, var_indices=vars_)


def _verify_interior(M):
    alg = M("algorithm")
    qp = _qp(M, [[2.0]], [-2.0], [], [0])
    return [alg.verify_solution(qp, 1, [], [0], np.array([x])).solution
            for x in (1.0, 0.5)]


def _verify_active(M):
    alg, P = M("algorithm"), M("geometry.poly").Poly
    qp = _qp(M, [[0.0]], [1.0], [1], [0])
    box = P(np.array([[1.0]]), [0.0], [INF])
    rets = [alg.verify_solution(qp, 1, [box], [0], np.array([x]))
            for x in (0.0, 1.0, -1.0)]
    return [[r.solution for r in rets], float(rets[0].lam[0]), rets[2].e]


def _verify_feas_tol(M):
    alg, P = M("algorithm"), M("geometry.poly").Poly
    qp = _qp(M, [[0.0]], [1.0], [1], [0])
    box = P(np.array([[1.0]]), [0.0], [INF])
    x = np.array([-1e-4])
    loose = alg.verify_solution(qp, 1, [box], [0], x)
    tight = alg.verify_solution(qp, 1, [box], [0], x, feas_tol=1e-6)
    batch = alg.verify_solutions_batch([(qp, [box], [0])], x,
                                       feas_tol=1e-6)[0]
    return [loose.solution, tight.solution, tight.e, batch.solution,
            batch.e, M("options").QPNetOptions().verify_feas_tol]


def _convexity(M):
    alg = M("algorithm")
    out = []
    try:
        alg.check_qp_convexity(np.array([[-2.0]]), np.array([[1.0]]),
                               np.array([0.0]), np.array([1.0]), [0], 9)
        out.append(None)
    except RuntimeError as e:
        out.append(str(e))
    # indefinite Q, but the equality row pins the concave direction
    alg.check_qp_convexity(np.diag([-2.0, 2.0]), np.array([[1.0, 0.0]]),
                           np.array([0.5]), np.array([0.5]), [0, 1], 9)
    return out


def _audit_per_combo(M):
    from types import SimpleNamespace
    alg, P = M("algorithm"), M("geometry.poly").Poly
    qp = SimpleNamespace(f=M("network").Quadratic(np.diag([1.0, -1.0]),
                                                  np.zeros(2), 0.0))
    box = P(np.eye(2), np.full(2, -1.0), np.full(2, 1.0))
    pin_y = P(np.array([[0.0, 1.0]]), np.zeros(1), np.zeros(1))
    alg._audit_convexity(qp, 1, np.zeros(2), [0, 1], [box], [[box, pin_y]])
    try:
        alg._audit_convexity(qp, 1, np.zeros(2), [0, 1], [box],
                             [[box], [box, pin_y]])
        return None
    except RuntimeError as e:
        return str(e)


def _cycle(M, perturb):
    qpn = M().setup("simple_bilevel")
    qpn.options.perturb_to_continue = perturb
    x = np.array([1.0, 2.0, 3.0, 4.0])
    rng = np.random.default_rng(0)
    proj = [rng.standard_normal(4) for _ in range(4)]
    qpn.iterate_cache[1] = [np.array([x @ v for v in proj])]
    ret = M("algorithm").solve_base(qpn, x, proj_vectors=proj,
                                    rng=np.random.default_rng(1))
    if perturb:
        return [ret.solved, ret.x_opt]
    return [ret.solved, str(ret.error)]


def _combine_guard(M):
    alg, poly = M("algorithm"), M("geometry.poly")
    big = poly.PolyUnion([poly.from_box([float(i)], [i + 1.0])
                          for i in range(6)])
    try:
        list(alg._combine([poly.from_box([0.0], [10.0])] * 4, [big] * 4,
                          np.array([0.5])))
        return None
    except RuntimeError as e:
        return str(e)


def _combine_shortcut(M):
    alg, poly = M("algorithm"), M("geometry.poly")
    pu = poly.PolyUnion([poly.from_box([0.0], [1.0])])
    out = list(alg._combine([poly.from_box([0.0], [1.0])], [pu],
                            np.array([0.5])))
    return [len(out)] + [[p.A, p.l, p.u] for p in out]


def _intersection_iter(M):
    alg, poly = M("algorithm"), M("geometry.poly")
    fb, PU = poly.from_box, poly.PolyUnion
    pus = [PU([fb([0.0], [1.0]), fb([1.0], [2.0])]),
           PU([fb([0.5], [1.5]), fb([-1.0], [0.5])])]
    center = np.array([0.5])
    out = list(alg.intersection_iter(pus, [1, 1], center))
    return [len(out), [p.closure().contains(center) for p in out],
            [[p.A, p.l, p.u] for p in out]]


def _solve_qep(M):
    qpn = M().setup("simple_bilevel")
    S = {1: M("geometry.poly").Poly(np.array([[0.0, 0.0, 1.0, -1.0]]),
                                    [0.0], [0.0])}
    return M("algorithm").solve_qep(qpn, [2], np.array([1.0, 2.0, 0.0, 0.0]),
                                    S)


def _eliminate(M):
    P = M("geometry.poly").Poly
    p = P(np.array([[1.0, 1.0], [1.0, 0.0]]), [1.0, 0.0], [1.0, 1.0])
    out = M("geometry").eliminate_variables(p, [1])
    return [out.dim, out.contains(np.array([0.5])),
            out.contains(np.array([1.5])), out.A, out.l, out.u]


def _single_solution(M):
    g = M("ops.avi").GAVI(
        M=np.array([[2.0, -1.0]]), N=np.array([[-2.0]]), o=np.array([0.0]),
        l1=np.array([-INF]), u1=np.array([INF]), A=np.array([[1.0, 0.0]]),
        B=np.array([[0.0]]), l2=np.array([0.0]), u2=np.array([INF]))
    piece, x, reduced, z = M("enumeration").get_single_solution(
        g, np.array([2.0, 0.0]), np.array([2.0]), 0, 0, [0], [1],
        np.random.default_rng(0))
    return [piece.m, x, z, piece.A, piece.l, piece.u]


def _min_norm_psi(M):
    avi = M("ops.avi")
    gavi = avi.GAVI(
        M=np.array([[1.0, -1.0, -1.0]]), N=np.zeros((1, 0)),
        o=np.array([-2.0]), l1=np.array([-INF]), u1=np.array([INF]),
        A=np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]), B=np.zeros((2, 0)),
        l2=np.array([-INF, -INF]), u2=np.array([1.0, 1.0]))
    z0 = np.array([1.0, -0.9, -0.1])
    ok, _, _ = avi.check_avi_solution(avi.convert_gavi(gavi),
                                      np.concatenate([z0, [1, 1]]),
                                      np.zeros(0))
    return [ok, M("algorithm").min_norm_revise_qep(gavi, [1, 2], z0,
                                                   np.zeros(0))]


def _min_norm_solve(M):
    qpn = M().setup("simple_bilevel", gen_solution_map=True)
    qpn.options.shared_variable_mode = \
        M("options").SharedVariableMode.MIN_NORM
    ret = M().solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]))
    metrics = M("utils.metrics").METRICS
    c0 = metrics.counters.get("min_norm_revised", 0)
    f0 = metrics.counters.get("qep_potential_fastpath", 0)
    S = {1: M("geometry.poly").Poly(np.array([[0.0, 0.0, 1.0, -1.0]]),
                                    [0.0], [0.0])}
    x_opt = M("algorithm").solve_qep(qpn, [2], np.array([1.0, 2.0, 0.0, 0.0]),
                                     S)
    return [ret.solved, ret.x_opt, x_opt,
            metrics.counters.get("min_norm_revised", 0) > c0,
            metrics.counters.get("qep_potential_fastpath", 0) == f0]


def test_verify_solution_interior_optimum():
    want, got = run_both(_verify_interior)
    assert got == want == [True, False]


def test_verify_solution_active_constraint():
    want, got = run_both(_verify_active)
    assert_same(got, want, TOL)
    assert got[0] == [True, False, False]
    assert got[1] == pytest.approx(1.0, abs=1e-6)
    assert "infeasible" in got[2]


def test_verify_feas_tol_option():
    want, got = run_both(_verify_feas_tol)
    assert_same(got, want, TOL)
    assert got[0] and not got[1] and not got[3]
    assert "1e-06" in got[2] and "1e-06" in got[4]
    assert got[5] == 1e-3


def test_check_qp_convexity_raises():
    want, got = run_both(_convexity)
    assert got == want
    assert "not convex" in got[0]


def test_convexity_audit_per_combo():
    want, got = run_both(_audit_per_combo)
    assert got == want
    assert "not convex" in got


@pytest.mark.parametrize("perturb", [False, True],
                         ids=["detected", "perturb_recovery"])
def test_cycling(perturb):
    """A seeded cycle: reported as cycling without perturb_to_continue,
    escaped by nudging the non-level variables with it."""
    want, got = run_both(lambda M: _cycle(M, perturb))
    assert_same(got, want, TOL)
    if perturb:
        assert got[0]
    else:
        assert not got[0] and "Cycling" in got[1]


def test_combine_width_guard():
    want, got = run_both(_combine_guard)
    assert got == want
    assert "Too many" in got


def test_combine_single_union_shortcut():
    want, got = run_both(_combine_shortcut)
    assert_same(got, want, TOL)
    assert got[0] == 1


def test_intersection_iter_prunes_and_redzone():
    want, got = run_both(_intersection_iter)
    assert_same(got, want, TOL)
    assert 1 <= got[0] <= 2 and all(got[1])


def test_solve_qep_single_player_matches_qp():
    want, got = run_both(_solve_qep)
    assert_same(got, want, TOL)
    np.testing.assert_allclose(got[2:], [1.5, 1.5], atol=1e-6)


def test_eliminate_variables():
    want, got = run_both(_eliminate)
    assert_same(got, want, TOL)
    assert got[:3] == [1, True, False]


def test_get_single_solution_runs():
    want, got = run_both(_single_solution)
    assert_same(got, want, TOL)
    assert got[0] >= 1
    np.testing.assert_allclose(got[1], [2.0, 2.0])


def test_min_norm_changes_psi_on_degenerate_duals():
    want, got = run_both(_min_norm_psi)
    assert_same(got, want, TOL)
    ok, z = got
    assert ok
    assert abs(z[0] - 1.0) <= 1e-6 and abs(z[1] + z[2] + 1.0) <= 1e-6
    assert np.linalg.norm(z[1:]) < np.linalg.norm([-0.9, -0.1]) - 1e-3
    assert abs(z[1] - z[2]) <= 1e-5


def test_min_norm_end_to_end_preserves_golden_solution():
    want, got = run_both(_min_norm_solve)
    assert_same(got, want, TOL)
    solved, x_opt, x_qep, revised, no_fastpath = got
    assert solved and revised and no_fastpath
    np.testing.assert_allclose(x_opt[2:], [0.5, 0.5], atol=1e-4)
    np.testing.assert_allclose(x_qep[2:], [1.5, 1.5], atol=1e-6)
