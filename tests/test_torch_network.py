"""The port's network layer and frontend (``qpn_tpu_torch/network.py``,
``frontend.py``, ``options``) against the JAX package's, on the cases of
``tests/test_network.py``: transitive reduction and cycle errors, depth
maps, decision indices, gather and fair objective, frontend extraction with
its validation errors, constraint offsets and groups, option reflection,
flatten and the Julia column-major variable order.

Each case runs on both packages with the same inputs.  These layers are
numpy copies, so everything must be equal: matrices, index sets, names and
error messages (no tolerance).  Each case also checks the JAX test's own
property on the port's result.
"""

import warnings

import numpy as np
import pytest

from qpn_tpu_torch.config import CONFIG

from _torch_parity import assert_same, run_both


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _raises(fn, exc):
    """The message of the ``exc`` that ``fn()`` raises (None if none)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _reduction(M):
    return list(M("network").create_minimal_adj_matrix(
        3, [(1, 2), (2, 3), (1, 3)]))


def _cycle_errors(M):
    net = M("network")
    return [_raises(lambda: net.create_minimal_adj_matrix(
                3, [(1, 2), (2, 3), (3, 1)]), ValueError),
            _raises(lambda: net.create_minimal_adj_matrix(2, [(1, 1)]),
                    ValueError)]


def _depth_map(M, edges, n):
    net = M("network")
    _, R = net.create_minimal_adj_matrix(n, edges)
    return net.create_depth_map(R)


def _decision_inds(M):
    qpn = M().setup("simple_bilevel")
    return [qpn.decision_inds(2), qpn.decision_inds(1)]


def _gather_fair(M):
    qpn = M().setup("simple_bilevel")
    f = qpn.fair_obj(1)
    return [sorted(qpn.gather(1).qps), f.Q, f.q, f.k]


def _extraction(M):
    fe = M("frontend")
    x, y = fe.variable("x"), fe.variable("y")
    b = fe.QPNetBuilder(x, y)
    qp = b.net.qps[b.add_qp((x - 2 * y) ** 2 + 3 * x + 1.5, [], x)]
    return [qp.f.Q, qp.f.q, qp.f.k, qp.var_indices]


def _constraint_offset(M):
    fe = M("frontend")
    x = fe.variable("x")
    b = fe.QPNetBuilder(x)
    poly = b.net.constraints[b.add_constraint([x + 2.0], [0.0],
                                              [5.0])].poly
    return [poly.A, poly.l, poly.u] + [poly.contains(np.array([v]))
                                       for v in (-2.0, 3.0, 3.5)]


def _constraint_groups(M):
    return M().setup("simple_bilevel").constraints[1].group_mapping


def _options_reflection(M):
    qpn = M().setup("simple_bilevel")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        qpn.set_options(tol=1e-5, bogus_option=3)
    return [qpn.options.tol, [str(w.message) for w in caught]]


def _flatten(M):
    qpn = M().setup("simple_bilevel")
    flat = qpn.flatten()
    return [flat.num_levels(), qpn.num_levels(), flat.network_depth_map]


def _column_major(M):
    fe = M("frontend")
    return [v.name for v in fe.QPNetBuilder(fe.variables("x", 2, 3)).vars]


def _power_division(M):
    fe = M("frontend")
    x, y = fe.variable("x"), fe.variable("y")
    b = fe.QPNetBuilder(x, y)
    pid = b.add_qp((x ** 1 - 1.0) ** 2, [], x)
    return [b.net.qps[pid].f.Q, _raises(lambda: x ** 3, ValueError),
            _raises(lambda: x / y, ValueError)]


def _structural(M):
    fe = M("frontend")
    x, y = fe.variable("x"), fe.variable("y")
    b = fe.QPNetBuilder(x, y)
    errors = [_raises(lambda: b.add_constraint([x * y], [0.0], [1.0]),
                      ValueError),
              _raises(lambda: b.add_qp((x * x) * y, [], x), ValueError),
              _raises(lambda: b.add_qp((x * x) * (y * y), [], x),
                      ValueError)]
    cid = b.add_constraint([x * y - x * y + x], [0.0], [1.0])
    qps = [b.net.qps[b.add_qp(e, [], x)] for e in (
        x * y, (x * y - x * y + x) * x, x * x + 0.0 * (x * x) * y)]
    return errors + [b.net.constraints[cid].poly.contains(
        np.array([0.5, 99.0]))] + [[qp.f.Q, qp.f.q] for qp in qps]


def test_transitive_reduction():
    want, got = run_both(_reduction)
    assert_same(got, want)
    A, R = got
    assert not A[0, 2] and R[0, 2]


def test_cycle_detection():
    want, got = run_both(_cycle_errors)
    assert got == want
    assert "Cycle" in got[0] and "self edges" in got[1]


@pytest.mark.parametrize("edges,n,dm", [
    ([(1, 2), (2, 3), (3, 4)], 4, {1: {1}, 2: {2}, 3: {3}, 4: {4}}),
    ([], 3, {1: {1, 2, 3}}),
], ids=["chain", "nash"])
def test_depth_map(edges, n, dm):
    want, got = run_both(lambda M: _depth_map(M, edges, n))
    assert got == want == dm


def test_decision_inds_include_descendants():
    want, got = run_both(_decision_inds)
    assert got == want == [[2, 3], [3]]


def test_gather_and_fair_obj():
    want, got = run_both(_gather_fair)
    assert_same(got, want)
    assert got[0] == [2] and got[1].shape == (4, 4)


def test_frontend_extraction():
    want, got = run_both(_extraction)
    assert_same(got, want)
    np.testing.assert_allclose(got[0], [[2.0, -4.0], [-4.0, 8.0]])
    np.testing.assert_allclose(got[1], [3.0, 0.0])
    assert got[2] == 1.5


def test_frontend_constraint_offset():
    want, got = run_both(_constraint_offset)
    assert_same(got, want)
    assert got[3:] == [True, True, False]


def test_constraint_groups():
    want, got = run_both(_constraint_groups)
    assert got == want == {1: 1}


def test_options_reflection():
    want, got = run_both(_options_reflection)
    assert got == want
    assert got[0] == 1e-5 and any("bogus_option" in m for m in got[1])


def test_flatten():
    want, got = run_both(_flatten)
    assert got == want
    assert got[:2] == [1, 2]


def test_julia_column_major_variable_order():
    want, got = run_both(_column_major)
    assert got == want == ["x1_1", "x2_1", "x1_2", "x2_2", "x1_3", "x2_3"]


def test_frontend_power_and_division_validation():
    want, got = run_both(_power_division)
    assert_same(got, want)
    assert "not quadratic" in got[1] and "scalars" in got[2]


def test_frontend_structural_rejection():
    want, got = run_both(_structural)
    assert_same(got, want)
    assert "non-linear constraint" in got[0]
    assert "non-quadratic cost" in got[1] and "non-quadratic cost" in got[2]
    assert got[3]
    np.testing.assert_allclose(got[4][0], [[0.0, 1.0], [1.0, 0.0]])
    np.testing.assert_allclose(got[5][0], [[2.0, 0.0], [0.0, 0.0]])
    np.testing.assert_allclose(got[6][0], [[2.0, 0.0], [0.0, 0.0]])
