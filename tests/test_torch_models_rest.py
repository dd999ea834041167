"""The six registered models outside the zoo, solved through the port and
held to the JAX package: ``robust_constrained``, ``bilevel_escape``,
``simple_network``, ``repeated_variable_control``, ``control_avoid`` and
``interpolation_avoid``, at ``tests/test_models.py``'s kwargs and starts.

Each row is solved once per module through each package.  Both packages
must report the same ``solved``, the same QEP solves and pieces projected
(the counts in ``ROWS``), and x_opt within ``X_TOL`` = 1e-6, the zoo's
tolerance (``tests/test_torch_solve.py``; the largest difference measured
on the CPU is 1.4e-10).  Each model also passes the JAX test's own analytic
check, at that test's tolerance, through the port.
"""

import importlib

import numpy as np
import pytest
import torch

import qpn_tpu as ref
import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry.query_cache import CACHE

torch.set_num_threads(1)

X_TOL = 1e-6

# row -> (model, setup kwargs, x_init, QEP solves, pieces projected, solved)
ROWS = {
    "robust_constrained": ("robust_constrained", dict(T=2, num_obj=1), None,
                           1, 0, True),
    "bilevel_escape_far": ("bilevel_escape", {}, [2.0, 0.0, 1.0, 0.0],
                           0, 1, True),
    "bilevel_escape_origin": ("bilevel_escape", {}, [0.0] * 4, 0, 1, True),
    "simple_network_v1": ("simple_network", dict(edge_version=1), None,
                          0, 2, True),
    "simple_network_v2": ("simple_network", dict(edge_version=2), None,
                          11, 7, False),
    "simple_network_v3": ("simple_network", dict(edge_version=3), None,
                          1, 6, True),
    "repeated_variable_control": ("repeated_variable_control", {}, None,
                                  1, 3, True),
    "control_avoid": ("control_avoid", dict(T=2, num_obj=1), None, 2, 4,
                      True),
    "interpolation_avoid": ("interpolation_avoid",
                            dict(T=1, num_samples=3), None, 3, 11, True),
}


def solve_row(pkg, row):
    """(ret, qpn, QEP solves, pieces projected) of one row through ``pkg``."""
    name, kw, x0, _, _, _ = ROWS[row]
    qpn = pkg.setup(name, **kw)
    ret = pkg.solve(qpn, None if x0 is None else np.asarray(x0))
    c = qpn.metrics.counters
    return (ret, qpn, int(c.get("qep_solves", 0)),
            int(c.get("pieces_projected", 0)))


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture(scope="module")
def solved():
    """Each row solved once per module, lazily: ``solved(row)`` gives
    ``(port, reference)``, each a :func:`solve_row` tuple."""
    done = {}

    def get(row):       # called inside the tests, on the CPU
        if row not in done:
            CACHE.clear()
            done[row] = (solve_row(qt, row), solve_row(ref, row))
        return done[row]
    return get


@pytest.mark.parametrize("row", list(ROWS))
def test_row_matches_reference(solved, row):
    (ret, _, qep, pieces), (want, _, want_qep, want_pieces) = solved(row)
    _, _, _, qep_row, pieces_row, solved_row = ROWS[row]
    assert (want_qep, want_pieces, bool(want.solved)) == (
        qep_row, pieces_row, solved_row)
    assert (qep, pieces, bool(ret.solved)) == (qep_row, pieces_row,
                                               solved_row)
    if solved_row:
        np.testing.assert_allclose(ret.x_opt, want.x_opt, rtol=0, atol=X_TOL)


def test_robust_constrained_equilibrium_properties(solved):
    """u1 = 10 (clipped), u2 = 0, c = min s, v = max(0, c)."""
    (ret, _, _, _), _ = solved("robust_constrained")
    assert ret.solved
    T, F = 2, 4
    x = np.asarray(ret.x_opt)
    i = 4 + 4 * T
    U = x[i:i + 2 * T]
    i += 2 * T + F * T
    S = x[i:i + T]
    i += T + 2
    c, v = x[i], x[i + 1]
    np.testing.assert_allclose(U[0::2], 10.0, atol=1e-6)
    np.testing.assert_allclose(U[1::2], 0.0, atol=1e-6)
    np.testing.assert_allclose(c, S.min(), atol=1e-6)
    np.testing.assert_allclose(v, max(0.0, c), atol=1e-6)


@pytest.mark.parametrize("row,point", [
    ("bilevel_escape_far", [2.0, 0.0, 1.0, 0.0]),
    ("bilevel_escape_origin", [0.0, 0.0, 0.0, 0.0]),
])
def test_bilevel_escape_stationary_points(solved, row, point):
    """The global equilibrium x=(2,0), y=(1,0) is stationary; from the
    origin the solve stops at the identity piece's local equilibrium."""
    (ret, _, _, _), _ = solved(row)
    assert ret.solved
    np.testing.assert_allclose(ret.x_opt, point, atol=1e-4)


@pytest.mark.parametrize("row,point", [
    ("simple_network_v1", [0.0, 0.0, 0.0]),
    ("simple_network_v3", [0.5, 0.5, 0.0]),
])
def test_simple_network_points(solved, row, point):
    (ret, _, _, _), _ = solved(row)
    assert ret.solved
    np.testing.assert_allclose(ret.x_opt, point, atol=1e-4)


def test_simple_network_v2_terminates_cleanly(solved):
    """The ξ-disagreement case ends with a reported failure, no crash."""
    (ret, _, _, _), _ = solved("simple_network_v2")
    assert ret.solved is False


def test_repeated_variable_control_matches_direct_qp(solved):
    """The bilevel reformulation reproduces the directly solved QP (the
    port's ``batch_qp.solve_qp_np``); the shared slack s is 0."""
    from qpn_tpu_torch.ops import batch_qp
    (ret, qpn, _, _), _ = solved("repeated_variable_control")
    assert ret.solved
    d = qpn.problem_data
    sol = batch_qp.solve_qp_np(d["Q"], d["q"], d["A"], d["l"], d["u"])
    np.testing.assert_allclose(ret.x_opt[:3], np.asarray(sol.x), atol=1e-5)
    np.testing.assert_allclose(ret.x_opt[3], 0.0, atol=1e-6)


def test_control_avoid_clearance_and_dynamics(solved):
    """The avoidance certificates hold (s >= 0) and the first step follows
    the dynamics from xbar."""
    from qpn_tpu_torch.models.robust_constrained import dyn
    (ret, _, _, _), _ = solved("control_avoid")
    assert ret.solved
    T, F = 2, 4
    x = np.asarray(ret.x_opt)
    i = 2 + 4 + 4 * T + 2 * T + F * T
    assert np.all(x[i:i + T] >= -1e-6)
    xbar, xt = x[2:6], x[6:10]
    u1 = x[6 + 4 * T:6 + 4 * T + 2]
    np.testing.assert_allclose(xt, dyn(list(xbar), list(u1)), atol=1e-6)


def test_interpolation_avoid_swept_certificates(solved):
    """c = min over the samples' certificates ε, and c >= 0."""
    (ret, _, _, _), _ = solved("interpolation_avoid")
    assert ret.solved
    K = 3
    x = np.asarray(ret.x_opt)
    i = 4 + 4 + 2 + 2 * K
    eps, c = x[i:i + K], x[i + K]
    np.testing.assert_allclose(c, eps.min(), atol=1e-5)
    assert c >= -1e-6


# ---- tests/test_models.py's model-specific checks -------------------------

def _both(fn):
    """``fn(pkg)`` on the JAX package, then on the port."""
    CACHE.clear()
    return fn(ref), fn(qt)


def _four_player(pkg):
    net = pkg.setup("four_player_matrix_game", edge_list=[], seed=2)
    r1 = pkg.solve(net, np.zeros(8))
    r2 = pkg.solve(net, r1.x_opt)
    bil = pkg.solve(pkg.setup("four_player_matrix_game", edge_list=[(1, 2)],
                              seed=2), np.zeros(8))
    return r1, r2, bil


def test_four_player_equilibrium_crosscheck():
    """A Nash equilibrium re-solved from itself stays put; the bilevel DAG
    on the same costs gives another equilibrium."""
    (w1, w2, wb), (r1, r2, rb) = _both(_four_player)
    for got, want in ((r1, w1), (r2, w2), (rb, wb)):
        assert got.solved and want.solved
        np.testing.assert_allclose(got.x_opt, want.x_opt, rtol=0,
                                   atol=X_TOL)
    np.testing.assert_allclose(r1.x_opt, r2.x_opt, atol=1e-6)
    assert not np.allclose(r1.x_opt, rb.x_opt, atol=1e-4)


def test_unique_edge_lists_structure():
    def run(pkg):
        fp = importlib.import_module(
            f"{pkg.__name__}.models.four_player_matrix_game")
        return [fp.graph_is_redundant(frozenset({(1, 2)}),
                                      [frozenset({(1, 3)})]),
                fp.graph_is_redundant(frozenset({(2, 1)}),
                                      [frozenset({(1, 3)})]),
                fp.compute_unique_edge_lists(max_edges=1)]
    want, got = _both(run)
    assert got == want
    assert got[0] and not got[1]


def test_search_for_game_smoke():
    """The equilibrium cross-check harness on the 1-edge DAG family."""
    def run(pkg):
        fp = importlib.import_module(
            f"{pkg.__name__}.models.four_player_matrix_game")
        return fp.search_for_game([2], max_edges=1)
    want, got = _both(run)
    assert got == want
    assert got[0] == 2 and got[1] >= 1


@pytest.mark.parametrize("kw,point", [
    (dict(target=(0.5, 0.5), barn_weight=0.0), [0.5, 0.5]),
    (dict(pen=1.0, target=(2.0, 2.0), barn_weight=0.0), [1.0, 1.0]),
], ids=["interior", "pen_binding"])
def test_shepherd_sheep(kw, point):
    """Target inside: the sheep reaches it; outside the pen: it pins to
    the pen's corner."""
    want, got = _both(lambda pkg: pkg.solve(pkg.setup("shepherd_sheep",
                                                      **kw)))
    assert got.solved and want.solved
    np.testing.assert_allclose(got.x_opt, want.x_opt, rtol=0, atol=X_TOL)
    np.testing.assert_allclose(got.x_opt[2:], point, atol=1e-4)


def test_vis_equilibria_constellation_overlay(tmp_path):
    """Every unique 1-edge DAG at seed 495, its equilibrium overlaid on the
    constellation figure (matplotlib Agg): the same DAGs and equilibria."""
    def run(pkg):
        fp = importlib.import_module(
            f"{pkg.__name__}.models.four_player_matrix_game")
        path = tmp_path / f"{pkg.__name__}.png"
        out = fp.vis_equilibria(seed=495, max_edges=1, save_path=str(path))
        return out, path.stat().st_size
    (want, _), (got, size) = _both(run)
    assert got["edge_lists"] == want["edge_lists"]
    assert len(got["edge_lists"]) >= 4 and size > 0
    assert len(got["overlay"]) == len(want["overlay"])
    for (ge, gx), (we, wx) in zip(got["overlay"], want["overlay"]):
        assert ge == we and gx is not None and wx is not None
        np.testing.assert_allclose(gx, wx, rtol=0, atol=X_TOL)
