"""The port's piece enumeration and requests (``qpn_tpu_torch/enumeration.py``,
``requests.py``) against the JAX package's, on the cases of
``tests/test_enumeration.py`` and ``tests/test_requests_e2e.py``:
complementarity labels, recipe products, local pieces, solution graphs, the
vertex-exploration budget and completeness, frontier checkpoints and their
resume, request-granted labels and the request round of ``solve()``.

Each case runs on both packages with the same inputs.  Labels, recipes,
counts and frontier keys must be equal; pieces are compared as the JAX tests
compare them, by their rows rounded to 5 digits (both packages build them
from the same GAVI algebra; the LP witnesses behind them agree to ~1e-10);
x_opt within 1e-6.  Each case also checks the JAX test's own property on
the port's result.
"""

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG

from _torch_parity import clear_query_caches, run_both

torch.set_num_threads(1)

INF = np.inf
X_TOL = 1e-6


def piece_keys(pieces):
    """The set of pieces by their rows rounded to 5 digits."""
    return {(tuple(np.round(p.A.flatten(), 5)), tuple(np.round(p.l, 5)),
             tuple(np.round(p.u, 5))) for p in pieces}


@pytest.fixture(autouse=True)
def _cpu_and_fresh_caches(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    clear_query_caches()


def _gavi(modules, **kw):
    return modules("ops.avi").GAVI(**kw)


def _follower(M, a=2.0, n=-2.0):
    """KKT GAVI of min_y ½a(y − w)² s.t. y ≥ 0 (z = [y, λ], w a param)."""
    return _gavi(M, M=np.array([[a, -1.0]]), N=np.array([[n]]),
                 o=np.array([0.0]), l1=np.array([-INF]), u1=np.array([INF]),
                 A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
                 l2=np.array([0.0]), u2=np.array([INF]))


def _degenerate(M):
    """A redundant row through the orthant's corner: a segment of duals."""
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    return _gavi(M, M=np.hstack([np.eye(2), -A.T]), N=-np.eye(2),
                 o=np.zeros(2), l1=np.full(2, -INF), u1=np.full(2, INF),
                 A=np.hstack([A, np.zeros((3, 3))]), B=np.zeros((3, 2)),
                 l2=np.zeros(3), u2=np.full(3, INF))


# ---- tests/test_enumeration.py ------------------------------------------

def _comp_strict(M):
    return M("enumeration").comp_indices(_follower(M), np.array([2.0, 0.0]),
                                         np.array([2.0]))


def _comp_weak(M):
    en = M("enumeration")
    J = en.comp_indices(_follower(M), np.zeros(2), np.zeros(1))
    return [J, sorted(en.all_Ks(J))]


def _local_pieces(M):
    en, g = M("enumeration"), _follower(M)
    out = []
    for K, pts in (((2, 6), ([1.0, 0.0, 1.0], [1.0, 0.0, 2.0])),
                   ((2, 5), ([0.0, 2.0, -1.0], [0.0, -2.0, 1.0]))):
        piece, _ = en.local_piece(g, 2, 1, K)
        out.append([piece_keys([piece]),
                    piece.contains(np.array(pts[0]), tol=1e-6),
                    piece.contains(np.array(pts[1]), tol=1e-4)])
    return out


def _scalar_graph(M):
    net, P = M("network"), M("geometry.poly").Poly
    qp = net.QP(f=net.Quadratic(np.array([[2.0, -2.0], [-2.0, 2.0]]),
                                np.zeros(2), 0.0),
                constraint_indices=[1], var_indices=[1])
    cons = [P(np.array([[0.0, 1.0]]), [0.0], [INF])]
    pieces = M("enumeration").process_solution_graph(
        qp, cons, [1], np.zeros(2), np.zeros(1)).collect()
    inside = [any(p.contains(np.array(x), tol=1e-6) for p in pieces)
              for x in ([1.0, 1.0], [-1.0, 0.0], [1.0, 0.0], [-1.0, 0.5])]
    return [len(pieces), piece_keys(pieces), inside]


def _quantize(M):
    q = M("enumeration").quantize
    a, b, c = (q(np.array([v, 1.0]))
               for v in (0.1234567, 0.1234572, 0.1234467))
    return [a == b, a != c, a, c]


def _budget(M):
    sols = M("enumeration").LocalGAVISolutions(
        _follower(M), np.zeros(2), np.zeros(1), 0, 0, [0], [1],
        max_vertices=0)
    pieces = sols.collect()
    return [len(pieces), len(sols.explored_vertices), piece_keys(pieces)]


def _from_dual(M, lam):
    gen = M("enumeration").LocalGAVISolutions(
        _degenerate(M), np.concatenate([np.zeros(2), lam]),
        np.array([-1.0, -1.0]), 0, 0, [0, 1], [0, 1], max_vertices=10 ** 6)
    return piece_keys(gen.collect())


def _seed_independent(M):
    return [_from_dual(M, np.array(lam)) for lam in
            ([0.5, 0.5, 0.5], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0])]


def _frontier_resume(M, tmp):
    en = M("enumeration")
    store_cls = M("utils.checkpoint").FrontierStore
    g = _degenerate(M)
    z = np.concatenate([np.zeros(2), [0.5, 0.5, 0.5]])
    w = np.array([-1.0, -1.0])

    def gen(store=None):
        return en.LocalGAVISolutions(g, z, w, 0, 0, [0, 1], [0, 1],
                                     max_vertices=10 ** 6,
                                     frontier_store=store)
    truth = piece_keys(gen().collect())
    store = store_cls(str(tmp / M().__name__))
    first = gen(store)
    Ks = list(first.unexplored_Ks)
    first.explored_Ks |= first.unexplored_Ks
    first.unexplored_Ks = set()
    first._absorb(first._expand_batch(Ks))
    first._checkpoint()
    pending = [not first.unexplored_Ks, bool(first.unexplored_vertices)]
    return [truth, pending, piece_keys(gen(store).collect())]


def _frontier_key(M):
    g = _gavi(M, M=np.eye(1), N=np.zeros((1, 1)), o=np.zeros(1),
              l1=np.zeros(1), u1=np.full(1, INF), A=np.zeros((0, 1)),
              B=np.zeros((0, 1)), l2=np.zeros(0), u2=np.zeros(0))
    return [M("enumeration").LocalGAVISolutions(
        g, np.zeros(1), np.zeros(1), 0, 0, [0], [0],
        max_vertices=mv)._frontier_key() for mv in (10, 1000, 10)]


def _stale_store(M, tmp):
    qpn = M().setup("simple_bilevel", gen_solution_map=True)
    x0 = np.array([0.0, 1.0, 0.0, 0.0])
    ret = M().solve(qpn, x0, checkpoint_path=str(tmp / M().__name__))
    attached = qpn.frontier_store is not None
    ret2 = M().solve(qpn, x0)
    return [ret.solved, attached, getattr(qpn, "frontier_store", None),
            ret2.solved, ret.x_opt.tolist(), ret2.x_opt.tolist()]


def test_comp_indices_strict_interior():
    want, got = run_both(_comp_strict)
    assert got == want
    assert got[0] == {2} and got[1] == {6}


def test_comp_indices_weak():
    want, got = run_both(_comp_weak)
    assert got == want
    assert got[0][1] == {5, 6} and len(got[1]) == 2


def test_local_piece_regions():
    want, got = run_both(_local_pieces)
    assert got == want
    assert [r[1:] for r in got] == [[True, False], [True, False]]


def test_solution_graph_scalar_follower():
    want, got = run_both(_scalar_graph)
    assert got == want
    assert got[0] >= 2 and got[2] == [True, True, False, False]


def test_quantize_dedup():
    want, got = run_both(_quantize)
    assert got == want
    assert got[0] and got[1]


def test_vertex_exploration_budget():
    want, got = run_both(_budget)
    assert got == want
    assert got[0] >= 2 and got[1] == 1


def test_seed_independent_piece_discovery():
    want, got = run_both(_seed_independent)
    assert got == want
    assert got[0] == got[1] == got[2] and len(got[0]) == 4


def test_frontier_resume_with_pending_vertices(tmp_path):
    want, got = run_both(lambda M: _frontier_resume(M, tmp_path))
    assert got == want
    truth, pending, resumed = got
    assert len(truth) >= 2 and pending == [True, True] and resumed == truth


def test_frontier_key_depends_on_exploration_settings():
    want, got = run_both(_frontier_key)
    assert got == want
    assert got[0] != got[1] and got[0] == got[2]


def test_solve_clears_stale_frontier_store(tmp_path):
    want, got = run_both(lambda M: _stale_store(M, tmp_path))
    np.testing.assert_allclose(got[4:], want[4:], rtol=0, atol=X_TOL)
    assert got[:4] == want[:4] == [True, True, None, True]


# ---- tests/test_requests_e2e.py -----------------------------------------

def _request_extends(M):
    en, net = M("enumeration"), M("network")
    g = _follower(M, a=1.0, n=-1.0)
    z, w = np.array([1.0, 0.0]), np.array([1.0])

    def enumerate_with(request):
        gen = en.LocalGAVISolutions(g, z, w, 0, 0, [0], [1])
        gen.permuted_request = request
        gen.unexplored_Ks = en.all_Ks(en.comp_indices(g, z, w, request))
        return gen.collect()
    base = enumerate_with(frozenset())
    ext = enumerate_with(frozenset([net.Linear(np.array([0.0, -1.0, 0.0]))]))
    return [len(base), len(ext), piece_keys(base), piece_keys(ext)]


def _granted_labels(M):
    en, net = M("enumeration"), M("network")
    g = _follower(M, a=1.0, n=-1.0)
    z, w = np.array([1.0, 0.0]), np.array([1.0])
    req = frozenset([net.Linear(np.array([0.0, -1.0, 0.0]))])
    return [en.comp_indices(g, z, w), en.comp_indices(g, z, w, req)]


def _requests_net(M, make_requests):
    fe = M("frontend")
    w, x = fe.variable("w"), fe.variable("x")
    b = fe.QPNetBuilder(w, x)
    cid = b.add_constraint([x], [0.0], [INF])
    fid = b.add_qp((x - w) ** 2, [cid], x)
    lid = b.add_qp((x - 2.0) ** 2 + 0.1 * w ** 2, [], w)
    b.add_edges([(lid, fid)])
    b.set_options(gen_solution_map=True, make_requests=make_requests,
                  exploration_vertices=0)
    return b.net, fid


def _requests_through_solve(M):
    out = []
    for make in (False, True):
        net, fid = _requests_net(M, make)
        ret = M("algorithm").solve(net, np.array([1.0, 1.0]))
        rounds = M("utils.metrics").METRICS.counters.get("request_rounds", 0)
        out.append([ret.solved, ret.x_opt.tolist(), len(ret.Sol[fid]),
                    piece_keys(ret.Sol[fid]), rounds,
                    any(p.contains(np.array([-1.0, 0.0]), tol=1e-6)
                        for p in ret.Sol[fid])])
    return out


def _identify(M):
    P = M("geometry.poly").Poly
    parent = P(np.eye(2), np.zeros(2), np.array([2.0, 2.0]))
    S = P(np.array([[1.0, 0.0]]), np.array([0.0]), np.array([2.0]))
    S.parent = parent
    S.row_parents = [parent]
    reqs = M("requests").identify_request(S, np.array([1.0]))
    return [type(r).__name__ for r in reqs], sorted(
        tuple(np.round(r.a, 9)) for r in reqs)


def _propagate(M):
    box = M("geometry.poly").Poly(np.eye(2), np.zeros(2), np.ones(2))
    return sorted(tuple(np.round(r.a, 9)) for r in
                  M("requests").propagate_request(np.array([1.0, 0.0]), box))


def _grant_block1(M):
    en, net = M("enumeration"), M("network")
    g = _gavi(M, M=np.array([[1.0, -1.0]]), N=np.array([[-1.0]]),
              o=np.zeros(1), l1=np.array([0.0]), u1=np.array([1.0]),
              A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
              l2=np.array([0.0]), u2=np.array([INF]))
    z, w = np.zeros(2), np.array([-0.5])
    req = (net.Linear(np.array([1.0, -1.0, -1.0])),)
    return [en.comp_indices(g, z, w), en.comp_indices(g, z, w, req)]


def _grant_block2(M):
    en, net = M("enumeration"), M("network")
    g = _gavi(M, M=np.array([[1.0, -1.0]]), N=np.array([[0.0]]),
              o=np.array([-1.0]), l1=np.array([-INF]), u1=np.array([INF]),
              A=np.array([[1.0, 0.0]]), B=np.array([[-1.0]]),
              l2=np.array([0.0]), u2=np.array([INF]))
    z, w = np.array([1.0, 0.0]), np.array([0.0])
    req = (net.Linear(np.array([0.0, -1.0, 0.0])),)
    return [en.comp_indices(g, z, w), en.comp_indices(g, z, w, req)]


def test_request_extends_solution_map():
    want, got = run_both(_request_extends)
    assert got == want
    assert got[1] > got[0]


def test_granted_labels_in_comp_indices():
    want, got = run_both(_granted_labels)
    assert got == want
    J0, J1 = got
    assert all(a <= b for a, b in zip(J0, J1)) and J0 != J1


def test_make_requests_extends_discovered_graph():
    want, got = run_both(_requests_through_solve)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=X_TOL)
        assert g[:1] + g[2:] == w[:1] + w[2:]
    plain, negotiated = got
    assert plain[0] and negotiated[0]
    np.testing.assert_allclose(plain[1], negotiated[1], atol=1e-6)
    assert negotiated[2] > plain[2] and negotiated[4] >= 1
    assert negotiated[5] and not plain[5]


def test_identify_request_through_parent():
    want, got = run_both(_identify)
    assert got == want
    assert len(got[0]) >= 1 and set(got[0]) == {"Linear"}


def test_propagate_request_duals():
    want, got = run_both(_propagate)
    assert got == want
    assert (1.0, 0.0) in got


def test_block1_r_direction_includes_N():
    want, got = run_both(_grant_block1)
    assert got == want
    base, granted = got
    assert base[0] == {1} and 3 in granted[0] - base[0]


def test_block2_r_direction_excludes_B():
    want, got = run_both(_grant_block2)
    assert got == want
    base, granted = got
    assert base[1] == {6} and 5 in granted[1] - base[1]
