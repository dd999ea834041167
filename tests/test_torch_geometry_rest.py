"""The rest of the JAX package's geometry and auxiliary suites against the
port: ``tests/test_coverage_extras.py``, ``tests/test_aux.py``,
``tests/test_rays.py`` (recession and unbounded hulls; its cone cases are
in ``tests/test_torch_setops.py``) and the cases of
``tests/test_geometry.py`` that ``tests/test_torch_setops.py`` lacks
(normalisation, simplify, complement, slices, transitivity, the high-
dimensional hull, strict emptiness through projection, the query key).

Each case runs on both packages with the same inputs.  Verdicts, counts,
golden strings and metric snapshots must be equal; polyhedra, hulls and
points from the engines agree within ``TOL`` = 1e-7, as in
``tests/test_torch_setops.py``; solve points within 1e-6.  Each case also
checks the JAX test's own property on the port's result.
"""

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG

from _torch_parity import assert_same, clear_query_caches, run_both

torch.set_num_threads(1)

TOL = 1e-7
X_TOL = 1e-6
INF = np.inf


def rows(p):
    """A polyhedron as [A, l, u, strict_l, strict_u]."""
    return [p.A, p.l, p.u, p.strict_l.tolist(), p.strict_u.tolist()]


def contains_all(p, pts, tol=1e-6):
    return [bool(p.contains(np.asarray(x, float), tol=tol)) for x in pts]


@pytest.fixture(autouse=True)
def _cpu_and_fresh_caches(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    clear_query_caches()


# ---- tests/test_coverage_extras.py ---------------------------------------

def _issubset_union(M):
    G = M("geometry")
    pu = G.PolyUnion([G.from_box([0.0], [0.5]), G.from_box([0.6], [1.0])])
    return [G.issubset_union(G.from_box([0.2], [0.4]), pu),
            G.issubset_union(G.from_box([0.4], [0.7]), pu)]


def _union_intersect(M):
    G = M("geometry")
    a = G.PolyUnion([G.from_box([0.0], [1.0]), G.from_box([2.0], [3.0])])
    b = G.PolyUnion([G.from_box([0.5], [2.5])])
    pieces = list(G.union_intersect(a, b))
    return [len(pieces), pieces[0].contains(np.array([0.7]))] + [
        rows(p) for p in pieces]


def _lexico(M):
    ok, mag = M("geometry.poly").lexico_positive(np.array([0.0, -2.0, 1.0]))
    return [ok, mag, M("geometry").get_lexico_ordering(
        np.array([[0.0, 1.0], [1.0, 0.0]]))]


def _hull_square(M):
    hull = M("geometry.vertices").hull_of_points(
        np.array([[0.0, 0], [1, 0], [0, 1], [1, 1], [0.5, 0.5]]))
    return [contains_all(hull, ([0.5, 0.5], [1.2, 0.5])), rows(hull)]


def _hull_union(M):
    G = M("geometry")
    hull = G.convex_hull(G.PolyUnion([G.from_box([0.0, 0.0], [1.0, 1.0]),
                                      G.from_box([2.0, 0.0], [3.0, 1.0])]))
    return [contains_all(hull, ([1.5, 0.5], [1.5, 1.5])), rows(hull)]


def _closest_feasible(M):
    avi = M("ops.avi")
    g = avi.GAVI(M=np.zeros((1, 2)), N=np.zeros((1, 0)), o=np.zeros(1),
                 l1=np.array([-INF]), u1=np.array([INF]),
                 A=np.array([[1.0, 0.0]]), B=np.zeros((1, 0)),
                 l2=np.array([0.0]), u2=np.array([1.0]))
    return avi.find_closest_feasible(g, np.array([5.0, 7.0]), np.zeros(0))


def _relax(M):
    avi = M("ops.avi")
    g = avi.GAVI(M=np.array([[2.0, -1.0]]), N=np.array([[-2.0]]),
                 o=np.array([0.0]), l1=np.array([-INF]), u1=np.array([INF]),
                 A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
                 l2=np.array([0.0]), u2=np.array([INF]))
    rg = avi.relax_gavi(g, [0])
    z, status = avi.solve_gavi(rg, np.zeros(3), np.zeros(0))
    return [status.name, z, rg.M, rg.N, rg.l1, rg.u1]


def _linear(M):
    L = M("network").Linear
    a, b = L([1.0, 2.0]), L([1.0, 2.0])
    return [a == b, hash(a) == hash(b), a([1.0, 1.0])]


def _quadratic_sum(M):
    Q = M("network").Quadratic
    f = Q(np.eye(2), np.ones(2), 1.0)
    g = Q.sum([f, f, f])
    return [g.Q, g.q, g.k]


def _translate(M):
    p = M("geometry").from_box([0.0], [1.0]).translate([2.0])
    return [contains_all(p, ([2.5], [0.5])), rows(p)]


def _tikz_debug(M, capsys):
    qpn = M().setup("simple_bilevel")
    src = M("models.viz").tikz_graph(qpn)
    M("printing").display_debug(qpn, 1, 3, pieces=2)
    return [src, capsys.readouterr().out]


def test_issubset_union_conservative():
    want, got = run_both(_issubset_union)
    assert got == want == [True, False]


def test_union_intersect_product():
    want, got = run_both(_union_intersect)
    assert_same(got, want, TOL)
    assert got[:2] == [2, True]


def test_lexico_helpers():
    want, got = run_both(_lexico)
    assert got == want == [False, 2.0, [1, 0]]


def test_hull_of_points_square():
    want, got = run_both(_hull_square)
    assert_same(got, want, TOL)
    assert got[0] == [True, False]


def test_convex_hull_union():
    want, got = run_both(_hull_union)
    assert_same(got, want, TOL)
    assert got[0] == [True, False]


def test_find_closest_feasible_projects():
    want, got = run_both(_closest_feasible)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert -1e-6 <= got[0] <= 1.0 + 1e-6
    assert np.isclose(got[1], 7.0, atol=1e-6)


def test_relax_gavi_solves_relaxed_problem():
    want, got = run_both(_relax)
    assert_same(got, want, X_TOL)
    assert got[0] == "SUCCESS"
    w_rel, y_rel = got[1][0], got[1][1]
    assert np.isclose(y_rel, max(w_rel, 0.0), atol=1e-6)


def test_linear_hash_and_call():
    want, got = run_both(_linear)
    assert got == want
    assert got[0] and got[1] and got[2] == pytest.approx(3.0)


def test_quadratic_sum():
    want, got = run_both(_quadratic_sum)
    assert_same(got, want, TOL)
    np.testing.assert_allclose(got[0], 3 * np.eye(2))
    assert got[2] == 3.0


def test_poly_translate():
    want, got = run_both(_translate)
    assert_same(got, want, TOL)
    assert got[0] == [True, False]


def test_multihost_info():
    """One process either way; the device counts differ by design (the JAX
    tests run on 8 virtual CPU devices, the port counts processes' cards or
    one CPU)."""
    want, got = run_both(lambda M: M("parallel.multihost").process_info())
    assert sorted(got) == sorted(want)
    assert got["process_count"] == want["process_count"] == 1
    assert got["global_devices"] >= 1


def test_tikz_and_debug_banner(capsys):
    want, got = run_both(lambda M: _tikz_debug(M, capsys))
    assert got == want
    assert "\\graph" in got[0] and "(2) -> (1);" in got[0]
    assert "level 1 iteration 3" in got[1]


# ---- tests/test_aux.py ----------------------------------------------------

def _format_poly(M):
    return M("printing").format_poly(M("geometry").from_box([0.0, -INF],
                                                            [1.0, 2.0]))


def _format_quadratic(M):
    f = M("network").Quadratic(np.array([[2.0, 1.0], [1.0, 0.0]]),
                               np.array([0.0, -3.0]), 1.0)
    return M("printing").format_quadratic(f, names=["a", "b"])


def _format_labeled(M):
    P, pr = M("geometry.poly").Poly, M("printing")
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    l, u = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.0])
    return [pr.format_labeled_poly(P(A, l, u), labels={"x": 0, "yvar": 1}),
            pr.format_labeled_poly(P(A, l, u,
                                     strict_l=np.array([True, False, False])))]


def _format_tree(M):
    G = M("geometry")
    p = G.from_box([0.0], [1.0])
    return M("printing").format_intersection_tree(
        [G.PolyUnion([p]), G.PolyUnion([p, p])], red_lengths=[1, 0])


def _min_norm_objective(M):
    f = M("requests").min_norm_objective(4, [1, 3])
    return [f(np.array([1.0, 2.0, 3.0, 4.0])), f.Q, f.q, f.k]


def _propagate_box(M):
    out = M("requests").propagate_request(
        np.array([1.0, 0.0]), M("geometry").from_box([0.0, 0.0], [1.0, 1.0]))
    return [[type(r).__name__ for r in out],
            sorted(tuple(np.round(r.a, 9)) for r in out)]


def _identify_parents(M):
    G = M("geometry")
    parent = G.from_box([0.0, 0.0], [1.0, 1.0])
    S = G.Poly(np.array([[1.0, 0.0]]), [0.0], [1.0], parent=parent)
    S.row_parents = [parent]
    reqs = M("requests").identify_request(S, np.array([1.0]))
    return sorted(tuple(np.round(r.a, 9)) for r in reqs)


def _checkpoint_roundtrip(M, tmp):
    G, ck = M("geometry"), M("utils.checkpoint")
    path = str(tmp / f"{M().__name__}.npz")
    pu = G.PolyUnion([G.from_box([0.0], [1.0]), G.from_box([2.0], [3.0])])
    ck.save_state(path, np.array([1.0, 2.0, 3.0]), Sol={7: pu},
                  iterate_cache={1: [np.array([0.5, 0.5])]},
                  meta={"iteration": 3})
    state = ck.load_state(path)
    return [state["x"], len(state["Sol"][7]),
            state["Sol"][7][0].contains(np.array([0.5])),
            state["meta"]["iteration"], len(state["iterate_cache"][1]),
            [rows(p) for p in state["Sol"][7]]]


def _solve_checkpoint(M, tmp):
    ck = M("utils.checkpoint")
    qpn = M().setup("simple_bilevel", gen_solution_map=True)
    path = str(tmp / f"{M().__name__}.npz")
    ret = M().solve(qpn, np.array([1.0, 0.0, 0.0, 0.0]),
                    checkpoint_path=path)
    state = ck.load_state(path)
    ret2 = ck.resume(qpn, path)
    return [ret.solved, state["meta"].get("solved"), 2 in state["Sol"],
            ret2.solved, ret.x_opt, state["x"], ret2.x_opt]


def _metrics_scope(M):
    m = M("utils.metrics").Metrics()
    m.bump("a")
    m.bump("a", 2)
    with m.timer("t"):
        pass
    snap = m.snapshot()
    return [snap["a"], sorted(snap)]


def _frontier_enumerator(M, store=None):
    qpn = M().setup("simple_bilevel")
    alg = M("algorithm")
    x = np.array([0.0, 1.0, 0.5, 0.5])
    leaf = sorted(qpn.network_depth_map[qpn.num_levels()])[0]
    prep = alg._prepare_qp_tasks(qpn, leaf, x, {})
    ret = alg.verify_solutions_batch(prep.tasks, x)[0]
    return M("enumeration").process_solution_graph(
        prep.qp, prep.base_constraints, prep.dec_inds, x, ret.lam,
        exploration_vertices=10, frontier_store=store)


def _piece_key_set(pieces):
    return {tuple(np.round(p.A.flatten(), 5).tolist())
            + tuple(np.round(p.l, 5).tolist()) for p in pieces}


def _kill_resume(M, tmp):
    truth = _piece_key_set(_frontier_enumerator(M).collect())
    store = M("utils.checkpoint").FrontierStore(str(tmp / M().__name__))
    gen = _frontier_enumerator(M, store)
    Ks = list(gen.unexplored_Ks)
    gen.explored_Ks |= gen.unexplored_Ks
    gen.unexplored_Ks = set()
    gen._absorb(gen._expand_batch(Ks))
    gen._checkpoint()
    partial = len(gen.polys)
    gen2 = _frontier_enumerator(M, store)
    restored = len(gen2.polys)
    return [truth, partial, restored, _piece_key_set(gen2.collect())]


def _solve_writes_frontiers(M, tmp):
    import os
    qpn = M().setup("simple_bilevel")
    path = str(tmp / M().__name__)
    ret = M().solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]),
                    checkpoint_path=path)
    fdir = path + ".frontiers"
    return [ret.solved, os.path.isdir(fdir),
            sorted(os.listdir(fdir)) if os.path.isdir(fdir) else [],
            ret.x_opt]


def test_format_poly():
    want, got = run_both(_format_poly)
    assert got == want
    assert "Poly in R^2" in got and "∞" in got


def test_format_quadratic():
    want, got = run_both(_format_quadratic)
    assert got == want
    assert "a²" in got and "+1 a·b" in got and "+1 a²" in got


def test_format_labeled_poly_golden():
    want, got = run_both(_format_labeled)
    assert got == want
    lines = got[0].rstrip("\n").split("\n")
    assert lines[0] == "Polyhedron in R^2 with 3 constraints."
    assert "x" in lines[1] and "yvar" in lines[1]
    assert lines[2].lstrip().startswith("2 ≤")
    assert sum("| x" in ln for ln in lines) == 1
    assert "·" in got[0] and "<" in got[1]


def test_format_intersection_tree_golden():
    want, got = run_both(_format_tree)
    assert got == want
    lines = got.split("\n")
    assert lines[0] == "Intersection root with 2 potential polys"
    assert lines[1] == "  depth 0: 1 contributing polys (1 complement)"
    assert any(ln.startswith("    depth 1: 2 contributing polys")
               for ln in lines)
    assert any(ln.startswith("      Poly in R^1") for ln in lines)


def test_min_norm_objective():
    want, got = run_both(_min_norm_objective)
    assert_same(got, want, TOL)
    assert got[0] == pytest.approx(0.5 * (4 + 16))


def test_propagate_request():
    want, got = run_both(_propagate_box)
    assert got == want
    assert len(got[0]) >= 1 and set(got[0]) == {"Linear"}


def test_identify_request_reads_parents():
    want, got = run_both(_identify_parents)
    assert got == want
    assert len(got) >= 1


def test_checkpoint_roundtrip(tmp_path):
    want, got = run_both(lambda M: _checkpoint_roundtrip(M, tmp_path))
    assert_same(got, want, TOL)
    assert got[1:5] == [2, True, 3, 1]


def test_solve_with_checkpoint(tmp_path):
    want, got = run_both(lambda M: _solve_checkpoint(M, tmp_path))
    assert_same(got, want, X_TOL)
    assert got[:4] == [True, True, True, True]
    np.testing.assert_allclose(got[5], got[4])
    np.testing.assert_allclose(got[6], got[4], atol=1e-6)


def test_metrics_scope():
    want, got = run_both(_metrics_scope)
    assert got == want
    assert got[0] == 3 and "time/t" in got[1]


def test_kill_resume_reproduces_piece_set(tmp_path):
    want, got = run_both(lambda M: _kill_resume(M, tmp_path))
    assert got == want
    truth, partial, restored, resumed = got
    assert restored == partial and resumed == truth


def test_solve_with_checkpoint_writes_frontiers(tmp_path):
    want, got = run_both(lambda M: _solve_writes_frontiers(M, tmp_path))
    assert_same(got, want, X_TOL)
    assert got[0] and got[1] and len(got[2]) >= 1


# ---- tests/test_rays.py (recession and unbounded hulls) -------------------

def _dirset(vecs):
    return sorted(tuple(np.round(v / np.linalg.norm(v), 6)) for v in vecs)


RECESSION = {
    "box": (np.eye(2), np.zeros(2), np.ones(2), [], []),
    "halfstrip": (np.eye(2), np.zeros(2), np.array([1.0, INF]),
                  [[0.0, 1.0]], []),
    "slab": (np.array([[1.0, 0.0]]), np.array([0.0]), np.array([1.0]),
             [], [[0.0, 1.0]]),
}


@pytest.mark.parametrize("case", sorted(RECESSION))
def test_recession(case):
    A, l, u, want_rays, want_lines = RECESSION[case]

    def run(M):
        r, ln = M("geometry.rays").recession(M("geometry.poly").Poly(A, l, u))
        return [_dirset(r), _dirset(ln)]
    want, got = run_both(run)
    assert got == want
    assert got == [_dirset(np.array(want_rays).reshape(-1, 2)),
                   _dirset(np.array(want_lines).reshape(-1, 2))]


def test_get_verts_returns_exact_rays():
    def run(M):
        p = M("geometry.poly").Poly(np.eye(2), np.zeros(2),
                                    np.array([1.0, INF]))
        V, R, L = M("geometry.vertices").get_verts(p)
        return [_dirset(R), len(L), sorted(tuple(np.round(v, 5)) for v in V)]
    want, got = run_both(run)
    assert got == want
    assert got[0] == _dirset([np.array([0.0, 1.0])]) and got[1] == 0
    assert (0.0, 0.0) in got[2] and (1.0, 0.0) in got[2]


def _hull_case(M, case):
    P, PU = M("geometry.poly").Poly, M("geometry.poly").PolyUnion
    hull = M("geometry.vertices").convex_hull
    if case == "two_halfstrips":
        h = hull(PU([P(np.eye(2), np.zeros(2), np.array([1.0, INF])),
                     P(np.eye(2), np.array([2.0, 0.0]),
                       np.array([3.0, INF]))]))
        pts = [(0, 0), (3, 0), (1.5, 7.0), (0, 100.0), (-0.1, 0), (3.1, 0),
               (1.0, -0.1)]
    elif case == "lineality_member":
        h = hull(PU([P(np.array([[1.0, 0.0]]), np.array([0.0]),
                       np.array([1.0])),
                     P(np.eye(2), np.array([2.0, 2.0]),
                       np.array([3.0, 3.0]))]))
        pts = [(0, -50), (3, 99), (1.5, 0), (-0.1, 0), (3.1, 5)]
    elif case == "points_plus_rays":
        h = M("geometry.rays").hull_of_points_and_rays(
            np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([[0.0, 1.0]]))
        pts = [(0, 0), (1, 5), (0.5, 0), (1.5, 0), (0, -0.2)]
    else:
        h = hull(PU([P(np.eye(2), np.zeros(2), np.ones(2)),
                     P(np.eye(2), np.array([2.0, 0.0]),
                       np.array([3.0, 1.0]))]))
        pts = [(0, 0), (3, 1), (1.5, 0.5), (1.5, 1.2), (-0.1, 0.5)]
    return [contains_all(h, pts), rows(h)]


HULL_TRUTH = {
    "two_halfstrips": [True] * 4 + [False] * 3,
    "lineality_member": [True] * 3 + [False] * 2,
    "points_plus_rays": [True] * 3 + [False] * 2,
    "bounded": [True] * 3 + [False] * 2,
}


@pytest.mark.parametrize("case", sorted(HULL_TRUTH))
def test_unbounded_hull(case):
    want, got = run_both(lambda M: _hull_case(M, case))
    assert_same(got, want, TOL)
    assert got[0] == HULL_TRUTH[case]


# ---- tests/test_geometry.py (cases tests/test_torch_setops.py lacks) -----

def _normalization(M):
    p = M("geometry.poly").Poly(np.array([[2.0, 0.0], [1.0, 0.0],
                                          [-3.0, 0.0]]),
                                [0.0, 0.0, -6.0], [2.0, 1.0, INF])
    return [p.m] + rows(p)


def _simplify(M):
    p = M("geometry.poly").Poly(np.array([[1.0, 0.0], [1.0, 0.0]]),
                                [0.0, 0.5], [2.0, 3.0], dedupe=False)
    s = p.simplify()
    return [s.m] + rows(s)


def _complement(M):
    comp = M("geometry").from_box([0.0], [1.0]).complement()
    return [len(comp)] + [comp.contains(np.array([v]))
                          for v in (-0.5, 1.5, 0.5)] + [rows(p)
                                                         for p in comp]


def _intersect_slice(M):
    G = M("geometry")
    c = G.intersect(G.from_box([0.0, 0.0], [2.0, 2.0]),
                    G.from_box([1.0, 1.0], [3.0, 3.0]))
    s = c.poly_slice(np.array([1.5, np.nan]))
    return [contains_all(c, ([1.5, 1.5], [0.5, 0.5])), s.dim,
            contains_all(s, ([1.5], [0.5])), rows(c), rows(s)]


def _subset_transitive(M):
    G = M("geometry")
    rng = np.random.default_rng(0)
    out = []
    for _ in range(10):
        lo = rng.standard_normal(3)
        hi = lo + 1 + rng.random(3)
        outer = G.from_box(lo, hi)
        inner = G.from_box(lo + 0.1, hi - 0.1)
        out.append([G.issubset(inner, outer),
                    G.issubset(G.intersect(inner, outer), outer),
                    G.issubset(outer, inner)])
    return out


def _hull_high_dim(M):
    rng = np.random.default_rng(7)
    d = 6
    pts = np.vstack([np.eye(d), -np.eye(d),
                     rng.uniform(-0.2, 0.2, size=(4, d))])
    h = M("geometry.vertices").hull_of_points(pts)
    e = np.zeros(d)
    e[0] = 0.999
    return [h.contains(np.zeros(d), tol=1e-8), h.contains(e, tol=1e-6),
            h.contains(np.full(d, 0.5), tol=1e-6),
            contains_all(h, pts), h.m]


def _strict_projection(M):
    P, setops = M("geometry.poly").Poly, M("geometry.setops")
    p = P(np.array([[1.0, 0.0], [1.0, 0.0]]), np.array([1.0, -INF]),
          np.array([INF, 1.0]), strict_l=np.array([True, False]),
          strict_u=np.array([False, True]), normalize=False)
    q = M("geometry.project").project(p, [1])
    return [setops.is_empty(p), setops.is_empty(q), rows(q)]


def _strict_simplify(M):
    P, setops = M("geometry.poly").Poly, M("geometry.setops")
    p = P(np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([0.0, -1.0]),
          np.array([INF, 1.0]), strict_l=np.array([True, False]),
          strict_u=np.array([False, False]), normalize=False)
    s = p.simplify()
    return [setops.is_empty(s), rows(s)]


def _strict_eliminate(M):
    A2, l2, u2, sl2, su2, rem = M(
        "geometry.project").eliminate_by_equalities(
        np.eye(2), np.array([1.0, 0.0]), np.array([1.0, 2.0]),
        np.array([True, False]), np.array([False, False]), [0])
    return [rem, A2, l2, u2, np.asarray(sl2).tolist(),
            np.asarray(su2).tolist()]


def _poly_key(M):
    P, key = M("geometry.poly").Poly, M("geometry.query_cache").poly_key
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    l, u = np.array([0.0, 1.0, 2.0]), np.array([5.0, 6.0, 7.0])
    perm = [2, 0, 1]
    p1 = P(A, l, u, normalize=False, dedupe=False)
    p2 = P(A[perm], l[perm], u[perm], normalize=False, dedupe=False)
    k1 = key(p1)
    return [k1, key(p2), p1._qkey]


def test_normalization_and_dedup():
    want, got = run_both(_normalization)
    assert_same(got, want, TOL)
    assert got[0] == 2 and np.allclose(got[1][:, 0], 1.0)


def test_simplify_merges_parallel_rows():
    want, got = run_both(_simplify)
    assert_same(got, want, TOL)
    assert got[0] == 1 and np.isclose(got[2][0], 0.5) and \
        np.isclose(got[3][0], 2.0)


def test_complement():
    want, got = run_both(_complement)
    assert_same(got, want, TOL)
    assert got[:4] == [2, True, True, False]


def test_intersect_and_slice():
    want, got = run_both(_intersect_slice)
    assert_same(got, want, TOL)
    assert got[0] == [True, False] and got[1] == 1 and got[2] == [True, False]


def test_property_subset_transitive():
    want, got = run_both(_subset_transitive)
    assert got == want
    assert all(r[:2] == [True, True] for r in got)


def test_hull_of_points_high_dim_polar():
    want, got = run_both(_hull_high_dim)
    assert got == want
    assert got[:3] == [True, True, False] and all(got[3])


@pytest.mark.parametrize("case", [_strict_projection, _strict_simplify,
                                  _strict_eliminate],
                         ids=["project_empty_open_slab",
                              "simplify_keeps_strict_zero_row",
                              "eliminate_skips_strict_markers"])
def test_strict_emptiness_through_projection(case):
    want, got = run_both(case)
    assert_same(got, want, TOL)
    if case is _strict_eliminate:
        assert got[0] == [0] and got[1].shape[0] == 2
    elif case is _strict_projection:
        assert got[:2] == [True, True]
    else:
        assert got[0]


def test_poly_key_row_order_invariant_and_memoized():
    want, got = run_both(_poly_key)
    assert got == want
    assert got[0] == got[1] == got[2]
