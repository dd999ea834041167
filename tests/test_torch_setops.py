"""The port's geometry layer (``qpn_tpu_torch/geometry``: setops, project,
vertices, rays) against the JAX package's, on the cases of
``tests/test_geometry.py``, ``tests/test_rays.py`` and ``tests/test_pallas.py``
and on seeded random polyhedra.

Each case is one function of a package's ``geometry`` namespace, run on both
packages with the same numpy inputs.  Verdicts (emptiness, membership,
subset, implicit equalities, piece counts, vertex and ray sets at 4 digits)
must be equal.  Numbers from an LP engine (support values, exemplar points)
agree within 1e-7: both solve in f64 to ~1e-10 after the polish, the port
with an LU where the JAX package takes QR (see tests/test_torch_batch_qp.py).
"""

import numpy as np
import pytest
import torch

import qpn_tpu.geometry as ref_geo
from qpn_tpu.config import CONFIG as JCONFIG
from qpn_tpu.geometry import query_cache as ref_cache
from qpn_tpu.geometry import rays as ref_rays

import qpn_tpu_torch.geometry as geo
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry import query_cache, rays
from qpn_tpu_torch.utils.metrics import METRICS

# the engines run many tiny batched ops: intra-op threads make them no
# faster and contend with the other test workers
torch.set_num_threads(1)

INF = np.inf
TOL = 1e-7


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _emptiness(G):
    P = G.Poly
    closed = P(np.array([[1.0], [1.0]]), [-INF, 0.0], [0.0, INF],
               dedupe=False)
    strict = P(np.array([[1.0], [1.0]]), [-INF, 0.0], [0.0, INF],
               np.array([False, True]), np.array([True, False]),
               dedupe=False)
    apart = P(np.array([[1.0], [1.0]]), [1.0, -INF], [INF, 0.0],
              dedupe=False)
    slab = P(np.array([[1.0], [1.0]]), [0.0, -INF], [INF, -5e-4],
             dedupe=False)            # empty by 5e-4: decided by the tol
    return ([G.is_empty(p) for p in (closed, strict, apart)]
            + [G.is_empty(slab, tol=1e-4), G.is_empty(slab, tol=1e-2)])


def _membership(G):
    P = G.Poly
    p = P(np.array([[1.0, 0], [0, 1.0], [1.0, 1.0]]), [0, 0, -INF],
          [1, 1, 1.0])
    box = G.from_box([0.0, 0.0], [1.0, 1.0])
    return [G.contains(np.array([0.2]), p), G.contains(np.array([2.0]), p),
            G.contains(np.array([0.5, 0.5]), box),
            G.contains(np.array([1.5, 0.5]), box)]


def _subset(G):
    inner = G.from_box([0.2, 0.2], [0.8, 0.8])
    outer = G.from_box([0.0, 0.0], [1.0, 1.0])
    third = G.intersect(inner, G.from_box([0.5, 0.0], [2.0, 2.0]))
    pairs = [(inner, outer), (outer, inner), (third, outer), (third, inner)]
    return list(G.issubset_pairs(pairs)) + [G.issubset(inner, outer)]


def _remove_subsets(G):
    pu = G.PolyUnion([G.from_box([0.0], [1.0]), G.from_box([0.0], [1.0]),
                      G.from_box([2.0], [3.0]),
                      G.from_box([2.2], [2.8])])
    kept = G.remove_subsets(pu)
    return [len(kept)] + [np.round(np.concatenate([p.l, p.u]), 9).tolist()
                          for p in kept]


def _implicit(G):
    p = G.Poly(np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]),
               [1.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    impl, vals = G.implicit_bounds(p)
    wide = G.Poly(np.array([[1.0]]), [1e6], [1e6 + 5.0])
    return [impl.tolist(), np.round(vals[impl], 9).tolist(),
            G.intrinsic_dim(p), G.implicit_bounds(wide)[0].tolist()]


def _projection(G):
    simplex = G.Poly(np.vstack([np.eye(3), np.ones((1, 3))]),
                     [0, 0, 0, 1.0], [INF, INF, INF, 1.0])
    pr = G.project(simplex, [0, 1])
    eq = G.project(G.Poly(np.array([[1.0, 1.0], [1.0, 0.0]]), [1.0, 0.0],
                          [1.0, 1.0]), [0])
    pts = ([[0.3, 0.3], [0.7, 0.7], [-0.1, 0.5], [0.0, 1.0]], [[0.5], [1.5]])
    return ([pr.dim, pr.m, eq.dim]
            + [pr.contains(np.array(x), tol=1e-6) for x in pts[0]]
            + [eq.contains(np.array(x)) for x in pts[1]])


def _verts(G):
    box = G.from_box([0.0, 0.0], [1.0, 1.0])
    V, R, L = G.get_verts(box, rng=np.random.default_rng(0))
    point = G.Poly(np.eye(2), [0.3, 0.7], [0.3, 0.7])
    Vp, _, _ = G.get_verts(point)
    strip = G.Poly(np.eye(2), np.zeros(2), np.array([1.0, INF]))
    Vs, Rs, Ls = G.get_verts(strip)
    rnd = lambda vs: sorted(tuple(np.round(v, 4)) for v in vs)  # noqa: E731
    return [rnd(V), len(R), len(L), rnd(Vp), rnd(Vs), rnd(Rs), len(Ls)]


def _random_exemplars(G):
    """Seeded random polyhedra: emptiness verdicts and exemplar points."""
    polys = G.random_polys_of_dim(np.random.default_rng(5), 20, 3)
    empty, ex = G.exemplar_batch(polys)
    pts = [None if e is None else np.round(e, 6).tolist() for e in ex]
    return [empty.tolist(), pts]


def _support(G):
    rng = np.random.default_rng(8)
    polys, dirs = [], []
    for k in range(12):
        n = 3
        A = rng.standard_normal((5, n))
        c = rng.standard_normal(n)
        l = A @ c - rng.random(5) - 0.1
        u = np.where(rng.random(5) < 0.4, INF, A @ c + rng.random(5))
        if k == 3:
            u[:] = INF                  # unbounded below in some direction
        polys.append(G.Poly(A, l, u))
        dirs.append(rng.standard_normal(n))
    vals, stat = G.support_batch(polys, dirs)
    return [stat.tolist(), np.round(vals, 7).tolist()]


CASES = {f.__name__.lstrip("_"): f for f in (
    _emptiness, _membership, _subset, _remove_subsets, _implicit,
    _projection, _verts, _random_exemplars, _support)}


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages memoize query results process-wide by content: clear
    them so every case runs its LPs."""
    query_cache.CACHE.clear()
    ref_cache.CACHE.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_geometry_case_matches_reference(case):
    got = CASES[case](geo)
    want = CASES[case](ref_geo)
    assert got == want


def _screen_cases(G):
    """tests/test_pallas.py's two screen batches and a seeded one at
    robust_avoid's piece shape, with the emptiness truth."""
    P = G.Poly
    a = [G.from_box([0.0], [1.0]) for _ in range(4)] + [
        P(np.array([[1.0], [1.0]]), [2.0, -INF], [INF, 1.0], dedupe=False)]
    rng = np.random.default_rng(11)
    b, truth_b = [], []
    for k in range(8):
        A = np.vstack([np.eye(4), rng.standard_normal((3, 4))])
        lo = np.ones(4) if k % 2 == 0 else np.zeros(4)
        hi = -np.ones(4) if k % 2 == 0 else np.ones(4)
        b.append(P(A, np.concatenate([lo, np.full(3, -10.0)]),
                   np.concatenate([hi, np.full(3, 10.0)])))
        truth_b.append(k % 2 == 0)
    rng = np.random.default_rng(3)
    c, truth_c = [], []
    for k in range(16):
        A = rng.standard_normal((18, 18))
        ax = A @ (0.1 * rng.standard_normal(18))
        l, u = ax - 0.5 - rng.random(18), ax + 0.5 + rng.random(18)
        if k % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, INF
            l[1], u[1] = -INF, ax[0] - 1.0
        c.append(P(A, l, u, normalize=False, dedupe=False))
        truth_c.append(bool(k % 2))
    return {"pallas_flag": (a, [False] * 4 + [True]),
            "pallas_wired": (b, truth_b), "seeded_18x18": (c, truth_c)}


@pytest.mark.parametrize("screen", ["off", "on"])
@pytest.mark.parametrize("batch", ["pallas_flag", "pallas_wired",
                                   "seeded_18x18"])
def test_is_empty_batch_matches_reference(monkeypatch, batch, screen):
    """is_empty_batch with the screen off and on (the JAX package's Pallas
    kernel in interpret mode, the port's plain loop): the same verdicts as
    the JAX package and as the truth; with the screen on it witnesses
    polyhedra."""
    on = screen == "on"
    monkeypatch.setattr(CONFIG, "use_screen", on)
    monkeypatch.setattr(JCONFIG, "use_pallas_screen", on)
    polys, truth = _screen_cases(geo)[batch]
    ref_polys, _ = _screen_cases(ref_geo)[batch]
    before = METRICS.counters.get("screen_witnessed", 0.0)
    got = geo.is_empty_batch(polys)
    want = ref_geo.is_empty_batch(ref_polys)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, truth)
    witnessed = METRICS.counters.get("screen_witnessed", 0.0) - before
    assert (witnessed > 0) == on


def test_screen_is_skipped_for_strict_rows(monkeypatch):
    """The JAX package's gate: no screen for a batch holding strict rows
    (or fewer than 4 polyhedra); the exact LPs decide."""
    monkeypatch.setattr(CONFIG, "use_screen", True)
    polys = [geo.from_box([0.0], [1.0]) for _ in range(4)]
    polys.append(geo.Poly(np.array([[1.0]]), [0.0], [1.0],
                          np.array([True]), np.array([False])))
    before = METRICS.counters.get("screen_polys", 0.0)
    assert not geo.is_empty_batch(polys).any()
    assert not geo.is_empty_batch(polys[:3]).any()
    assert METRICS.counters.get("screen_polys", 0.0) == before


def test_screen_failure_raises(monkeypatch):
    """A screen engine that fails raises out of is_empty_batch (no silent
    fallback to the exact LPs)."""
    from qpn_tpu_torch.ops import screen as screen_mod
    monkeypatch.setattr(CONFIG, "use_screen", True)

    def broken(*a, **k):
        raise RuntimeError("screen engine failed")

    monkeypatch.setattr(screen_mod, "screen_engine", lambda dev: broken)
    with pytest.raises(RuntimeError, match="screen engine failed"):
        geo.is_empty_batch([geo.from_box([0.0], [1.0]) for _ in range(4)])


def test_screen_auto_rule(monkeypatch):
    """use_screen=None: off while the native engine answers the emptiness
    LPs, otherwise on for a CUDA device only."""
    from qpn_tpu_torch.config import screen_enabled
    monkeypatch.setattr(CONFIG, "use_screen", None)
    assert not screen_enabled()
    monkeypatch.setattr(CONFIG, "device", "cuda")
    assert not screen_enabled()
    monkeypatch.setattr(CONFIG, "empty_engine", "admm")
    assert screen_enabled()
    monkeypatch.setattr(CONFIG, "device", "cpu")
    assert not screen_enabled()


@pytest.mark.parametrize("case", ["orthant", "halfspace", "cone", "whole"])
def test_cone_rays_match_reference(case):
    A = {"orthant": np.eye(3), "halfspace": np.array([[1.0, 0.0]]),
         "cone": np.array([[-1.0, 1.0], [1.0, 1.0]]),
         "whole": np.zeros((0, 2))}[case]
    got = rays.cone_extreme_rays(A)
    want = ref_rays.cone_extreme_rays(A)
    for g, w in zip(got, want):          # rays, then lines
        assert len(g) == len(w)
        for gv, wv in zip(g, w):
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-12)
