"""The port's native host library (``qpn_tpu_torch/csrc/qpn_host.cpp``, its own
copy, built by ``utils/native.py``) against the JAX package's library and
against its plain Python versions, on the cases of ``tests/test_native.py``
and ``tests/test_host_engine.py``: the recipe product and its cap, the
quantized dedup (half-to-even, inf-safe, empty rows) and hash, the native
Lemke engine against the numpy oracle, its warm start, the host LP engine
against the ADMM, and the engine routing of the geometry layer.

Both libraries are built from the same C++ source, so their outputs must be
equal bit for bit; the plain versions must give the same recipes and masks
(the plain hash is Python's own: only which rows collide must agree).  LP
numbers between packages agree to 1e-7; the host engine against the ADMM
within the JAX test's 1e-5.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from qpn_tpu.ops import batch_qp as ref_batch_qp
from qpn_tpu.ops import lemke as ref_lemke
from qpn_tpu.utils import native as ref_native
from qpn_tpu.config import CONFIG as JCONFIG
from qpn_tpu.geometry import query_cache as ref_cache
from qpn_tpu.geometry import setops as ref_setops
from qpn_tpu.geometry.poly import Poly as RefPoly
from qpn_tpu.geometry.poly import random_polys_of_dim as ref_random_polys

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry import query_cache, setops
from qpn_tpu_torch.geometry.poly import Poly, random_polys_of_dim
from qpn_tpu_torch.ops import batch_qp
from qpn_tpu_torch.ops.lemke import (LEMKE_SUCCESS, solve_lemke_np,
                                     solve_lp_host_batch)
from qpn_tpu_torch.utils import native
from tests.test_lemke import random_box_avi

torch.set_num_threads(1)

LP_TOL = 1e-7
INF = np.inf


@pytest.fixture(autouse=True)
def _cpu_and_reference_library(monkeypatch):
    """The port on the CPU; the JAX package's library loaded again where
    this worker lost its loader's build race (ROADMAP F4)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")
    if ref_native._LIB is None:
        monkeypatch.setattr(ref_native, "_TRIED", False)
        ref_native._load()
    query_cache.CACHE.clear()
    ref_cache.CACHE.clear()


def nat_res(M, q, l, u, z):
    F = M @ z + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(z - F, l, u)
    return np.abs(z - proj).max()


# ---- tests/test_native.py ------------------------------------------------

def test_first_load_from_many_threads_builds_once(monkeypatch, tmp_path):
    """Threads that make the first call together (lockstep scenarios) get
    one library, built once into a fresh build directory."""
    from qpn_tpu_torch.utils import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    libs, errors = [], []

    def first_call():
        try:
            libs.append(native._load())
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]


def test_native_builds():
    """Both libraries build and load; the port's from its own copy into
    ``build/qpn_tpu_torch/``."""
    assert native.library_path().exists() and ref_native.native_available()
    path = native.library_path()
    assert path.parent.name == "qpn_tpu_torch"
    assert path.parent.parent.name == "build"
    assert native._SOURCE.parent.name == "csrc"


@pytest.mark.parametrize("J,cap", [
    ([{1, 2}, {5}, {6, 7, 8}], 1000),
    ([{1, 2}] * 12, 100),
    ([{1}, set(), {2}], 100),
    ([set()], 100),
], ids=["itertools", "cap", "empty_row", "only_empty"])
def test_recipe_product(J, cap):
    got = native.recipe_product(J, cap)
    np.testing.assert_array_equal(got, ref_native.recipe_product(J, cap))
    np.testing.assert_array_equal(got, native.recipe_product_plain(J, cap))
    want = list(itertools.islice(
        itertools.product(*[sorted(s) for s in J]), cap))
    assert got.shape == (len(want), len(J))
    assert [tuple(r) for r in got] == want
    assert len({tuple(r) for r in got}) == len(want)


DEDUP_CASES = {
    "quantized": (np.array([[0.1234567, 1.0], [0.1234572, 1.0],
                            [0.1234467, 1.0], [0.1234567, 1.0]]),
                  [True, False, True, False]),
    "inf_safe": (np.array([[1e200, 0.0], [1e200, 0.0], [-1e200, 0.0]]),
                 [True, False, True]),
    "half_to_even": (np.array([[0.5e-5], [0.0], [1.5e-5], [2.5e-5],
                               [-0.5e-5]]),
                     [True, False, True, False, False]),
    "no_rows": (np.zeros((0, 3)), []),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedupe_rows(case):
    data, want = DEDUP_CASES[case]
    got = native.dedupe_rows_mask(data, 5)
    assert got.tolist() == want
    assert ref_native.dedupe_rows_mask(data, 5).tolist() == want
    assert native.dedupe_rows_mask_plain(data, 5).tolist() == want


def test_quantize_hash_consistency():
    data = np.random.default_rng(0).standard_normal((50, 4))
    h1 = native.quantize_hash(data)
    np.testing.assert_array_equal(h1, ref_native.quantize_hash(data))
    np.testing.assert_array_equal(h1, native.quantize_hash(data + 1e-9))
    assert not np.array_equal(h1, native.quantize_hash(data + 1e-3))


@pytest.mark.parametrize("seed", range(3))
def test_library_matches_plain_versions(seed):
    """Seeded rows with repeats and near-repeats: the library's dedup mask
    and recipes equal the plain versions'."""
    rng = np.random.default_rng(seed)
    data = np.round(rng.standard_normal((60, 3)), 4)
    data[rng.integers(0, 60, 20)] = data[rng.integers(0, 60, 20)]
    data[::7] += 4e-7                       # below the 5-digit resolution
    data[::11] = -0.0 * data[::11]
    np.testing.assert_array_equal(native.dedupe_rows_mask(data),
                                  native.dedupe_rows_mask_plain(data))
    J = [set(rng.integers(1, 9, rng.integers(1, 4)).tolist())
         for _ in range(6)]
    np.testing.assert_array_equal(native.recipe_product(J, 50),
                                  native.recipe_product_plain(J, 50))


# ---- tests/test_host_engine.py -------------------------------------------

@pytest.mark.parametrize("kind", range(4))
def test_native_lemke_matches_python_oracle(kind):
    rng = np.random.default_rng(11 + kind)
    M, q, l, u = map(np.stack, zip(*[random_box_avi(rng, 9, kind)
                                     for _ in range(8)]))
    z, status, piv = native.lemke_batch(M, q, l, u)
    rz, rstatus, rpiv = ref_native.lemke_batch(M, q, l, u)
    np.testing.assert_array_equal(status, rstatus)
    np.testing.assert_array_equal(piv, rpiv)
    np.testing.assert_array_equal(z, rz)
    for b in range(8):
        zp, stp, _ = solve_lemke_np(M[b], q[b], l[b], u[b])
        assert status[b] == stp, (kind, b)
        if status[b] == LEMKE_SUCCESS:
            assert nat_res(M[b], q[b], l[b], u[b], z[b]) <= 1e-7
            np.testing.assert_allclose(z[b], zp, atol=1e-7)


def test_warm_start_path():
    rng = np.random.default_rng(3)
    n = 6
    R = rng.standard_normal((n, n))
    M = (R @ R.T + 0.5 * np.eye(n))[None]
    q = rng.standard_normal((1, n))
    l, u = np.zeros((1, n)), np.full((1, n), INF)
    z, st, piv = native.lemke_batch(M, q, l, u)
    z2, st2, piv2 = native.lemke_batch(M, q, l, u, z0=z)
    for a, b in zip((z, st, piv, z2, st2, piv2),
                    ref_native.lemke_batch(M, q, l, u)
                    + ref_native.lemke_batch(M, q, l, u, z0=z)):
        np.testing.assert_array_equal(a, b)
    assert st[0] == st2[0] == LEMKE_SUCCESS and piv2[0] <= piv[0]
    np.testing.assert_allclose(z2[0], z[0], atol=1e-8)


def _lp_batch():
    rng = np.random.default_rng(7)
    B, m, n = 16, 8, 5
    A = rng.standard_normal((B, m, n))
    c = rng.standard_normal((B, n))
    Ax0 = np.einsum("bmn,bn->bm", A, rng.standard_normal((B, n)))
    l = Ax0 - np.abs(rng.standard_normal((B, m))) - 0.1
    u = Ax0 + np.abs(rng.standard_normal((B, m))) + 0.1
    A2 = np.concatenate([A, np.tile(np.eye(n)[None], (B, 1, 1))], axis=1)
    l2 = np.concatenate([l, np.full((B, n), -5.0)], axis=1)
    u2 = np.concatenate([u, np.full((B, n), 5.0)], axis=1)
    mask = np.ones((B, m + n), dtype=bool)
    mask[::2, m - 1] = False
    return c, A2, l2, u2, mask


def test_host_lp_matches_admm_objectives():
    c, A, l, u, mask = _lp_batch()
    B, _, n = A.shape
    sol = solve_lp_host_batch(c, A, l, u, mask)
    ref = ref_lemke.solve_lp_host_batch(c, A, l, u, mask)
    np.testing.assert_array_equal(sol.status, ref.status)
    for f in ("x", "y", "obj"):
        np.testing.assert_allclose(getattr(sol, f), np.asarray(getattr(
            ref, f)), rtol=0, atol=LP_TOL)
    admm = batch_qp.solve_qp_batch_padded(np.zeros((B, n, n)), c, A, l, u,
                                          mask, _no_lemke=True)
    for b in range(B):
        assert sol.status[b] == batch_qp.SOLVED
        np.testing.assert_allclose(sol.obj[b], np.asarray(admm.obj)[b],
                                   atol=1e-5)
        act = np.nonzero(mask[b])[0]
        g = c[b] + A[b][act].T @ np.asarray(sol.y[b])[act]
        np.testing.assert_allclose(g, 0.0, atol=1e-7)


def test_host_lp_unbounded_status():
    A = np.zeros((1, 2, 3))
    A[0, 0, 0] = A[0, 1, 1] = 1.0
    c = np.zeros((1, 3))
    c[0, 0] = 1.0
    l, u = np.array([[-INF, -1.0]]), np.array([[5.0, 1.0]])
    mask = np.ones((1, 2), dtype=bool)
    sol = solve_lp_host_batch(c, A, l, u, mask)
    ref = ref_lemke.solve_lp_host_batch(c, A, l, u, mask)
    assert sol.status[0] == ref.status[0] == batch_qp.DUAL_INFEASIBLE
    assert ref_batch_qp.DUAL_INFEASIBLE == batch_qp.DUAL_INFEASIBLE


def _with_engine(monkeypatch, field, value):
    monkeypatch.setattr(CONFIG, field, value)
    monkeypatch.setattr(JCONFIG, field, value)
    query_cache.CACHE.clear()
    ref_cache.CACHE.clear()


def test_empty_verdicts_match_admm(monkeypatch):
    """The host engine's verdicts equal the ADMM's, in both packages."""
    out = {}
    for engine in ("admm", "host"):
        _with_engine(monkeypatch, "empty_engine", engine)
        out[engine] = (
            setops.is_empty_batch(random_polys_of_dim(
                np.random.default_rng(5), 30, 3)),
            ref_setops.is_empty_batch(ref_random_polys(
                np.random.default_rng(5), 30, 3)))
    for got in (out["admm"][0], out["host"][0], out["host"][1]):
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(out["admm"][1]))


def test_witness_cache_not_polluted(monkeypatch):
    """A verdict-only host query leaves no witness-grade cache entry: the
    later exemplar call still yields the ADMM witness, in both packages and
    to the same point."""
    _with_engine(monkeypatch, "empty_engine", "host")
    out = []
    for P, mod in ((Poly, setops), (RefPoly, ref_setops)):
        p = P(np.eye(2), np.zeros(2), np.array([2.0, 2.0]))
        assert not mod.is_empty(p)
        empty, ex = mod.exemplar_batch([p])
        assert not empty[0] and ex[0] is not None
        assert p.contains(ex[0], 1e-8)
        out.append(np.asarray(ex[0]))
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=LP_TOL)


def test_support_engine_host_matches_admm(monkeypatch):
    vals = {}
    for engine in ("admm", "host"):
        _with_engine(monkeypatch, "support_engine", engine)
        rng = np.random.default_rng(9)
        polys = random_polys_of_dim(rng, 12, 3)
        dirs = [rng.standard_normal(3) for _ in polys]
        rng = np.random.default_rng(9)
        ref_polys = ref_random_polys(rng, 12, 3)
        ref_dirs = [rng.standard_normal(3) for _ in ref_polys]
        vals[engine] = (np.asarray(setops.support_batch(polys, dirs)[0]),
                        np.asarray(ref_setops.support_batch(ref_polys,
                                                            ref_dirs)[0]))
    host, ref_host = vals["host"]
    np.testing.assert_allclose(host, ref_host, rtol=0, atol=LP_TOL)
    for a, b in zip(host, vals["admm"][0]):
        if np.isfinite(a) or np.isfinite(b):
            np.testing.assert_allclose(a, b, atol=1e-5)
