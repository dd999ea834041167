"""The Lemke kernel's decision code on degenerate inputs, and its scans
against numpy.

The kernel's lane code (``csrc/lemke_lane.cuh``, built for the host with
g++) decides each pivot with scans over the rows joined by warp votes and
reductions; on the host one thread scans every row.  Degenerate problems
(integer data, duplicated variables, so that ratios tie exactly and the
lexicographic refinement needs several passes) go through the host
instance, the plain PyTorch loop and the JAX package's XLA engine: identical
status and pivot counts lane for lane, in f32 and f64.  The scans' host bodies are held against numpy on
arrays with repeated minima, NaN and ±inf.
"""

import ctypes

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import lemke, lemke_cuda
from qpn_tpu_torch.ops.lemke_cuda import lemke_pivot_host

from test_torch_lemke import (HOT, assert_same_path, port_state,
                              reference_state, tensors)

F64 = dict(tol=1e-11, piv_tol=1e-11)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def degenerate_lcp(B, n, seed):
    """Integer PSD box LCPs whose variables come in identical pairs: every
    ratio test ties exactly (in f32 as in f64), and the tie is broken only
    by the lexicographic rule.  A third of the variables have a finite
    upper bound, so bound flips tie too."""
    rng = np.random.default_rng(seed)
    half = (n + 1) // 2
    L = rng.integers(-1, 2, size=(B, half, 3)).astype(np.float64)
    Mh = np.einsum("bik,bjk->bij", L, L)
    idx = np.arange(n) // 2                       # variable -> its twin class
    M = Mh[:, idx][:, :, idx] + np.eye(n)[None]   # twins differ on the diagonal
    M[:, np.arange(n), np.arange(n)] = Mh[:, idx, idx] + 1.0
    q = rng.integers(-3, 1, size=(B, half)).astype(np.float64)[:, idx]
    l = np.zeros((B, n))
    u = np.full((B, n), np.inf)
    u[:, ::3] = 1.0
    return (np.ascontiguousarray(M), np.ascontiguousarray(q), l, u,
            np.ones((B, n), bool))


@pytest.mark.parametrize("dtype,kw", [(np.float32, HOT), (np.float64, F64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [3, 8, 38, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_lane_on_ties_matches_plain_loop_and_xla_engine(seed, n, dtype,
                                                             kw):
    problem = degenerate_lcp(6, n, seed)
    ref = reference_state(*problem, 1024, dtype=dtype, **kw)
    plain = port_state(*problem, 1024, lemke.lemke_pivot_torch, dtype=dtype,
                       **kw)
    host = port_state(*problem, 1024, lemke_pivot_host, dtype=dtype, **kw)
    assert_same_path(host, ref, problem)
    assert torch.equal(host[1], plain[1])
    assert torch.equal(host[2], plain[2])
    assert int(host[2].max()) > 0


@pytest.mark.parametrize("seed", [2, 3, 4, 5])
def test_split_sums_make_the_same_choices_on_ties(seed):
    """The split of the basic-value sums over four threads changes the order
    of each sum, not the path: on integer data every order gives the same
    bits, so the host lane ends on the plain loop's basis."""
    problem = degenerate_lcp(6, 38, seed=seed)
    M, q, l, u = tensors(np.float32, *problem[:4])
    init = lemke.lemke_setup(M, q, l, u, torch.zeros_like(q),
                             torch.as_tensor(problem[4]), tol=HOT["tol"])
    plain = lemke.lemke_pivot_torch(init, max_pivots=1024, **HOT)
    host = lemke_pivot_host(init, max_pivots=1024, **HOT)
    assert torch.equal(host.status, plain.status)
    assert torch.equal(host.piv, plain.piv)
    np.testing.assert_array_equal(host.basis.numpy(), plain.basis.numpy())


# ---- the decision's scans, host bodies against numpy -----------------------

INF, NAN = np.inf, np.nan
SCAN_ARRAYS = [
    ("repeated_min", [3.0, 1.0, 2.0, 1.0, 1.0, 5.0]),
    ("nan_first", [NAN, 4.0, 2.0, NAN, 2.0]),
    ("all_nan", [NAN, NAN, NAN]),
    ("infs", [INF, -INF, 0.0, -INF, INF]),
    ("all_inf", [INF, INF]),
    ("signed_zeros", [0.0, -0.0, 0.0]),
    ("one", [7.0]),
    ("long", list(np.random.default_rng(5).integers(0, 4, 70).astype(float))),
]


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("name,values", SCAN_ARRAYS,
                         ids=[a[0] for a in SCAN_ARRAYS])
def test_scan_min_matches_numpy(name, values):
    """min under `<` from +inf: NaN is skipped (numpy's nanmin, +inf where
    every entry is NaN)."""
    lib = lemke_cuda.LIB.host()
    v = np.asarray(values, dtype=np.float64)
    want = np.inf if np.isnan(v).all() else min(np.nanmin(v), np.inf)
    assert lib.qpn_lk_scan_min_f64(_ptr(v), len(v)) == want
    v32 = v.astype(np.float32)
    assert lib.qpn_lk_scan_min_f32(_ptr(v32), len(v32)) == np.float32(want)


@pytest.mark.parametrize("thr", [-INF, 0.0, 1.0, 2.0, INF, NAN])
@pytest.mark.parametrize("name,values", SCAN_ARRAYS,
                         ids=[a[0] for a in SCAN_ARRAYS])
def test_scan_ties_matches_numpy(name, values, thr):
    """The tie set (ballot and ordered compaction) and the first tagged tie
    (first-index argmin) against numpy's flatnonzero."""
    lib = lemke_cuda.LIB.host()
    v = np.asarray(values, dtype=np.float64)
    n = len(v)
    rng = np.random.default_rng(n)
    tag = rng.integers(0, 3, n).astype(np.int32)
    want = 2
    out = np.full(n, -1, dtype=np.int32)
    first = ctypes.c_int(-5)
    count = lib.qpn_lk_scan_ties_f64(_ptr(v), _ptr(tag), n, thr, want,
                                     _ptr(out), ctypes.byref(first))
    with np.errstate(invalid="ignore"):
        ties = np.flatnonzero(v <= thr)
    assert count == len(ties)
    np.testing.assert_array_equal(out[:count], ties)
    assert (out[count:] == -1).all()
    tagged = ties[tag[ties] == want]
    assert first.value == (tagged[0] if len(tagged) else n)


def test_tableau_row_stride_is_odd():
    lib = lemke_cuda.LIB.host()
    for n in (1, 2, 3, 8, 38, 40, 129):
        ld = lib.qpn_lemke_lane_stride(n)
        assert ld % 2 == 1 and 3 * n + 2 <= ld <= 3 * n + 3
