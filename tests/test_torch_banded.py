"""The port's cyclic-reduction block-tridiagonal solver
(``qpn_tpu_torch/ops/banded.py``) and the banded ADMM x-update against the
JAX package's (``qpn_tpu/ops/banded.py``, JAX on the CPU): the banded half
of ``tests/test_banded_ring.py`` on the same seeded numpy inputs.

Tolerances: block solves and products in f64 (the JAX package solves the
k×k blocks by QR, the port by LU), so x agrees with a dense solve and with
the JAX package's to 1e-8; the ADMM routes polish to ~1e-10, so banded and
dense x agree to 1e-8 as well."""

import numpy as np
import pytest
import torch

from qpn_tpu.config import CONFIG as JCONFIG
from qpn_tpu.ops import banded as ref_banded
from qpn_tpu.ops import batch_qp as ref_qp
from qpn_tpu.utils.metrics import METRICS as REF_METRICS

from qpn_tpu_torch import config
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import banded, batch_qp
from qpn_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _t(*arrays):
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


@pytest.mark.parametrize("T,k", [(4, 3), (8, 2), (13, 4), (32, 3), (1, 2)])
def test_cyclic_reduction_matches_dense_and_reference(T, k):
    A, B, C, b = banded.horizon_kkt_blocks(T, k, np.random.default_rng(T))
    x = banded.solve_block_tridiag(*_t(A, B, C, b)).numpy()
    M = banded.dense_from_blocks(A, B, C)
    x_dense = np.linalg.solve(M, b.reshape(-1)).reshape(T, k)
    np.testing.assert_allclose(x, x_dense, rtol=0, atol=TOL)
    x_ref = np.asarray(ref_banded.solve_block_tridiag(A, B, C, b))
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=TOL)


def test_horizon_blocks_equal_reference():
    got = banded.horizon_kkt_blocks(16, 6, np.random.default_rng(0))
    want = ref_banded.horizon_kkt_blocks(16, 6, np.random.default_rng(0))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(banded.dense_from_blocks(*got[:3]),
                                  ref_banded.dense_from_blocks(*want[:3]))


def test_cyclic_reduction_batched():
    """Leading batch axes: the port's function takes them directly where
    the JAX package vmaps (solve_block_tridiag_batch)."""
    rng = np.random.default_rng(0)
    batch = [banded.horizon_kkt_blocks(8, 3, rng) for _ in range(5)]
    A, B, C, bb = (np.stack([b[i] for b in batch]) for i in range(4))
    X = banded.solve_block_tridiag(*_t(A, B, C, bb)).numpy()
    want = np.asarray(ref_banded.solve_block_tridiag_batch(A, B, C, bb))
    np.testing.assert_allclose(X, want, rtol=0, atol=TOL)
    for i in range(5):
        M = banded.dense_from_blocks(A[i], B[i], C[i])
        x_ref = np.linalg.solve(M, bb[i].reshape(-1)).reshape(8, 3)
        np.testing.assert_allclose(X[i], x_ref, rtol=0, atol=TOL)


def test_cr_factor_solve_matches_dense():
    """One factorization, many right-hand sides (the ADMM reuse pattern)."""
    rng = np.random.default_rng(3)
    A, B, C, _ = banded.horizon_kkt_blocks(16, 4, rng)
    fac = banded.cr_factor(*_t(A, B, C))
    M = banded.dense_from_blocks(A, B, C)
    for _ in range(3):
        b = rng.standard_normal((16, 4))
        x = banded.cr_solve(fac, *_t(b)).numpy()
        np.testing.assert_allclose(M @ x.flatten(), b.flatten(), rtol=0,
                                   atol=TOL)
        x_ref = np.asarray(ref_banded.cr_solve(
            ref_banded.cr_factor(A, B, C), b))
        np.testing.assert_allclose(x, x_ref, rtol=0, atol=TOL)


def test_cr_factor_take_and_assign():
    """A lane subset of a batched factorization solves as the whole one,
    and assigning a refactored subset replaces only those lanes."""
    rng = np.random.default_rng(4)
    batch = [banded.horizon_kkt_blocks(8, 2, rng) for _ in range(4)]
    A, B, C, b = (torch.as_tensor(np.stack([x[i] for x in batch]))
                  for i in range(4))
    fac = banded.cr_factor(A, B, C)
    idx = torch.tensor([1, 3])
    np.testing.assert_array_equal(banded.cr_solve(fac.take(idx), b[idx]),
                                  banded.cr_solve(fac, b)[idx])
    other = banded.cr_factor(A[idx] * 2.0, B[idx] * 2.0, C[idx] * 2.0)
    fac.assign(idx, other)
    x = banded.cr_solve(fac, b)
    np.testing.assert_allclose(x[idx] * 2.0, banded.solve_block_tridiag(
        A[idx], B[idx], C[idx], b[idx]), rtol=0, atol=TOL)
    np.testing.assert_allclose(x[[0, 2]], banded.solve_block_tridiag(
        A[[0, 2]], B[[0, 2]], C[[0, 2]], b[[0, 2]]), rtol=0, atol=TOL)


def test_kkt_blocks_split_the_dense_matrix():
    A, B, C, _ = banded.horizon_kkt_blocks(6, 3, np.random.default_rng(1))
    K = torch.as_tensor(banded.dense_from_blocks(A, B, C))[None].repeat(2, 1,
                                                                         1)
    for got, want in zip(banded.kkt_blocks(K, 3), (A, B, C)):
        assert got.shape == (2, 6, 3, 3)
        np.testing.assert_array_equal(got[1].numpy(), want)


def _trajectory_qps(B=4, T=8, k=4, seed=5):
    """tests/test_banded_ring.py's trajectory QPs: P block-tridiagonal from
    horizon_kkt_blocks, box rows A = I."""
    rng = np.random.default_rng(seed)
    n = T * k
    Ps, qs = [], []
    for _ in range(B):
        A_, B_, C_, g = banded.horizon_kkt_blocks(T, k, rng)
        Q = banded.dense_from_blocks(A_, B_, C_)
        Ps.append(0.5 * (Q + Q.T) + 0.5 * np.eye(n))
        qs.append(g.flatten())
    P, q = np.stack(Ps), np.stack(qs)
    A = np.repeat(np.eye(n)[None], B, axis=0)
    return (P, q, A, np.full((B, n), -2.0), np.full((B, n), 2.0),
            np.ones((B, n), dtype=bool))


@pytest.mark.parametrize("T,k", [(8, 4), (16, 3)])
def test_banded_admm_matches_dense_and_reference(T, k):
    """banded_k routes the ADMM x-update through cyclic reduction: the
    same solution as the dense route and as the JAX package's banded
    route."""
    args = _trajectory_qps(T=T, k=k)
    t = _t(*args[:5]) + [torch.as_tensor(args[5])]
    dense = batch_qp.solve_qp_batch(*t)
    band = batch_qp.solve_qp_batch(*t, banded_k=k)
    assert (band.status == batch_qp.SOLVED).all()
    np.testing.assert_allclose(band.x.numpy(), dense.x.numpy(), rtol=0,
                               atol=TOL)
    want = ref_qp.solve_qp_batch(*args, banded_k=k)
    np.testing.assert_array_equal(band.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_allclose(band.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=TOL)


def test_banded_k_must_divide_n():
    args = _t(*_trajectory_qps(B=1)[:5]) + [torch.ones(1, 32,
                                                       dtype=torch.bool)]
    with pytest.raises(ValueError, match="banded_k"):
        batch_qp.solve_qp_batch(*args, banded_k=5)


def _chain(T=16, k=6, seed=7):
    rng = np.random.default_rng(seed)
    n = T * k
    P = np.zeros((n, n))
    for t in range(T):
        G = rng.standard_normal((k, k))
        P[t * k:(t + 1) * k, t * k:(t + 1) * k] = G @ G.T
    F = rng.standard_normal((k, k))
    A = np.zeros(((T - 1) * k, n))
    for t in range(T - 1):
        A[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = np.eye(k)
        A[t * k:(t + 1) * k, t * k:(t + 1) * k] = -F
    return P, A, rng


@pytest.mark.parametrize("case,min_blocks,expect", [
    ("chain", 8, 6), ("batched", 8, 6), ("dense_P", 8, 0),
    ("long_row", 8, 0), ("chain", 32, 0), ("chain", 2, 6)])
def test_detect_banded_k(case, min_blocks, expect):
    """Structure detection finds the block size of trajectory KKT patterns
    and 0 for dense ones, as the JAX package's does on the same input."""
    P, A, rng = _chain()
    if case == "batched":
        P, A = np.repeat(P[None], 3, 0), np.repeat(A[None], 3, 0)
    elif case == "dense_P":
        P = rng.standard_normal(P.shape)
    elif case == "long_row":
        A = A.copy()
        A[0, -1] = 1.0
    got = banded.detect_banded_k(P, A, min_blocks=min_blocks)
    assert got == expect
    assert got == ref_banded.detect_banded_k(P, A, min_blocks=min_blocks)


def _auto_route_batch(B=4, T=16, k=6):
    """tests/test_banded_ring.py's production-entry batch: block-diagonal
    P, dynamics equality rows."""
    rng = np.random.default_rng(11)
    n = T * k
    P = np.zeros((n, n))
    for t in range(T):
        G = rng.standard_normal((k, k))
        P[t * k:(t + 1) * k, t * k:(t + 1) * k] = G @ G.T / k + np.eye(k)
    F = 0.3 * rng.standard_normal((k, k))
    A = np.zeros(((T - 1) * k, n))
    for t in range(T - 1):
        A[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = np.eye(k)
        A[t * k:(t + 1) * k, t * k:(t + 1) * k] = -F
    c = 0.1 * rng.standard_normal((T - 1) * k)
    q = rng.standard_normal(n)
    rep = lambda a: np.repeat(a[None], B, 0)     # noqa: E731
    return (rep(P), rep(q), rep(A), rep(c), rep(c).copy(),
            np.ones((B, A.shape[0]), dtype=bool))


def test_banded_auto_route_production_entry(monkeypatch):
    """solve_qp_batch_padded detects the trajectory structure, takes the
    cyclic-reduction x-update (banded_route counts its lanes) and returns
    the dense route's solution, and the JAX package's routed one."""
    args = _auto_route_batch()
    monkeypatch.setattr(CONFIG, "banded_auto", False)
    dense = batch_qp.solve_qp_batch_padded(*args)
    monkeypatch.setattr(CONFIG, "banded_auto", True)
    monkeypatch.setattr(CONFIG, "banded_min_blocks_cpu", 8)
    before = METRICS.counters.get("banded_route", 0.0)
    routed = batch_qp.solve_qp_batch_padded(*args)
    assert METRICS.counters["banded_route"] == before + 4
    assert (routed.status == batch_qp.SOLVED).all()
    np.testing.assert_allclose(routed.x, dense.x, rtol=0, atol=TOL)

    monkeypatch.setattr(JCONFIG, "banded_auto", True)
    monkeypatch.setattr(JCONFIG, "banded_min_blocks_cpu", 8)
    REF_METRICS.reset()
    want = ref_qp.solve_qp_batch_padded(*args)
    assert REF_METRICS.counters.get("banded_route", 0) == 4
    np.testing.assert_array_equal(routed.status, np.asarray(want.status))
    np.testing.assert_allclose(routed.x, np.asarray(want.x), rtol=0,
                               atol=TOL)


def test_auto_route_stays_dense_below_the_block_count(monkeypatch):
    """At the CPU's 64 blocks (the JAX package's value) the 16-block batch
    keeps the dense x-update, as in the JAX package."""
    monkeypatch.setattr(CONFIG, "banded_auto", True)
    before = METRICS.counters.get("banded_route", 0.0)
    batch_qp.solve_qp_batch_padded(*_auto_route_batch(B=2))
    assert METRICS.counters.get("banded_route", 0.0) == before
    assert config.banded_min_blocks() == 64 == JCONFIG.banded_min_blocks_cpu


@pytest.mark.parametrize("device,want", [("cpu", 17), ("cuda", 0),
                                         ("cuda:0", 0)])
def test_banded_min_blocks_follows_the_device(monkeypatch, device, want):
    """The CPU takes its field; the card's automatic route is off (0)
    whatever the CPU field holds."""
    monkeypatch.setattr(CONFIG, "device", device)
    monkeypatch.setattr(CONFIG, "banded_min_blocks_cpu", 17)
    assert config.banded_min_blocks() == want
