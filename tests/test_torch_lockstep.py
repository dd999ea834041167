"""The port's lockstep scenario-ensemble broker
(``qpn_tpu_torch/parallel/lockstep.py``): the analogue of
``tests/test_lockstep.py`` less its mesh test, held to the port's serial
path and to the JAX package's on the same inputs.

Tolerances: on the CPU each lane of the port's batched ADMM, AVI and LU work
gives the same numbers whatever its batchmates, so a lockstep scenario takes
its serial path: x_opt within 1e-9 of the serial solve with equal QEP and
piece counts, and within 1e-9 of the JAX package's lockstep solve (both
packages solve each QEP to 1e-10 along the same trajectory).  Fused LP
batches give each lane its direct call's x and objective to 1e-9."""

import sys
import threading

import numpy as np
import pytest
import torch

import qpn_tpu as ref_qt
from qpn_tpu.ops import lemke as ref_lemke
from qpn_tpu.parallel.lockstep import solve_many_lockstep as ref_lockstep
from qpn_tpu.utils import native as ref_native

import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry.query_cache import CACHE
from qpn_tpu_torch.ops import avi, batch_qp
from qpn_tpu_torch.ops.lemke import solve_lp_host_batch
from qpn_tpu_torch.parallel import lockstep
from qpn_tpu_torch.parallel.lockstep import (LockstepBroker, _Request,
                                             active_broker,
                                             solve_many_lockstep)
from qpn_tpu_torch.utils.metrics import METRICS
from qpn_tpu_torch.utils.native import library_path

torch.set_num_threads(1)

X_TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture(autouse=True)
def _reference_native_loaded(monkeypatch):
    """Load the JAX package's native library again where this worker lost
    the build race of its loader (``qpn_tpu/utils/native.py``: test workers
    build through one shared temporary name, and a loser keeps the
    pure-Python fallback for its life).  By test time the winner's library
    is on disk."""
    if ref_native._LIB is None:
        monkeypatch.setattr(ref_native, "_TRIED", False)
        ref_native._load()


def _scenarios():
    ws = [np.array([0.0, 1.0]), np.array([1.0, 1.5]), np.array([-1.0, 0.5])]
    return [np.concatenate([w, [0.0, 0.0]]) for w in ws], ws


def _pieces(ret):
    return {k: len(list(v)) for k, v in ret.Sol.items() if v is not None}


def test_matches_serial_path_and_reference():
    x0s, ws = _scenarios()
    serial = []
    for x0 in x0s:
        ret = qt.solve(qt.setup("simple_bilevel"), x0)
        assert ret.solved
        serial.append(ret)
    outs, broker = solve_many_lockstep(
        [qt.setup("simple_bilevel") for _ in x0s], x0s)
    assert broker.waves >= 1              # batched calls actually fused
    ref_outs, _ = ref_lockstep([ref_qt.setup("simple_bilevel") for _ in x0s],
                               x0s)
    for s, o, r, w in zip(serial, outs, ref_outs, ws):
        assert o.solved and r.solved
        np.testing.assert_allclose(o.x_opt, s.x_opt, rtol=0, atol=X_TOL)
        np.testing.assert_allclose(o.x_opt, r.x_opt, rtol=0, atol=X_TOL)
        assert _pieces(o) == _pieces(s)
        # follower response of simple_bilevel: x = w
        np.testing.assert_allclose(o.x_opt[:2], w, atol=1e-6)


def test_robust_avoid_ensemble_matches_serial():
    """robust_avoid at the zoo's configuration (T=2, num_obj=1,
    num_poly_faces=3) from the default init and from a perturbed flat
    init: each lockstep scenario ends at its serial solve's x_opt with its
    QEP and piece counts, and the fused waves make fewer ADMM calls than
    the serial runs together."""
    kw = dict(T=2, num_obj=1, num_poly_faces=3)
    flat = qt.setup("robust_avoid", **kw).get_flat_initialization()
    x0s = [None, flat + 0.05 * np.random.default_rng(1).standard_normal(
        flat.shape)]
    serial, admm_calls, keys = [], 0.0, ("qep_solves", "pieces_projected")
    for x0 in x0s:
        CACHE.clear()
        qpn = qt.setup("robust_avoid", **kw)
        ret = qt.solve(qpn, x0)
        assert ret.solved
        serial.append((ret, [qpn.metrics.counters[k] for k in keys]))
        admm_calls += METRICS.counters["admm_calls"]
    CACHE.clear()
    METRICS.reset(launches=False)
    qpns = [qt.setup("robust_avoid", **kw) for _ in x0s]
    outs, broker = solve_many_lockstep(qpns, x0s)
    assert broker.waves >= 1 and broker.dispatch_s > 0
    assert METRICS.counters["admm_calls"] < admm_calls
    for (s, counts), o in zip(serial, outs):
        assert o.solved
        np.testing.assert_allclose(o.x_opt, s.x_opt, rtol=0, atol=X_TOL)
        assert _pieces(o) == _pieces(s)
    # under the broker the scenario threads share METRICS (no reset per
    # solve): its counts are the serial counts summed
    for i, k in enumerate(keys):
        assert METRICS.counters[k] == sum(c[i] for _, c in serial)


def test_error_isolation():
    """One failing scenario must not poison the others."""
    broker = LockstepBroker()

    def good():
        return qt.solve(qt.setup("simple_bilevel"),
                        np.array([0.0, 1.0, 0.0, 0.0]))

    def bad():
        raise ValueError("scenario exploded")

    with pytest.raises(ValueError, match="scenario exploded"):
        broker.run([good, bad])


def test_dispatch_failure_wakes_workers(monkeypatch):
    """A failed fused dispatch propagates to the parked workers (raising in
    submit) instead of stranding them in event.wait."""
    def boom(*a, **k):
        raise RuntimeError("fused dispatch failure (simulated)")

    monkeypatch.setattr(batch_qp, "solve_qp_batch_padded", boom)
    broker = LockstepBroker()

    def job():
        return broker.submit(
            "qp", np.zeros((1, 2, 2)), np.zeros((1, 2)),
            np.zeros((1, 1, 2)), np.zeros((1, 1)), np.ones((1, 1)),
            np.ones((1, 1), bool))

    with pytest.raises(RuntimeError, match="simulated"):
        broker.run([job, job])


def test_lp_and_qp_requests_do_not_fuse(monkeypatch):
    """A pure-LP request (P == 0) must not share a fused dispatch with a
    QP of identical shapes: the exact-LP route gates on the whole
    concatenated batch being LP."""
    calls = []
    orig = batch_qp.solve_qp_batch_padded

    def spy(P, *a, **k):
        calls.append(int(np.asarray(P).any(axis=(1, 2)).sum()))
        return orig(P, *a, **k)

    monkeypatch.setattr(batch_qp, "solve_qp_batch_padded", spy)
    broker = LockstepBroker()
    q = np.array([[1.0, 1.0]])
    A = np.ones((1, 1, 2))
    l, u = np.array([[0.0]]), np.array([[1.0]])
    rm = np.ones((1, 1), bool)

    def job(P):
        return lambda: broker.submit("qp", P, q, A, l, u, rm)

    out = broker.run([job(np.eye(2)[None]), job(np.zeros((1, 2, 2)))])
    assert all(o is not None for o in out)
    assert broker.waves == 1
    assert sorted(calls[:2]) == [0, 1]        # two groups, one QP lane each


def test_fused_qp_requests_match_direct_calls():
    """Same-shape QP requests of three workers fuse into one call; each
    worker gets its direct call's numbers."""
    rng = np.random.default_rng(2)

    def problem():
        R = rng.standard_normal((2, 4, 4))
        P = np.einsum("bij,bkj->bik", R, R) / 4
        A = rng.standard_normal((2, 5, 4))
        return (P, rng.standard_normal((2, 4)), A, -np.ones((2, 5)),
                np.ones((2, 5)), np.ones((2, 5), bool))

    probs = [problem() for _ in range(3)]
    direct = [batch_qp.solve_qp_batch_padded(*p) for p in probs]
    before = METRICS.counters.get("admm_calls", 0.0)
    broker = LockstepBroker()
    outs = broker.run([(lambda p=p: batch_qp.solve_qp_batch_padded(*p))
                       for p in probs])
    assert broker.waves == 1
    assert METRICS.counters["admm_calls"] - before == 1
    for o, d in zip(outs, direct):
        assert isinstance(o, batch_qp.QPSolution)
        np.testing.assert_array_equal(o.status, d.status)
        np.testing.assert_allclose(o.x, d.x, rtol=0, atol=X_TOL)


def test_fused_avi_requests_stay_tensors():
    """AVI requests fuse too; each worker gets tensors on the device of its
    inputs, with its direct call's numbers."""
    rng = np.random.default_rng(4)

    def problem(B=2, n=5):
        R = rng.standard_normal((B, n, n))
        M = torch.as_tensor(np.einsum("bij,bkj->bik", R, R) / n
                            + np.eye(n))
        t = lambda a: torch.as_tensor(a)            # noqa: E731
        return (M, t(rng.standard_normal((B, n))), t(-np.ones((B, n))),
                t(np.ones((B, n))), t(np.zeros((B, n))),
                torch.ones(B, n, dtype=torch.bool))

    probs = [problem() for _ in range(2)]
    direct = [avi.solve_avi_batch_padded(*p, tol=1e-10) for p in probs]
    broker = LockstepBroker()
    outs = broker.run([(lambda p=p: avi.solve_avi_batch_padded(*p, tol=1e-10))
                       for p in probs])
    assert broker.waves == 1
    for o, d in zip(outs, direct):
        assert isinstance(o.z, torch.Tensor) and o.z.shape == (2, 5)
        assert bool(o.converged.all())
        np.testing.assert_allclose(o.z.numpy(), d.z.numpy(), rtol=0,
                                   atol=X_TOL)


def _lp_jobs(seed=3, workers=3):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(workers):
        c = rng.standard_normal((2, 3))
        A = rng.standard_normal((2, 4, 3))
        l = -np.ones((2, 4)) - rng.random((2, 4))
        u = np.ones((2, 4)) + rng.random((2, 4))
        jobs.append((c, A, l, u, np.ones((2, 4), bool)))
    return jobs


def test_host_lp_requests_fuse_and_match_direct():
    """Host-engine geometry LPs park at the broker and fuse into one native
    batch (broker_lp_host_waves / _fused), each worker getting its direct
    call's solution, and the JAX package's."""
    assert library_path().exists()
    assert ref_native.native_available()
    jobs = _lp_jobs()
    direct = [solve_lp_host_batch(*a) for a in jobs]
    waves0 = METRICS.counters.get("broker_lp_host_waves", 0)
    fused0 = METRICS.counters.get("broker_lp_host_fused", 0)
    broker = LockstepBroker()
    outs = broker.run([(lambda a=a: solve_lp_host_batch(*a)) for a in jobs])
    assert METRICS.counters["broker_lp_host_waves"] == waves0 + 1
    assert METRICS.counters["broker_lp_host_fused"] == fused0 + 3
    for o, d, a in zip(outs, direct, jobs):
        want = ref_lemke.solve_lp_host_batch(*a, _no_broker=True)
        for got in (o, d):
            np.testing.assert_allclose(got.x, want.x, rtol=0, atol=X_TOL)
            np.testing.assert_allclose(got.obj, want.obj, rtol=0, atol=X_TOL)


def test_remove_subsets_parks_host_lps():
    """remove_subsets (the dedup entry inside solve()) runs its support and
    containment LPs through the host engine; under a broker those LPs park
    and fuse across workers, with the direct path's decisions."""
    from qpn_tpu_torch.geometry.poly import PolyUnion, random_polys_of_dim
    from qpn_tpu_torch.geometry.setops import remove_subsets
    assert library_path().exists() and CONFIG.support_engine == "host"

    def union(seed):
        return PolyUnion(random_polys_of_dim(np.random.default_rng(seed), 6,
                                             3))

    CACHE.clear()
    direct = [[p.m for p in remove_subsets(union(s)).polys] for s in (7, 8)]
    CACHE.clear()
    waves0 = METRICS.counters.get("broker_lp_host_waves", 0)
    broker = LockstepBroker()
    outs = broker.run([(lambda s=s: remove_subsets(union(s)))
                       for s in (7, 8)])
    assert METRICS.counters["broker_lp_host_waves"] > waves0
    for o, d in zip(outs, direct):
        assert [p.m for p in o.polys] == d


def test_waves_are_in_canonical_order():
    """A wave's requests are ordered by (worker, sequence), whatever order
    the threads parked in."""
    broker = LockstepBroker()
    seen = []

    def dispatch(reqs):
        seen.append([r.order for r in sorted(reqs, key=lambda r: r.order)])

    broker._dispatch_wave = dispatch
    reqs = [_Request("qp", (), {}, order=o) for o in [(2, 0), (0, 1), (1, 0)]]
    broker._pending = list(reqs)
    broker._parked = broker._live = 0
    broker.run([])
    assert seen == [[(0, 1), (1, 0), (2, 0)]]


def test_active_broker_is_per_thread():
    broker = LockstepBroker()
    inside = broker.run([active_broker])
    assert inside == [broker]
    assert active_broker() is None


@pytest.mark.parametrize("call", ["broker", "solve"])
def test_mesh_names_the_distributed_slice(call):
    """``mesh`` is a mesh of the ``torch.distributed`` layer
    (``parallel/mesh.py``): the broker keeps it, and over a one-rank mesh
    the split dispatch gives the serial result (the multi-rank cases are in
    ``test_torch_multihost.py``)."""
    from qpn_tpu_torch.parallel import mesh
    one = mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                    device=torch.device("cpu"), backend="gloo")
    if call == "broker":
        assert LockstepBroker(mesh=one).mesh is one
        return
    x0 = np.array([0.3, 1.0, 0.0, 0.0])
    (got,), broker = solve_many_lockstep([qt.setup("simple_bilevel")], [x0],
                                         mesh=one)
    want = qt.solve(qt.setup("simple_bilevel"), x0)
    assert got.solved and broker.mesh is one and broker.waves >= 1
    np.testing.assert_allclose(got.x_opt, want.x_opt, rtol=0, atol=X_TOL)


def test_many_workers_under_a_short_switch_interval():
    """Stress: more workers than cores, each submitting several requests,
    with the interpreter switching threads often.  Every worker gets its
    own rows back (a lost update or a mixed-up slice would break it) and
    the run ends within its time limit."""
    rng = np.random.default_rng(9)
    n_workers, per_worker = 12, 3
    data = rng.standard_normal((n_workers, per_worker, 1, 3))

    def job(i):
        def run():
            out = []
            for j in range(per_worker):
                P = np.eye(3)[None]
                sol = batch_qp.solve_qp_batch_padded(
                    P, -data[i, j], np.eye(3)[None], -10 * np.ones((1, 3)),
                    10 * np.ones((1, 3)), np.ones((1, 3), bool))
                out.append(sol.x[0])
            return np.stack(out)
        return run

    broker = LockstepBroker()
    result = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: result.update(
            out=broker.run([job(i) for i in range(n_workers)])), daemon=True)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    for i, x in enumerate(result["out"]):
        # min ½|x|² − d'x in a wide box: x = d
        np.testing.assert_allclose(x, data[i, :, 0], rtol=0, atol=1e-8)
    assert broker.waves == per_worker


def test_metrics_are_not_reset_under_a_broker():
    """solve() restarts METRICS except under a broker, where the scenario
    threads share the registry."""
    METRICS.bump("sentinel_counter")
    broker = LockstepBroker()
    broker.run([lambda: qt.solve(qt.setup("shepherd_sheep"))])
    assert METRICS.counters["sentinel_counter"] == 1.0
    qt.solve(qt.setup("shepherd_sheep"))
    assert "sentinel_counter" not in METRICS.counters
    assert lockstep.active_broker() is None
