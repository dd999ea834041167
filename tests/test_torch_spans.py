"""The port's spans, host-sync count and device-side counters
(``qpn_tpu_torch/utils/metrics.py``) on the two ensemble routes of
``ops/avi.py``, and the benchmark's readers of them
(``qpnbench/metrics/``).

This file imports neither JAX nor the JAX package, so its card test also
runs on a GPU machine without JAX, where the repository's conftest (which
imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import importlib.util
import json
import sys
import warnings
from pathlib import Path

import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import avi, eg, lemke
from qpn_tpu_torch.utils import metrics as metrics_mod
from qpn_tpu_torch.utils.metrics import METRICS, Metrics

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-8
EG_STEPS = 300

KKT_STAGES = ("pivot32", "refactor", "audit", "polish", "repivot", "admm",
              "shared")
GENERIC_STAGES = ("eg", "stage", "reseed", "escalate")


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _data(S, device, seed=0):
    b = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                             num_poly_faces=4, seed=seed)
    return avi.batch_from_numpy(b, device)


def _kkt(t, tol=TOL):
    return avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"], t["mask"],
                                   t["structure"], tol=tol)


def _generic(t, steps=EG_STEPS, **kw):
    return avi.solve_avi_batch_adaptive(t["M"], t["q"], t["l"], t["u"],
                                        t["z0"], t["mask"], tol=TOL,
                                        onchip_eg_steps=steps, **kw)


def _delta(fn):
    """fn()'s result and what it added to each counter."""
    before = dict(METRICS.counters)
    out = fn()
    after = dict(METRICS.counters)
    return out, {k: v - before.get(k, 0.0) for k, v in after.items()}


# --------------------------------------------------------------------------
#  spans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route,tol,stages", [
    ("kkt", TOL, KKT_STAGES), ("kkt", 1e-300, KKT_STAGES),
    ("generic", TOL, GENERIC_STAGES)])
def test_route_spans_nest_under_the_entry(cpu, route, tol, stages):
    """Each route on 8 lanes at n=38 records its entry span, and each stage
    span is at or under it, all of them together too.  At tol 1e-300 the
    KKT route runs every straggler branch."""
    t = _data(8, "cpu")
    run = (lambda: _kkt(t, tol)) if route == "kkt" else (lambda: _generic(t))
    _, d = _delta(run)
    parent = d[f"time/qpn.{route}"]
    assert parent > 0
    children = {s: d.get(f"time/qpn.{route}.{s}", 0.0) for s in stages}
    assert all(0 <= v <= parent for v in children.values())
    assert sum(children.values()) <= parent
    assert children["pivot32" if route == "kkt" else "stage"] > 0
    if tol < 1e-100:
        for s in ("polish", "repivot", "admm"):
            assert children[s] > 0
    # every sync of the call lies inside the entry span
    assert 0 <= d["time/qpn.sync"] <= parent


def test_timer_adds_to_the_counters_and_snapshot():
    m = Metrics()
    with m.timer("a.b"):
        pass
    with m.timer("a.b"):
        pass
    assert m.counters["time/a.b"] >= 0
    assert set(m.snapshot()) == {"time/a.b"}
    assert not hasattr(m, "timers")


# --------------------------------------------------------------------------
#  host syncs
# --------------------------------------------------------------------------

def test_sync_counts_and_times_one_read():
    m = Metrics()
    assert m.sync(bool, torch.tensor(True)) is True
    assert m.sync(int, torch.tensor(3)) == 3
    idx = m.sync(torch.nonzero, torch.tensor([False, True, True]))
    assert idx[:, 0].tolist() == [1, 2]
    assert m.counters["host_syncs"] == 3
    assert m.counters["time/qpn.sync"] >= 0


@pytest.mark.parametrize("route", ["kkt", "generic"])
def test_host_syncs_rise_by_the_helpers_calls(cpu, monkeypatch, route):
    calls = []
    real = METRICS.sync

    def counted(read, *args):
        calls.append(read)
        return real(read, *args)
    monkeypatch.setattr(METRICS, "sync", counted)
    t = _data(8, "cpu")
    _, d = _delta(lambda: _kkt(t) if route == "kkt" else _generic(t))
    assert d["host_syncs"] == len(calls) > 0
    if route == "kkt":
        # after the plain pivot loop's reads, the three audit decisions: no
        # straggler at this tolerance
        assert calls[-3:] == [bool, bool, bool]


@pytest.mark.parametrize("batch,counted", [((), 0), ((1,), 0), ((3,), 1),
                                           ((2, 2), 1)])
def test_batched_cholesky_solve_counts_a_sync(batch, counted):
    """More than one system (MAGMA on the card, which waits inside the
    call) is one counted sync; one system is none."""
    from qpn_tpu_torch.ops import linalg
    A = torch.rand(*batch, 4, 4, dtype=torch.float64)
    K = A @ A.mT + torch.eye(4, dtype=torch.float64)
    b = torch.rand(*batch, 4, dtype=torch.float64)
    before = METRICS.counters.get("host_syncs", 0.0)
    x = linalg.chol_solve(K, b)
    assert METRICS.counters.get("host_syncs", 0.0) - before == counted
    torch.testing.assert_close((K @ x[..., None])[..., 0], b)


def test_lanes_where_is_one_counted_nonzero():
    before = METRICS.counters.get("host_syncs", 0.0)
    idx = metrics_mod.lanes_where(torch.tensor([True, False, True]))
    assert idx.tolist() == [0, 2] and idx.dim() == 1
    assert METRICS.counters["host_syncs"] == before + 1


# --------------------------------------------------------------------------
#  device-side counters
# --------------------------------------------------------------------------

def test_tensor_bump_accumulates_without_a_host_read(monkeypatch):
    """A tensor bump is summed where it lies: nothing reaches the host
    counters until they are read, then the sum is folded in once."""
    m = Metrics()
    m.bump("lanes", 2.0)
    m.bump("lanes", torch.tensor([True, False, True]))
    m.bump("lanes", torch.tensor([True, True, True]))
    m.bump("lanes", torch.tensor([4, 5], dtype=torch.int32))
    assert m._counters["lanes"] == 2.0
    # one f64 sum of each shape, on the tensors' device
    assert sorted(tuple(a.shape) for a in m._pending.values()) == [(2,), (3,)]
    assert all(a.dtype == torch.float64 for a in m._pending.values())
    assert m.counters["lanes"] == 16.0
    assert not m._pending
    m.bump("lanes", torch.tensor(1.5, dtype=torch.float64))
    assert m.snapshot()["lanes"] == 17.5
    m.bump("other", torch.ones(3))
    m.reset()
    assert dict(m.counters) == {}


def test_tensor_bump_reads_nothing_on_the_host(monkeypatch):
    """The bump itself never converts a tensor to a Python number."""
    def refuse(self, *a):
        raise AssertionError("a host read in bump")
    m = Metrics()
    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    m.bump("x", torch.tensor([True, True]))
    m.bump("x", torch.tensor([True, False]))
    monkeypatch.undo()
    assert m.counters["x"] == 3.0


@pytest.mark.parametrize("tol", [TOL, 1e-300])
def test_kkt_counters_equal_their_host_values(cpu, tol):
    t = _data(8, "cpu")
    res, d = _delta(lambda: _kkt(t, tol))
    assert d["kkt_uncertified_lanes"] == int((~res.converged).sum())
    if tol == TOL:
        assert d["kkt_uncertified_lanes"] == 0
        # one f32 pivot solve: its lanes' pivots are the result's iters
        assert d["k1_pivots"] == int(res.iters.sum())
        assert d["k1_lanes"] == 8
    else:
        # the f32 solve and the f64 re-pivot of every lane
        assert d["kkt_uncertified_lanes"] == 8
        assert d["k1_lanes"] == 16


def test_k1_pivots_equal_the_engines_counts(cpu):
    t = _data(8, "cpu", seed=1)
    f32 = torch.float32
    out, d = _delta(lambda: lemke.solve_lemke_batch_state_auto(
        *(t[k].to(f32) for k in ("M", "q", "l", "u")),
        torch.zeros_like(t["q"], dtype=f32), t["mask"], tol=1e-6,
        piv_tol=1e-5, max_pivots=1024))
    piv = out[2]
    assert d["k1_pivots"] == int(piv.sum()) > 0
    assert d["k1_lanes"] == 8


def test_eg_accepted_lanes_equal_their_host_value(cpu):
    t = _data(8, "cpu")
    M, q, l, u, z0, vm = (t[k] for k in ("M", "q", "l", "u", "z0", "mask"))
    z_eg = eg.eg_warmstart(M, q, l, u, z0, vm, steps=EG_STEPS)
    r_eg = avi.natural_residual(M, q, l, u, z_eg, vm)
    r_0 = avi.natural_residual(M, q, l, u, z0, vm)
    want = int((torch.isfinite(r_eg) & (r_eg < r_0)).sum())
    _, d = _delta(lambda: _generic(t))
    assert d["eg_accepted_lanes"] == want > 0


# --------------------------------------------------------------------------
#  the benchmark's readers
# --------------------------------------------------------------------------

def _reader(name):
    path = ROOT / "qpnbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "qpnbench_metrics_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(counters, calls):
    from qpnbench.harness import Record
    return Record(cell={}, config={}, mix={"lanes": 256}, n=38, setup_s=0.0,
                  latencies=[0.005] * calls, window_s=1.0,
                  attempted=256 * calls, certified=256 * calls,
                  counters=counters, trace=None)


COUNTERS = {"host_syncs": 300.0, "time/qpn.kkt": 0.6, "time/qpn.generic": 7.0,
            "time/qpn.sync": 0.1, "k1_pivots": 256 * 100 * 68.5,
            "k1_lanes": 256 * 100.0}


@pytest.mark.parametrize("name,want", [
    ("host_syncs_per_call.kkt", 3.0),
    ("host_dispatch_ms.kkt", 5.0),
    ("host_syncs_per_call.generic", 3.0),
    ("host_dispatch_ms.generic", 69.0),
    ("k1_pivots_per_lane.kkt", 68.5)])
def test_reader_reads_the_programs_counters(name, want):
    mod = _reader(name)
    assert mod.read(_record(dict(COUNTERS), 100)) == pytest.approx(want)
    # a program without the spans and counters (the parent's): nothing read
    assert mod.read(_record({"kkt_polish_lanes": 0.0}, 100)) is None
    if not name.startswith("k1_"):
        assert mod.read(_record(dict(COUNTERS), 0)) is None


def test_readers_load_no_jax():
    import subprocess
    code = ("import sys, importlib.util\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "for n in sys.argv[2:]:\n"
            "    p = sys.argv[1] + '/qpnbench/metrics/' + n + '.py'\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'qpn_tpu')]\n"
            "assert not bad, bad\n")
    names = ["host_syncs_per_call.kkt", "host_dispatch_ms.kkt",
             "host_syncs_per_call.generic", "host_dispatch_ms.generic",
             "k1_pivots_per_lane.kkt"]
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), *names],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


# --------------------------------------------------------------------------
#  on the card: every blocking read goes through the helper
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sync debug mode is CUDA's)")
    return torch.device("cuda", 0)


# library calls that wait on the card inside themselves, where PyTorch's sync
# debug mode does not see it: the program counts each through METRICS.sync
LIBRARY_SYNCS = (torch.linalg.solve_ex, torch.linalg.lu_factor_ex,
                 torch.cholesky_solve)


def sync_warnings(fn, monkeypatch):
    """fn()'s sync warnings under ``torch.cuda.set_sync_debug_mode("warn")``,
    what it added to ``host_syncs``, and the reads it made through
    ``METRICS.sync``.  Counters are read outside the recorded block: reading
    them folds the device-side sums, a read of its own."""
    reads = []
    real = METRICS.sync

    def counted(read, *args):
        reads.append(read)
        return real(read, *args)
    monkeypatch.setattr(METRICS, "sync", counted)
    before = METRICS.counters.get("host_syncs", 0.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    found = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return found, METRICS.counters["host_syncs"] - before, reads


@pytest.mark.gpu
@pytest.mark.parametrize("route,tol", [("kkt", TOL), ("kkt", 1e-300),
                                       ("generic", TOL)])
def test_every_sync_goes_through_the_helper(cuda_device, monkeypatch, route,
                                            tol):
    """One call of each route at n=38 on 16 lanes raises as many sync
    warnings as ``host_syncs`` rose, less the library calls that the
    program counts because they wait inside themselves (the cell's 20000 EG
    steps in the generic route; tol 1e-300 runs the KKT route's straggler
    branches)."""
    t = _data(16, cuda_device)
    if route == "kkt":
        def run():
            return _kkt(t, tol)
    else:
        def run():
            return _generic(t, steps=20000)
    run()                       # kernels built and loaded, shapes warm
    torch.cuda.synchronize()
    found, syncs, reads = sync_warnings(run, monkeypatch)
    library = sum(r in LIBRARY_SYNCS for r in reads)
    assert syncs == len(reads) > 0
    assert len(found) == syncs - library, [
        f"{w.filename}:{w.lineno}" for w in found[:8]]


@pytest.mark.gpu
@pytest.mark.parametrize("route,op", [
    ("kkt", "aten::linalg_lu_factor_ex"),
    ("generic", "aten::_cholesky_solve_helper")])
def test_counted_library_call_waits_on_the_card(cuda_device, tmp_path, route,
                                                op):
    """The library calls that the program counts as host syncs hold
    blocking CUDA runtime calls at the cells' 256 lanes, which the sync
    debug mode does not report: the batched LU of ``lemke.refactor_batch``,
    and ``linalg.cholesky_solve`` on more than one system."""
    from torch.profiler import ProfilerActivity, profile
    t = _data(256, cuda_device)
    run = (lambda: _kkt(t)) if route == "kkt" else \
        (lambda: _generic(t, steps=20000))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    calls = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in xs if e.get("cat") == "cpu_op" and e["name"] == op
             and e["args"]["Input Dims"][0][0] > 1]
    waits = [float(e["ts"]) for e in xs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e["name"] in ("cudaStreamSynchronize",
                               "cudaDeviceSynchronize")]
    assert calls
    assert all(any(s <= w <= e for w in waits) for s, e in calls)
