"""The shared-matrix route (``qpn_tpu_torch/ops/shared_kkt.py``) as the
benchmark's cell ``ra_T8o4.shared_s1024`` drives it, on the CPU: answers
through the KKT entry judged on the benchmark's plain statement of the model
(``qpnbench/reference/robust_avoid.py``), the program's assembly of the
cell's configuration against that statement, the route's spans, counted
reads and counters, and the benchmark's readers of them
(``qpnbench/metrics/shared_*.py``).

This file imports neither JAX nor the JAX package.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import avi
from qpn_tpu_torch.ops import shared_kkt as sk
from qpn_tpu_torch.utils.metrics import METRICS
from qpnbench.models import robust_avoid as model
from qpnbench.reference import check
from qpnbench.reference import robust_avoid as ref

from _torch_reads import uncounted_reads

# batched LUs: intra-op threads make them no faster and contend with the
# other test workers (and MKL's batched LU needs one, shared_kkt.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-8
SPANS = ("eg", "round0", "ladder", "rungs", "audit")
# each ``phase_t`` entry of the route and the span that times its block
PHASES = {"eg": "eg.steps", "eg_fetch": "eg.fetch",
          "round0_compute": "round0.compute", "round0_fetch": "round0.fetch",
          "newton_rounds": "ladder", "chip_admm_rung": "rungs.chip_admm",
          "admm_rung": "rungs.admm_route", "host_lstsq": "rungs.lstsq",
          "prox_eg_rung": "rungs.prox_eg", "escalations": "rungs.generic",
          "final_audit": "audit"}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _config(T, K):
    return dict(T=T, num_obj=K, num_poly_faces=4, model_seed=0)


def _delta(fn):
    """fn()'s result and what it added to each counter."""
    before = dict(METRICS.counters)
    out = fn()
    after = dict(METRICS.counters)
    return out, {k: v - before.get(k, 0.0) for k, v in after.items()}


# --------------------------------------------------------------------------
#  (a) answers through the entry, on the reference's statement
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_entry_answers_meet_the_reference(monkeypatch, seed):
    """At T=2, num_obj=1 and 24 scenarios drawn as the benchmark draws them,
    the KKT entry takes the shared route (its threshold set below n) and
    every answer's natural residual on the reference's own statement is at
    most 1e-8."""
    config = _config(2, 1)
    sys_ = model.assemble(config)
    n, S = sys_.M.shape[0], 24
    monkeypatch.setattr(CONFIG, "shared_kkt_min_n", n)
    g = np.random.default_rng(seed)
    shift = g.standard_normal((S, sys_.shifted))
    jitter = 0.05 * g.standard_normal((S, n))
    q, l, u = model.lanes(sys_, shift, jitter)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  dtype=torch.float64)
    res, d = _delta(lambda: avi.solve_kkt_avi_batch(
        t(sys_.M).expand(S, n, n).contiguous(), t(q), t(l), t(u),
        torch.ones(S, n, dtype=torch.bool), sys_.structure, tol=TOL))
    assert d["kkt_shared_route"] == S
    assert bool(res.converged.all())
    prob = ref.problem(config)
    rq, rl, ru = ref.lanes(prob, shift, jitter)
    assert check.residuals(prob.M, rq, rl, ru, res.z.numpy()).max() <= TOL


# --------------------------------------------------------------------------
#  (b) the cell's configuration: the program's assembly is the statement
# --------------------------------------------------------------------------

def test_trajectory_assembly_equals_the_reference():
    """At T=8, num_obj=4 the program's assembly equals the reference's M
    exactly, and its q at the default start and its l, u to 1e-12; the KKT
    AVI is n=608 with nd=96 and m=256."""
    config = _config(8, 4)
    sys_ = model.assemble(config)
    prob = ref.problem(config)
    assert sys_.M.shape == prob.M.shape == (608, 608)
    assert (sys_.structure["nd"], sys_.structure["m"]) == (96, 256)
    assert (prob.nd, prob.m) == (96, 256)
    assert sys_.structure["shared_M"]
    assert np.array_equal(sys_.M, prob.M)
    np.testing.assert_allclose(sys_.N @ sys_.w0 + sys_.o, prob.q0, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sys_.l, prob.l, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sys_.u, prob.u, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
#  (c) spans, counted reads and counters
# --------------------------------------------------------------------------

def _batch(seed):
    return avi.batch_from_numpy(scenario_batch_gavis(
        num_scenarios=24, T=2, num_obj=1, num_poly_faces=4, seed=seed), "cpu")


def _events(prof, name):
    return [e for e in prof.events() if e.name == name]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("seed,straggler", [(0, False), (2, True)],
                         ids=["easy", "straggler"])
def test_spans_reads_and_counters(monkeypatch, seed, straggler):
    """Through the KKT entry at T=2 on 24 lanes (seed 2 is the hard seed:
    round 0 leaves lanes to the ADMM rung and its host polish): each span
    is recorded once a call inside ``qpn.kkt.shared`` (``admm`` and
    ``polish`` once an ADMM pass, inside ``rungs``), the counters equal the
    route's ``stats``, every ``phase_t`` entry is its block's span,
    ``host_syncs`` rose by the helper's calls, no tensor is read into the
    host outside the helper, and z, ``converged`` and ``iters`` are
    bit-equal with and without a profiler running."""
    t = _batch(seed)
    monkeypatch.setattr(CONFIG, "shared_kkt_min_n", t["M"].shape[1])
    stats = {}
    real = sk.solve_kkt_avi_shared

    def with_stats(*a, **kw):
        stats.clear()
        return real(*a, stats=stats, **kw)
    monkeypatch.setattr(sk, "solve_kkt_avi_shared", with_stats)
    stray = uncounted_reads(monkeypatch)
    reads = []
    real_sync = METRICS.sync

    def counted(read, *args):
        reads.append(read)
        return real_sync(read, *args)
    monkeypatch.setattr(METRICS, "sync", counted)

    def run():
        return avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"],
                                       t["mask"], t["structure"], tol=TOL)

    def watched():
        del stray[:]
        return run(), list(stray)
    (res, uncounted), d = _delta(watched)
    assert uncounted == []
    assert bool(res.converged.all())
    assert d["host_syncs"] == len(reads) > 0
    assert d["shared_eg_steps"] == stats["eg_iters"] > 0
    # two products a step and one a 2000-step chunk
    assert d["shared_eg_gemms"] == 2 * stats["eg_iters"] + \
        stats["eg_iters"] // 2000
    assert d["shared_host_solves"] == stats["host_solves"]
    for s in SPANS:
        assert 0 < d[f"time/qpn.shared.{s}"] <= d["time/qpn.kkt.shared"]
    assert sum(d[f"time/qpn.shared.{s}"] for s in SPANS) <= \
        d["time/qpn.kkt.shared"]
    phase = stats["phase_t"]
    assert set(phase) == set(PHASES)
    for key, span in PHASES.items():
        assert phase[key] == pytest.approx(d[f"time/qpn.shared.{span}"],
                                           abs=5e-4)
    left = d["shared_round0_left"]
    if straggler:
        assert left >= d["shared_kkt_chip_admm_rung"] > 0
        assert d["shared_polish_lanes"] >= d["shared_kkt_chip_admm_rung"]
        assert d["time/qpn.shared.polish"] > 0
        assert d["time/qpn.shared.admm"] + d["time/qpn.shared.polish"] <= \
            d["time/qpn.shared.rungs"]
        for key in ("admm", "polish"):
            assert stats["chip_admm_t"][key] == pytest.approx(
                d[f"time/qpn.shared.{key}"], abs=5e-4)
    else:
        # the entry's two decisions, the four inputs to the host, a read a
        # pre-pass chunk, the fetch of Z, round 0's LU and its three reads
        chunks = stats["eg_iters"] // 2000
        assert d["host_syncs"] == 2 + 4 + chunks + 1 + 1 + 3
        assert left == 0
        assert d.get("shared_polish_lanes", 0.0) == 0
        assert "time/qpn.shared.polish" not in d

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        again = run()
    assert torch.equal(again.z, res.z)
    assert torch.equal(again.converged, res.converged)
    assert torch.equal(again.iters, res.iters)
    (outer,) = _events(prof, "qpn.kkt.shared")
    for s in SPANS:
        (span,) = _events(prof, f"qpn.shared.{s}")
        assert _inside(span, outer)
    for key, span in PHASES.items():
        for e in _events(prof, f"qpn.shared.{span}"):
            assert _inside(e, outer)
    (rungs,) = _events(prof, "qpn.shared.rungs")
    admm = _events(prof, "qpn.shared.admm")
    polish = _events(prof, "qpn.shared.polish")
    assert len(admm) == len(polish)
    assert bool(admm) == straggler
    assert all(_inside(e, rungs) for e in admm + polish)


def test_ladder_host_solves_are_counted(monkeypatch):
    """Without the structure the round-0-singular lanes of the hard seed
    take the δ ladder, whose straggler tail runs on host LAPACK, and the
    generic escalation: the count of host solves is the route's
    ``stats["host_solves"]``, the pre-pass steps its ``stats["eg_iters"]``,
    and no tensor is read into the host outside ``METRICS.sync``."""
    t = _batch(2)
    stats = {}
    stray = uncounted_reads(monkeypatch)

    def watched():
        del stray[:]
        out = sk.solve_kkt_avi_shared(t["M"][0], t["q"], t["l"], t["u"],
                                      None, tol=TOL, stats=stats)
        return out, list(stray)
    (res, uncounted), d = _delta(watched)
    assert uncounted == []
    assert d["shared_kkt_generic_escalation"] > 0
    assert bool(res.converged.all())
    assert d["shared_host_solves"] == stats["host_solves"] > 0
    assert d["shared_eg_steps"] == stats["eg_iters"]
    assert d["shared_round0_left"] > 0


# --------------------------------------------------------------------------
#  (d) the benchmark's readers
# --------------------------------------------------------------------------

def _reader(name):
    path = ROOT / "qpnbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "qpnbench_metrics_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize{}_stage3_warpsize"
        "1x4x1_ffma_aligna4_alignc4_execute_{}kernel__5x_cublas")


def _trace():
    """A traced window of 2 calls: the pre-pass's products, four of them,
    each a split-K kernel and its main kernel (1 s in all and 3 s), and what
    is not theirs: float32 GEMMs of other shapes launched fewer times, a
    float64 GEMM, MAGMA's batched kernels, a matrix-vector product."""
    from qpnbench.trace import Trace
    main = GEMM.format("64x128x8", "")
    split = GEMM.format("64x128x8", "split_k_")
    ops = [op for k in range(4) for op in ((split, 2.0 * k, 0.25),
                                           (main, 2.0 * k + 0.5, 0.75))]
    ops += [(GEMM.format("32x64x8", ""), 8.0, 0.5),
            (GEMM.format("32x64x8", ""), 8.5, 0.5),
            (GEMM.format("128x32x8", ""), 9.0, 0.5),
            ("sm80_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16_"
             "execute_kernel__5x_cublas", 10.0, 2.0),
            ("magmablas_sgemm_batched_kernel", 12.0, 2.0),
            ("dtrsv_notrans_kernel_outplace_batched", 14.0, 1.0),
            ("internal::gemvx::kernel", 15.0, 1.0)]
    return Trace(window_s=20.0, busy_s=12.0, calls=2, ops=ops, idle_gaps=[],
                 device_ops=[])


def _record(counters, calls, trace=None):
    from qpnbench.harness import Record
    return Record(cell={}, config={}, mix={"lanes": 1024}, n=608,
                  setup_s=0.0, latencies=[2.5] * calls, window_s=50.0,
                  attempted=1024 * calls, certified=1024 * calls,
                  counters=counters, trace=trace)


COUNTERS = {"time/qpn.shared.eg": 30.0, "shared_eg_steps": 120000.0,
            "shared_eg_gemms": 240060.0,
            "time/qpn.shared.rungs": 5.0, "shared_round0_left": 160.0,
            "time/qpn.kkt": 26.0, "host_syncs": 700.0}
# 24006 products a call, 2·1024·608² operations each, at 67 TFLOP/s, over
# the float32 GEMMs' 4 s of device time in 2 traced calls
EG_LEAST_S = 24006 * 2 * 1024 * 608 ** 2 / 67e12


@pytest.mark.parametrize("name,want", [
    ("shared_eg_ms.shared", 3000.0),
    ("shared_eg_roofline_pct.shared", EG_LEAST_S / 2.0 * 100.0),
    ("shared_rungs_ms.shared", 500.0),
    ("shared_straggler_pct.shared", 160.0 / 10240.0 * 100.0)])
def test_shared_readers(name, want):
    mod = _reader(name)
    trace = _trace()
    assert mod.read(_record(dict(COUNTERS), 10, trace)) == \
        pytest.approx(want)
    # a program without the route's spans and counters: nothing read
    assert mod.read(_record({"time/qpn.kkt": 26.0}, 10, trace)) is None
    assert mod.read(_record(dict(COUNTERS), 0, trace)) is None


def test_shared_roofline_reads_the_trace():
    """The pre-pass's share reads nothing without a trace, or where the
    trace holds none of the pre-pass's products."""
    mod = _reader("shared_eg_roofline_pct.shared")
    assert mod.read(_record(dict(COUNTERS), 10)) is None
    bare = _trace()
    bare.ops = [op for op in bare.ops if "f32f32" not in op[0]]
    assert mod.read(_record(dict(COUNTERS), 10, bare)) is None


def test_shared_prepass_kernels_are_the_most_launched_f32_gemms():
    """Of the float32 GEMM kernels in a trace, those launched most often are
    the pre-pass's products: each of their kernels, with its launches and
    seconds."""
    from qpnbench import work_shared
    picked = work_shared.eg_gemm_kernels(_trace())
    assert picked == {GEMM.format("64x128x8", ""): (4, 3.0),
                      GEMM.format("64x128x8", "split_k_"): (4, 1.0)}
    assert work_shared.eg_gemm_seconds(_trace()) == 4.0
