"""The hybrid solver's extragradient hop in one launch
(``qpn_tpu_torch/csrc/hybrid_hop.cu``, ``ops/hop_cuda.py``): its lane code
built with g++ (``hybrid_hop_host``, the card's bits) against the plain loop
it replaces on the card, ``ops/avi._eg_phase``, in f32 and f64; the engine
choice of ``solve_avi_batch``, its lane counters, and the benchmark's reader
of them (``qpnbench/metrics/hop_fused_pct.generic.py``).

The kernel and the plain loop run the same arithmetic on the same values;
they differ only in the order of each sum (a row of M z, and Φ·Φ of the
merit: the kernel's fixed partition, PyTorch's bmm and reduction), a few
ulps a sum; the kernel's F(z⁺) for the merit is the next step's first F,
which the plain loop computes again in its own order.  The hop contracts,
so after 60 steps z stays within a few ulps of the lane's scale (1 + max
|z0|): measured 1.2e-7 (f32) and 2.9e-16 (f64) of it, bounded at 1e-5 and
1e-12.  ‖Φ‖ of the best merit, and of each best z, is bounded alike:
measured 1.0e-6 and 1.8e-15 of the scale.  The best z is held to its
merit, not to the plain loop's z: a lane that moves along a flat valley
of ‖Φ‖ keeps merits equal to rounding, and the two orders of sums pick
different iterates among them (0.03 apart on the cell's lanes).

This file imports neither JAX nor the JAX package.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

import chip_smoke
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import avi, hop_cuda
from qpn_tpu_torch.ops.eg import ruiz
from qpn_tpu_torch.utils.cuda_build import HOPPER_SMEM_OPTIN
from qpn_tpu_torch.utils.metrics import METRICS

ROOT = Path(__file__).resolve().parents[1]
CELL = "ra_T2o1.generic_s256"
# kernel (host build) against the plain loop, relative to the lane's
# scale: z, and ‖Φ‖ of the merits (the module's notes)
Z_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
PHI_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
STEPS = [0, 1, 60]
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _scaled(M, q, l, u, z, mask):
    """The hop's inputs as solve_avi_batch forms them: pinned rows for the
    masked variables, Ruiz scaling, τ = 0.9 / (1 + ‖M‖∞)."""
    M, q, l, u = avi._masked(M, q, l, u, mask)
    d, e = ruiz(M)
    Mm = d[:, :, None] * M * e[:, None, :]
    ls = torch.where(torch.isfinite(l), l / e, l)
    us = torch.where(torch.isfinite(u), u / e, u)
    tau = 0.9 / (1.0 + Mm.abs().sum(2).amax(1))
    zs = torch.clamp(torch.where(mask, z / e, 0.0), ls, us)
    return Mm, d * q, ls, us, tau, zs


def _random(n, dtype, B=4, seed=0, pinned=0):
    """Monotone lanes with a mix of bounds: lower 0 or −inf, upper 1 or
    +inf; the last ``pinned`` variables of each lane masked off."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    A = torch.randn(B, n, n, generator=g, dtype=f64) / n ** 0.5
    S = torch.randn(B, n, n, generator=g, dtype=f64) / n ** 0.5
    M = A @ A.transpose(1, 2) + (S - S.transpose(1, 2)) + 0.1 * torch.eye(n)
    q = torch.randn(B, n, generator=g, dtype=f64)
    l = torch.where(torch.rand(B, n, generator=g) < 0.5, 0.0, -torch.inf)
    u = torch.where(torch.rand(B, n, generator=g) < 0.3, 1.0, torch.inf)
    z = torch.randn(B, n, generator=g, dtype=f64)
    mask = torch.ones(B, n, dtype=torch.bool)
    if pinned:
        mask[:, n - pinned:] = False
    out = _scaled(M, q, l.to(f64), u.to(f64), z, mask)
    return tuple(t.to(dtype).contiguous() for t in out)


@pytest.fixture(scope="module")
def pool_lanes():
    """8 lanes of the benchmark cell's first pool ensemble (n=38), as the
    route takes them (M shared by the lanes, q and l by scenario)."""
    M, q, l, u, _, _, _ = chip_smoke.cell_pool(CELL, torch.device("cpu"))
    return M[:8].contiguous(), q[0, :8], l[0, :8], u[:8]


@pytest.fixture(scope="module")
def pool_hops(pool_lanes):
    """The first hop's inputs of solve_avi_batch on the pool lanes in each
    precision, from zero starts: the scaled problem and the Newton
    polish's iterate."""
    M, q, l, u = pool_lanes
    B, n = q.shape
    args = (M, q, l, u, torch.zeros(B, n, dtype=torch.float64),
            torch.ones(B, n, dtype=torch.bool))
    return {dt: chip_smoke.first_hop(args, dt) for dt in DTYPES}


def _norm(m):
    """‖Φ‖₂ of a merit ½‖Φ‖²."""
    return (2.0 * m).sqrt()


def _close(got, want, dt, ins):
    """The host kernel's (last z, best z, best merit) against the plain
    loop's, NaN where the plain loop has NaN: z within Z_RTOL of the lane's
    scale; the best merit, and the plain merit of each best z, as ‖Φ‖
    within PHI_RTOL of the scale.  The best z is compared by its merit:
    where a lane's iterates keep merits equal to rounding (a lane that
    moves along a flat valley of ‖Φ‖), the two orders of sums pick
    different ones of them."""
    M, q, l, u, _, z0 = ins
    scale = 1.0 + z0.abs().amax(1).nan_to_num(0.0)
    a, b = got[0], want[0]
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ((a - b).abs() <= Z_RTOL[dt] * scale[:, None]) | torch.isnan(b)
    assert bool(ok.all()), float(((a - b).abs()
                                  / scale[:, None]).nan_to_num(0).max())
    pairs = [(got[2], want[2])]
    pairs.append(tuple(avi._merit(M, q, l, u, z)[0]
                       for z in (got[1], want[1])))
    for m, w in pairs:
        assert torch.equal(torch.isnan(m), torch.isnan(w))
        err = (_norm(m) - _norm(w)).abs()
        ok = (err <= PHI_RTOL[dt] * scale) | torch.isnan(w)
        assert bool(ok.all()), float((err / scale).nan_to_num(0).max())


def _against_plain(ins, steps):
    M, q, l, u, tau, z = ins
    dt = z.dtype
    want = avi._eg_phase(M, q, l, u, tau, z, steps)
    got = hop_cuda.hybrid_hop_host(M, q, l, u, tau, z, steps)
    assert all(g.dtype == dt for g in got)
    _close(got, want, dt, ins)
    return got, want


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_pool_lanes_match_the_plain_hop(pool_hops, dt, steps):
    """n=38, the cell's lanes: the register instance."""
    ins = pool_hops[dt]
    assert hop_cuda.host_instance(38, dt) == hop_cuda.HOP_REGISTER
    got, want = _against_plain(ins, steps)
    if steps == 0:
        assert torch.equal(got[0], ins[5]) and torch.equal(got[1], ins[5])


# (n, instance in f32, in f64): f64's register instance ends at 40, f32's
# at 64; 190 is the benchmark's mid-size n; 240 is past the shared instance
# in both precisions (M read in place)
SIZES = [(5, hop_cuda.HOP_REGISTER, hop_cuda.HOP_REGISTER),
         (40, hop_cuda.HOP_REGISTER, hop_cuda.HOP_REGISTER),
         (64, hop_cuda.HOP_REGISTER, hop_cuda.HOP_SHARED),
         (65, hop_cuda.HOP_SHARED, hop_cuda.HOP_SHARED),
         (190, hop_cuda.HOP_SHARED, hop_cuda.HOP_GLOBAL),
         (240, hop_cuda.HOP_GLOBAL, hop_cuda.HOP_GLOBAL)]


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("n,i32,i64", SIZES, ids=[f"n{s[0]}" for s in SIZES])
def test_each_instance_matches_the_plain_hop(n, i32, i64, dt, steps):
    want = i32 if dt == torch.float32 else i64
    assert hop_cuda.host_instance(n, dt) == want
    _against_plain(_random(n, dt, B=3, seed=n), steps)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_infinite_bounds_and_pinned_rows(dt):
    """Lanes with ±inf bounds and masked variables (identity rows pinned at
    0 by l = u = 0): the pinned entries stay 0 in every output."""
    ins = _random(38, dt, B=4, seed=3, pinned=6)
    assert bool(torch.isinf(ins[2]).any()) and bool(torch.isinf(ins[3]).any())
    got, _ = _against_plain(ins, 60)
    for z in got[:2]:
        assert bool((z[:, -6:] == 0).all())


def _blowup(dt, n=4):
    """One lane whose merit falls for a few steps and then overflows: M =
    diag(1, ..., 1, k) with a step far past 1 / k on the last variable, whose
    tiny start grows every step until z is inf, then NaN (inf − inf)."""
    k = 200.0
    M = torch.diag(torch.tensor([1.0] * (n - 1) + [k], dtype=dt))[None]
    q = torch.zeros(1, n, dtype=dt)
    l = torch.full((1, n), -torch.inf, dtype=dt)
    u = torch.full((1, n), torch.inf, dtype=dt)
    tiny = 1e-20 if dt == torch.float32 else 1e-200
    z = torch.tensor([[1.0] * (n - 1) + [tiny]], dtype=dt)
    tau = torch.tensor([0.05], dtype=dt)
    return M, q, l, u, tau, z


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_a_lane_that_turns_nan(dt):
    """Strict < and NaN-propagating minimum: the best z is the last iterate
    before the merit rose, and the best merit ends NaN once a merit is NaN,
    as in the plain loop."""
    ins = _blowup(dt)
    steps = 60 if dt == torch.float32 else 300
    got, want = _against_plain(ins, steps)
    assert bool(torch.isnan(want[0]).any()) and bool(torch.isnan(want[2]))
    assert bool(torch.isfinite(want[1]).all())
    assert not torch.equal(want[1], ins[5])
    # a lane that starts at NaN: best merit NaN, best z the start
    M, q, l, u, tau, z = ins
    z = z.clone()
    z[0, 0] = float("nan")
    got, _ = _against_plain((M, q, l, u, tau, z), 5)
    assert bool(torch.isnan(got[2])) and bool(torch.isnan(got[1][0, 0]))


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_host_build_matches_the_plain_hop_at_its_own_instances(dt):
    """The partition follows the limit the host build is given: at a limit
    of 0 n=100 takes the global instance's order, the shared one's at an
    H100's; both are plain column order, so the bits agree."""
    ins = _random(100, dt, B=2, seed=9)
    assert hop_cuda.host_instance(100, dt, 0) == hop_cuda.HOP_GLOBAL
    assert hop_cuda.host_instance(100, dt) == hop_cuda.HOP_SHARED
    a = hop_cuda.hybrid_hop_host(*ins, 60, optin=0)
    b = hop_cuda.hybrid_hop_host(*ins, 60, optin=HOPPER_SMEM_OPTIN)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    M, q, l, u, tau, z = _random(8, torch.float64, B=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hop_cuda.hybrid_hop_cuda(M, q, l, u, tau, z, 5)
    with pytest.raises(TypeError, match="tau is torch.float32"):
        hop_cuda.hybrid_hop_host(M, q, l, u, tau.float(), z, 5)
    with pytest.raises(ValueError, match="not contiguous"):
        hop_cuda.hybrid_hop_host(M.transpose(1, 2), q, l, u, tau, z, 5)
    with pytest.raises(ValueError, match="shape"):
        hop_cuda.hybrid_hop_host(M, q[:, :4], l, u, tau, z, 5)
    with pytest.raises(ValueError, match="steps"):
        hop_cuda.hybrid_hop_host(M, q, l, u, tau, z, -1)


@pytest.mark.parametrize("mode,device,want", [
    ("auto", "cpu", "plain"), ("auto", "cuda", "kernel"),
    ("torch", "cpu", "plain"), ("torch", "cuda", "plain"),
    ("cuda", "cpu", "kernel"), ("cuda", "cuda", "kernel")])
def test_engine_follows_the_setting_and_the_device(monkeypatch, mode, device,
                                                   want):
    monkeypatch.setattr(CONFIG, "eg_kernel", mode)
    got = avi._hop_engine(torch.device(device))
    assert got is (avi._eg_phase if want == "plain"
                   else hop_cuda.hybrid_hop_cuda)


def test_an_unknown_engine_setting_raises(monkeypatch):
    monkeypatch.setattr(CONFIG, "eg_kernel", "fast")
    with pytest.raises(ValueError, match="eg_kernel"):
        avi._hop_engine(torch.device("cpu"))


def _solve_counting(pool_lanes, dt):
    """solve_avi_batch on the pool lanes with the lanes of each hop
    recorded; returns (result, recorded lanes, counter deltas)."""
    M, q, l, u = pool_lanes
    B, n = q.shape
    before = dict(METRICS.counters)
    res = avi.solve_avi_batch(*(a.to(dt) for a in (M, q, l, u)),
                              torch.zeros(B, n, dtype=dt),
                              torch.ones(B, n, dtype=torch.bool),
                              tol=1e-10, max_iter=390)
    after = METRICS.counters
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in ("hop_lanes", "hop_fused_lanes")}
    return res, delta


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_plain_hops_count_their_lanes(monkeypatch, pool_lanes, dt):
    """On CPU tensors ("auto"): every hop's lanes in hop_lanes, none fused,
    and the result bit for bit the plain loop's (the engine is
    _eg_phase itself)."""
    lanes = []
    real = avi._eg_phase

    def record(M, *args):
        lanes.append(M.shape[0])
        return real(M, *args)
    monkeypatch.setattr(avi, "_eg_phase", record)
    res, delta = _solve_counting(pool_lanes, dt)
    assert lanes and delta == {"hop_lanes": float(sum(lanes)),
                               "hop_fused_lanes": 0.0}
    monkeypatch.setattr(avi, "_eg_phase", real)
    monkeypatch.setattr(CONFIG, "eg_kernel", "torch")
    again, _ = _solve_counting(pool_lanes, dt)
    assert torch.equal(res.z, again.z) and torch.equal(res.iters, again.iters)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_fused_hops_count_their_lanes(monkeypatch, pool_lanes, dt):
    """With the kernel's engine picked ("cuda"), here its host build on CPU
    tensors: every hop lane also counted in hop_fused_lanes, and the solve
    certifies the lanes the plain loop certifies."""
    lanes = []

    def host(M, *args):
        lanes.append(M.shape[0])
        return hop_cuda.hybrid_hop_host(M, *args)
    monkeypatch.setattr(hop_cuda, "hybrid_hop_cuda", host)
    monkeypatch.setattr(CONFIG, "eg_kernel", "cuda")
    res, delta = _solve_counting(pool_lanes, dt)
    assert lanes and delta == {"hop_lanes": float(sum(lanes)),
                               "hop_fused_lanes": float(sum(lanes))}
    monkeypatch.setattr(CONFIG, "eg_kernel", "torch")
    plain, _ = _solve_counting(pool_lanes, dt)
    assert torch.equal(res.converged, plain.converged)
    scale = 1.0 + float(plain.z.abs().max())
    assert float((res.z - plain.z).abs().max()) <= 1e-4 * scale


def _reader():
    path = ROOT / "qpnbench" / "metrics" / "hop_fused_pct.generic.py"
    spec = importlib.util.spec_from_file_location("hop_fused_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({"hop_lanes": 400.0, "hop_fused_lanes": 400.0}, 100.0),
    ({"hop_lanes": 400.0, "hop_fused_lanes": 100.0}, 25.0),
    ({"hop_lanes": 400.0}, 0.0),
    ({"hop_lanes": 0.0, "hop_fused_lanes": 0.0}, None),
    ({"host_syncs": 3.0}, None)])
def test_the_reader_of_fused_hop_lanes(counters, want):
    """hop_fused_pct.generic on hand-made records; nothing where the
    program counts no hop lanes (the parent's, or a window of no hop)."""
    from qpnbench.harness import Record
    rec = Record(cell={}, config={}, mix={"lanes": 256}, n=38, setup_s=0.0,
                 latencies=[0.07] * 10, window_s=1.0, attempted=2560,
                 certified=2560, counters=counters, trace=None)
    got = _reader().read(rec)
    assert got == (None if want is None else pytest.approx(want))
