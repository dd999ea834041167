"""The batched ADMM's inner block in one launch
(``qpn_tpu_torch/csrc/admm_block.cu``, ``ops/admm_cuda.py``): its lane code
built with g++ (``admm_block_host``, the kernel's bits) against the plain
loop it replaces on the card, ``batch_qp._iterate``; ``solve_qp_batch``
through it against the JAX package; the shapes it takes; the plain loop
kept for banded factors and CPU tensors; the block counters and the
benchmark's reader of them (``qpnbench/metrics/admm_fused_pct.shared.py``).

The kernel and the plain loop run the same arithmetic on the same values
and differ only in the order of each sum (Aᵀw, A x̃ and the triangular
solves: the kernel's fixed partition, PyTorch's bmm and LAPACK's solve),
a few ulps a sum.  After a block of 25 iterations x, z, y, dx and dy stay
within 1e-12 of the lane's scale (1 + the largest |x|, |z|, |y| of the
plain loop's lane): measured 1e-14 on the robust_avoid T=8 QPs, at most
5.4e-13 over every block of six seeds of the random QPs below, whose
equality rows (weight 1e3) and adapted ρ amplify the rounding of each
order.

The JAX package runs on the CPU here (the module's parity import).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_admm import capture_blocks, plain_block, shared_qps
from qpn_tpu.ops import batch_qp as ref_qp
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import admm_cuda, batch_qp
from qpn_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
# test_torch_batch_qp.py's bound on a solve against the JAX package
TOL = 1e-7
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture
def host_block(monkeypatch):
    """solve_qp_batch with the kernel's host build as its block."""
    monkeypatch.setattr(batch_qp, "_fused_block",
                        lambda *a: admm_cuda.admm_block_host)


def _random_qps(B=6, m=24, n=12, seed=0):
    """Feasible QPs (bounds around A x for a random x) with a masked padding
    row, a loose row (both bounds infinite), one-sided rows (one bound
    infinite) and an equality row."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    A = torch.randn(B, m, n, generator=g, dtype=f64) / n ** 0.5
    R = torch.randn(B, n, n, generator=g, dtype=f64)
    ax = (A @ torch.randn(B, n, 1, generator=g, dtype=f64))[..., 0]
    l = ax - torch.rand(B, m, generator=g, dtype=f64)
    u = ax + torch.rand(B, m, generator=g, dtype=f64)
    l[:, 0], u[:, 0] = -torch.inf, torch.inf
    l[:, 1] = -torch.inf
    u[:, 2] = torch.inf
    l[:, 3] = u[:, 3] = ax[:, 3]
    mask = torch.ones(B, m, dtype=torch.bool)
    mask[:, -1] = False
    A[:, -1] = 0.0
    return dict(P=R @ R.transpose(1, 2) / n + torch.eye(n, dtype=f64),
                q=torch.randn(B, n, generator=g, dtype=f64), A=A, l=l, u=u,
                row_mask=mask)


def lane_scale(state):
    """1 + the largest |x|, |z|, |y| of each lane (NaN taken as 0)."""
    return 1.0 + torch.stack([v.nan_to_num(0.0).abs().amax(1)
                              for v in state[:3]], 1).amax(1, keepdim=True)


def _close(got, want):
    """x, z, y, dx, dy within RTOL of the lane's scale, NaN where the plain
    loop has NaN."""
    scale = lane_scale(want)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        err = (g - w).nan_to_num(0.0).abs()
        assert bool((err <= RTOL * scale).all()), float((err / scale).max())


def _against_plain(block):
    tensors, sigma, alpha, iters = block
    kw = dict(sigma=sigma, alpha=alpha, iters=iters)
    assert iters == 25
    got = admm_cuda.admm_block_host(*(t.clone() for t in tensors), **kw)
    want = plain_block(*(t.clone() for t in tensors), **kw)
    _close(got, want)
    return got


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_host_block_matches_the_plain_loop_on_random_qps(which):
    """Dense factors (column-major, as cholesky_ex gives them), a loose
    row, one-sided and equality rows, ±1e20 in place of the infinite
    bounds: the kernel's arithmetic is the plain loop's to rounding."""
    _, seen = capture_blocks(_random_qps())
    tensors = seen[0][0]
    assert not tensors[1].is_contiguous()
    assert bool(tensors[6][:, 0].all())                  # loose
    assert float(tensors[5].max()) == 1e20               # +inf bounds
    assert float(tensors[4].min()) == -1e20
    block = {"first": seen[0], "middle": seen[len(seen) // 2],
             "last": seen[-1]}[which]
    _against_plain(block)


def test_host_block_takes_a_row_major_factor():
    """The same factor stored row-major gives the same bits."""
    _, seen = capture_blocks(_random_qps(seed=1))
    tensors, sigma, alpha, iters = seen[-1]
    kw = dict(sigma=sigma, alpha=alpha, iters=iters)
    a = admm_cuda.admm_block_host(*(t.clone() for t in tensors), **kw)
    ins = [t.clone() for t in tensors]
    ins[1] = ins[1].contiguous()
    b = admm_cuda.admm_block_host(*ins, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_host_block_keeps_a_nan_factor_to_its_lane():
    """A lane whose K(ρ) failed its Cholesky (a NaN factor, as _cholesky
    gives it) turns NaN in every state vector, as in the plain loop; the
    other lanes are untouched by it."""
    _, seen = capture_blocks(_random_qps(seed=2))
    tensors, sigma, alpha, iters = seen[1]
    tensors = [t.clone() for t in tensors]
    tensors[1][2] = torch.nan
    got = _against_plain((tensors, sigma, alpha, iters))
    for v in got:
        assert bool(v[2].isnan().all())
        assert bool(torch.cat([v[:2], v[3:]]).isfinite().all())


@pytest.mark.parametrize("which", [0, -1])
def test_host_block_matches_the_plain_loop_on_the_t8_rung(which):
    """The shared-matrix route's ADMM rung on robust_avoid T=8 (n=96,
    m=256), the first and the last block."""
    _, seen = capture_blocks(shared_qps(4, CPU), eps=1e-4, polish=False)
    _against_plain(seen[which])


@pytest.mark.parametrize("kw", [dict(eps=1e-4, polish=False),
                                dict(eps=1e-6, polish=False),
                                dict(eps=1e-9)],
                         ids=["rung-1e-4", "rung-1e-6", "route-1e-9"])
def test_solve_through_the_host_block_matches_reference(host_block, kw):
    """solve_qp_batch with the host block on the T=8 shared-matrix QPs at
    the rung's tolerances (no polish) and the ADMM route's (polished),
    against the JAX package: the same statuses and iteration counts, x
    and y within 1e-7; every block through the host block."""
    qps = shared_qps(8, CPU)
    c0 = dict(METRICS.counters)
    got = batch_qp.solve_qp_batch(**qps, **kw)
    blocks = METRICS.counters["admm_blocks"] - c0.get("admm_blocks", 0.0)
    fused = (METRICS.counters["admm_fused_blocks"]
             - c0.get("admm_fused_blocks", 0.0))
    assert blocks > 0 and fused == blocks
    want = ref_qp.solve_qp_batch(*(qps[k].numpy() for k in (
        "P", "q", "A", "l", "u", "row_mask")), **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=TOL, err_msg=f)


def _transposed(t):
    """The same values stored with the last two axes swapped in memory."""
    if t.dim() == 3:
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    return t.t().contiguous().t()


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_solve_through_the_host_block_matches_the_plain_loop(host_block,
                                                             layout):
    """On the random QPs (a loose, one-sided and equality rows, a padding
    row) the whole solve ends as the plain loop's: the same statuses and
    iteration counts, x and y within 1e-7; also where the caller's P, q,
    A and bounds are transposed views (as solve()'s QPs can be), which the
    block reads row after row."""
    qps = _random_qps(B=8, seed=3)
    if layout == "transposed":
        qps = {k: _transposed(v) for k, v in qps.items()}
        assert not qps["A"].is_contiguous()
    got = batch_qp.solve_qp_batch(**qps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_qp, "_fused_block", lambda *a: None)
        want = batch_qp.solve_qp_batch(**qps)
    assert torch.equal(got.status, want.status)
    assert torch.equal(got.iters, want.iters)
    for f in ("x", "y"):
        assert float((getattr(got, f) - getattr(want, f)).abs().max()) <= TOL


def test_instance_choice():
    """By (n, m) against the H100's opt-in limit: the kernel takes a lane
    whose factor L and vectors fit one block's shared memory (the T=8
    rung: n=96, m=256; up to n=154 at m=256) and n up to 160, the rows its
    solving warp holds; elsewhere the plain loop.  A pure function of the
    shape and the limit."""
    fits = admm_cuda.host_fits
    assert fits(6, 16) and fits(96, 256) and fits(154, 256)
    assert fits(160, 8)
    assert not fits(155, 256)
    assert not fits(160, 16)
    assert not fits(0, 10)
    assert not fits(96, 4000)
    assert not fits(96, 256, optin=-1)
    assert not fits(96, 256, optin=48 * 1024)
    # past the rows of the solving warp, whatever the limit
    assert fits(160, 0, optin=1 << 30) and not fits(161, 0, optin=1 << 30)
    # the rung's lane: L (96 x 97 f64), the vectors and the loose flags
    rung = (96 * 97 + 20 * 96 + 8 * 256) * 8 + 256
    assert fits(96, 256, optin=rung) and not fits(96, 256, optin=rung - 1)


def test_banded_factors_and_cpu_tensors_keep_the_plain_loop():
    """The block runs only for dense factors of CUDA tensors: CPU tensors
    and banded factors (on any device) take the plain loop, asked before
    any kernel library is touched."""
    assert batch_qp._fused_block(96, 256, CPU, 0) is None
    assert batch_qp._fused_block(96, 256, torch.device("cuda"), 8) is None
    assert batch_qp._fused_block(96, 256, CPU, 8) is None


@pytest.mark.parametrize("banded_k", [0, 2])
def test_counters_count_blocks_and_fused_blocks(banded_k):
    """On the CPU every block is the plain loop's: admm_fused_blocks stays
    0 beside admm_blocks (and is there, so a reader can tell a program
    without the kernel); with the host block every block is counted
    fused."""
    qps = _random_qps(B=4, m=12, n=8, seed=4)
    if banded_k:
        qps["P"] = torch.eye(8, dtype=torch.float64).expand(4, 8, 8)
        qps["A"] = torch.zeros(4, 12, 8, dtype=torch.float64)
        for i in range(12):
            qps["A"][:, i, (2 * i) % 8:(2 * i) % 8 + 2] = 1.0
    METRICS.reset()
    batch_qp.solve_qp_batch(**qps, banded_k=banded_k)
    c = METRICS.counters
    assert c["admm_blocks"] > 0 and c["admm_fused_blocks"] == 0.0
    blocks = c["admm_blocks"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_qp, "_fused_block",
                   lambda n, m, dev, k: None if k
                   else admm_cuda.admm_block_host)
        METRICS.reset()
        batch_qp.solve_qp_batch(**qps, banded_k=banded_k)
    c = METRICS.counters
    assert c["admm_blocks"] == blocks
    assert c["admm_fused_blocks"] == (0.0 if banded_k else blocks)


def _reader():
    path = ROOT / "qpnbench" / "metrics" / "admm_fused_pct.shared.py"
    spec = importlib.util.spec_from_file_location("admm_fused_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Rec:
    def __init__(self, counters):
        self.counters = counters


def test_benchmark_reader_of_fused_blocks():
    """admm_fused_pct.shared: fused blocks over blocks × 100; nothing where
    no block ran, or where the program does not count fused blocks (a
    parent without the kernel)."""
    read = _reader()
    assert read(_Rec({"admm_blocks": 40.0, "admm_fused_blocks": 40.0})) \
        == 100.0
    assert read(_Rec({"admm_blocks": 40.0, "admm_fused_blocks": 10.0})) \
        == 25.0
    assert read(_Rec({"admm_blocks": 40.0})) is None
    assert read(_Rec({"admm_fused_blocks": 0.0})) is None
    assert read(_Rec({})) is None
