"""The port's f32 feasibility screen (``qpn_tpu_torch/ops/screen.py``): its
plain PyTorch loop and the g++ build of the Hopper kernel's lane code
(``csrc/screen_lane.cuh``), against the JAX package's Pallas kernel run in
interpret mode (``qpn_tpu.ops.pallas_kernels.feasibility_screen``), on the
polyhedra of ``tests/test_pallas.py`` and on a seeded batch.

Tolerances: all three step in f32 from the same normalised inputs and differ
only in the order of each sum, a few ulps per step; the 120 steps contract
toward the polyhedron, so x agrees to 1e-5 of its scale and max |v| to 1e-5
(relative to 1 + |v|).  A polyhedron may be witnessed by one side only where
a max |v| lies within that band of the margin.
"""

import numpy as np
import pytest
import torch

from qpn_tpu.geometry.poly import Poly as RefPoly, from_box as ref_box
from qpn_tpu.ops import pallas_kernels as pk

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry.poly import Poly, from_box
from qpn_tpu_torch.ops import screen, screen_cuda

TOL = 1e-5
STEPS, LR = 120, 0.05


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _pallas_cases(P, box):
    return [
        box([0.0, 0.0], [1.0, 1.0]),
        P(np.array([[1.0, 0.0], [1.0, 0.0]]), [2.0, -np.inf],
          [np.inf, 1.0], dedupe=False),            # empty: x>=2 & x<=1
        box([-3.0, -3.0], [-2.0, -2.0]),
        P(np.array([[1.0, 1.0]]), [10.0], [np.inf]),  # halfspace far away
    ]


def _seeded(P, B=24, m=7, n=4, seed=0):
    """Nonempty polyhedra near the origin and empty ones (two rows with one
    normal, bounds 2 apart), rows of assorted lengths, one-sided rows."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        mb = m - b % 3
        A = rng.standard_normal((mb, n))
        ax = A @ (0.3 * rng.standard_normal(n))
        w = 0.2 + rng.random(mb)
        l, u = ax - w, ax + w
        u[2] = np.inf
        if b % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, np.inf
            l[1], u[1] = -np.inf, ax[0] - 1.0
        out.append(P(A, l, u, normalize=False, dedupe=False))
    return out


CASES = {"pallas": lambda P, box: _pallas_cases(P, box),
         "seeded": lambda P, box: _seeded(P)}


def _reference(monkeypatch, polys, **kw):
    """The JAX package's screen, with the raw kernel inputs and outputs
    captured (unpadded)."""
    seen = {}
    call = pk._screen_call

    def spy(A, l, u, x0, **skw):
        xs, vs = call(A, l, u, x0, **skw)
        seen.update(A=A, l=l, u=u, x0=x0, xs=np.asarray(xs),
                    vs=np.asarray(vs))
        return xs, vs

    monkeypatch.setattr(pk, "_screen_call", spy)
    witnessed, xs = pk.feasibility_screen(polys, **kw)
    B, n = len(polys), polys[0].dim
    m = max(max(p.m, 1) for p in polys)
    raw = {k: seen[k] for k in ("A", "l", "u")}
    raw["A"] = raw["A"][:B, :m, :n]
    raw["l"], raw["u"] = raw["l"][:B, :m], raw["u"][:B, :m]
    return witnessed, seen["xs"][:B, :n], seen["vs"][:B, 0], raw


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepared_inputs_match_reference(monkeypatch, case):
    """Row normalisation and bounds as the JAX package hands its kernel, to
    2 ulps (numpy sums each row's squares over 128 padded lanes there, over
    n here); its 3e38 stand-in for a missing bound is ±inf in the port."""
    polys = CASES[case](Poly, from_box)
    _, _, _, raw = _reference(monkeypatch, CASES[case](RefPoly, ref_box))
    prob = screen.screen_prepare(polys)
    ulp2 = 2 * np.finfo(np.float32).eps
    np.testing.assert_allclose(prob.A, raw["A"], rtol=ulp2, atol=0)
    for port, ref, sign in ((prob.l, raw["l"], -1), (prob.u, raw["u"], 1)):
        big = np.abs(ref) >= 1.5e38
        np.testing.assert_allclose(port[~big], ref[~big], rtol=ulp2, atol=0)
        assert (port[big] == sign * np.inf).all()
        assert np.isfinite(port[~big]).all()


@pytest.mark.parametrize("engine", ["torch", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_pallas_interpret(monkeypatch, case, engine):
    """x and max |v| after 120 steps, and the witnessed polyhedra (margin
    1e-3, the host check included) against the Pallas kernel."""
    run = (screen.screen_steps_torch if engine == "torch"
           else screen_cuda.screen_steps_host)
    polys = CASES[case](Poly, from_box)
    w_ref, x_ref, v_ref, _ = _reference(monkeypatch,
                                        CASES[case](RefPoly, ref_box))
    prob = screen.screen_prepare(polys)
    x, v = run(*(torch.as_tensor(a) for a in prob), STEPS, LR)
    x, v = x.numpy(), v.numpy()
    scale = 1.0 + np.abs(x_ref).max(axis=1, keepdims=True)
    assert (np.abs(x - x_ref) / scale).max() <= TOL
    assert (np.abs(v - v_ref) / (1.0 + v_ref)).max() <= TOL
    w, xs = screen.feasibility_screen(polys, engine=run)
    near = np.abs(v_ref - 1e-3) <= TOL * (1 + 1e-3)
    assert not ((w != w_ref) & ~near).any()
    for p, wi, xi in zip(polys, w, xs):
        assert (xi is not None) == wi
        if wi:
            assert p.closure().contains(xi, tol=1e-3)


def test_pallas_cases_witnesses():
    """tests/test_pallas.py::test_feasibility_screen_witnesses on the port
    (300 steps, lr 0.1)."""
    polys = _pallas_cases(Poly, from_box)
    witnessed, xs = screen.feasibility_screen(polys, steps=300, lr=0.1)
    assert witnessed[0] and xs[0] is not None
    assert not witnessed[1]
    assert witnessed[2]
    for w, p, xw in zip(witnessed, polys, xs):
        if w:
            assert p.closure().contains(xw, tol=1e-3)


@pytest.mark.parametrize("engine", ["torch", "host"])
def test_nan_propagates(engine):
    """A NaN start gives NaN in x and max |v| of that polyhedron only, as
    jnp.maximum / jnp.minimum give it; such a polyhedron is never
    witnessed.  The Pallas kernel in interpret mode does the same from a
    shared NaN start."""
    run = (screen.screen_steps_torch if engine == "torch"
           else screen_cuda.screen_steps_host)
    polys = _seeded(Poly, B=4)
    A, l, u, x0 = (torch.as_tensor(a) for a in screen.screen_prepare(polys))
    x0[1, 0] = float("nan")
    x, v = run(A, l, u, x0, 10, LR)
    assert bool(torch.isnan(v[1])) and bool(torch.isnan(x[1]).any())
    assert bool(torch.isfinite(v[[0, 2, 3]]).all())
    nan0 = np.array([np.nan, 0.0, 0.0, 0.0])
    w, _ = screen.feasibility_screen(polys, x0=nan0, engine=run)
    w_ref, _ = pk.feasibility_screen(_seeded(RefPoly, B=4), x0=nan0)
    assert not w.any() and not w_ref.any()


def _ragged(P, B, m, n, seed):
    """Polyhedra of dimension n whose row counts run from 1 to m (the batch
    pads them with zero rows), with one-sided and free rows."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        mb = m if b == 0 else 1 + (b * 5) % m
        A = rng.standard_normal((mb, n))
        ax = A @ (0.3 * rng.standard_normal(n))
        w = 0.2 + rng.random(mb)
        l, u = ax - w, ax + w
        u[rng.random(mb) < 0.3] = np.inf
        l[rng.random(mb) < 0.2] = -np.inf
        out.append(P(A, l, u, normalize=False, dedupe=False))
    return out


# the warp instance's ceilings are multiples of 4 up to 32: one shape at,
# below and above an edge for rows and for columns, and the first shapes
# that go to the generic instance
EDGE_SHAPES = [(1, 5), (5, 1), (8, 8), (9, 8), (8, 9), (18, 26), (32, 32),
               (33, 5), (5, 33), (32, 33)]


@pytest.mark.parametrize("m,n", EDGE_SHAPES)
def test_host_instance_at_the_register_edges(monkeypatch, m, n):
    """The g++ instance the launcher's rule picks for (m, n), on ragged row
    counts: against the Pallas kernel in interpret mode and the plain loop
    (TOL, as above), and bit for bit against the generic instance, which
    sums in the same order without the zero padding of the registers."""
    polys = _ragged(Poly, 6, m, n, seed=m * 100 + n)
    _, x_ref, v_ref, _ = _reference(monkeypatch,
                                    _ragged(RefPoly, 6, m, n, m * 100 + n))
    ins = [torch.as_tensor(a) for a in screen.screen_prepare(polys)]
    assert ins[0].shape == (6, m, n)
    x, v = screen_cuda.screen_steps_host(*ins, STEPS, LR)
    xg, vg = screen_cuda.screen_steps_host(*ins, STEPS, LR, generic=True)
    assert torch.equal(x, xg) and torch.equal(v, vg)
    xp, vp = screen.screen_steps_torch(*ins, STEPS, LR)
    for xr, vr in ((x_ref, v_ref), (xp.numpy(), vp.numpy())):
        scale = 1.0 + np.abs(xr).max(axis=1, keepdims=True)
        assert (np.abs(x.numpy() - xr) / scale).max() <= TOL
        assert (np.abs(v.numpy() - vr) / (1.0 + vr)).max() <= TOL


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("m,n", [(9, 8), (18, 18), (33, 5)])
def test_host_instance_keeps_nan_and_inf(m, n, bad):
    """A NaN or infinite start entry spoils that polyhedron only (0·inf is
    NaN in every engine), and the register instance's padding entries do
    not change which values come out: the bits of the generic instance."""
    ins = [torch.as_tensor(a)
           for a in screen.screen_prepare(_ragged(Poly, 4, m, n, seed=7))]
    ins[3][1, n - 1] = bad
    x, v = screen_cuda.screen_steps_host(*ins, 10, LR)
    xg, vg = screen_cuda.screen_steps_host(*ins, 10, LR, generic=True)
    xp, vp = screen.screen_steps_torch(*ins, 10, LR)
    for xe, ve in ((xg, vg), (xp, vp)):
        assert torch.equal(torch.isnan(x), torch.isnan(xe))
        assert torch.equal(torch.isnan(v), torch.isnan(ve))
    fin = ~torch.isnan(x)
    assert torch.equal(x[fin], xg[fin])
    assert not bool(torch.isfinite(v[1]))
    assert bool(torch.isfinite(v[[0, 2, 3]]).all())


def test_engine_choice_and_wrapper_checks(monkeypatch):
    """screen_kernel "auto" takes the plain loop for CPU tensors; the CUDA
    wrapper refuses CPU tensors (no fallback) and a bad mode raises."""
    cpu = torch.device("cpu")
    assert screen.screen_engine(cpu) is screen.screen_steps_torch
    monkeypatch.setattr(CONFIG, "screen_kernel", "cuda")
    assert screen.screen_engine(cpu) is screen_cuda.feasibility_screen_cuda
    prob = [torch.as_tensor(a)
            for a in screen.screen_prepare(_seeded(Poly, B=2))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        screen_cuda.feasibility_screen_cuda(*prob, STEPS, LR)
    monkeypatch.setattr(CONFIG, "screen_kernel", "bogus")
    with pytest.raises(ValueError, match="screen_kernel"):
        screen.screen_engine(cpu)
    with pytest.raises(TypeError, match="float32"):
        screen_cuda.screen_steps_host(prob[0].double(), *prob[1:], 1, LR)
