"""``qpn_tpu_torch.solve`` end to end, held to the JAX package: the golden
simple_bilevel table (``tests/test_simple_bilevel.py``, the reference's
test/simple_bilevel.jl), the ten zoo configs of
``benchmarks/framework_bench.py`` at ``ZOO_r05_cpu.json``'s QEP and piece
counts with x_opt against the JAX package's solve, the trajectory
fingerprint of ``tests/test_models.py`` (robust_avoid: 7 QEP, 60 pieces),
and the zoo again with the feasibility screen forced on.

x_opt tolerance 1e-6: both packages follow the same trajectory (same QEP
and piece counts) and solve each QEP to 1e-10; the measured difference is at
most 1.2e-12.
"""

import math

import numpy as np
import pytest
import torch

import qpn_tpu as ref
import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry.query_cache import CACHE

# A solve runs thousands of tiny batched ops: intra-op threads make them no
# faster and contend with the other test workers (measured: the same wall
# time at a third of the CPU time with one thread).
torch.set_num_threads(1)

X_TOL = 1e-6

W = [
    [-2.0, -3.0], [0.0, -1.0], [1.0, -3.0], [1.0, -1.0],
    [1.0, 0.0], [0.0, 1.0], [-1.0, 1 + math.sqrt(2.0)], [0.0, 0.0],
]
X = [
    [[-2.0, 0.0]],
    [[0.0, 0.0]],
    [[0.0, 0.0]],
    [[0.0, 0.0]],
    [[0.5, 0.5]],
    [[0.5, 0.5], [0.0, 0.0]],
    [[-1.0, 0.0], [math.sqrt(2.0) / 2, math.sqrt(2.0) / 2]],
    [[0.0, 0.0]],
]
S = [1, 2, 1, 2, 1, 1, 1, 3]

# benchmarks/framework_bench.py CONFIGS with ZOO_r05_cpu.json's counts:
# name -> (setup kwargs, x_init, QEP solves, pieces projected)
ZOO = {
    "simple_bilevel": (dict(gen_solution_map=True), [0.0, 1.0, 0.0, 0.0],
                       1, 4),
    "shepherd_sheep": (dict(), None, 1, 2),
    "toll_setting": (dict(), None, 2, 2),
    "rock_paper_scissors": (dict(bilevel=True), None, 0, 1),
    "trilevel_escape": (dict(), None, 3, 5),
    "four_player_matrix_game": (dict(edge_list=[(1, 2), (3, 4)], seed=2),
                                [0.0] * 8, 2, 4),
    "robust_avoid_simple": (dict(num_obj=1), None, 9, 58),
    "chainstore": (dict(num_towns=3), None, 0, 7),
    "deep_synthetic": (dict(levels=8, width=1), None, 0, 7),
    "robust_avoid": (dict(T=2, num_obj=1, num_poly_faces=3), None, 7, 60),
}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _solve(pkg, name):
    kw, x0, _, _ = ZOO[name]
    qpn = pkg.setup(name, **kw)
    ret = pkg.solve(qpn, None if x0 is None else np.asarray(x0))
    c = qpn.metrics.counters
    return (ret, int(c.get("qep_solves", 0)),
            int(c.get("pieces_projected", 0)))


@pytest.fixture(scope="module")
def bilevel():
    return qt.setup("simple_bilevel", gen_solution_map=True)


@pytest.mark.parametrize("w,xs,s", list(zip(W, X, S)),
                         ids=[f"w{i+1}" for i in range(8)])
def test_golden_point(bilevel, w, xs, s):
    ret = qt.solve(bilevel, np.concatenate([w, np.zeros(2)]))
    assert ret.solved, getattr(ret, "error", None)
    assert any(np.allclose(ret.x_opt, np.concatenate([w, xi]), atol=1e-4)
               for xi in xs), f"x_opt={ret.x_opt} not in {xs}"
    assert len(list(ret.Sol[2])) >= s


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_matches_reference(name):
    CACHE.clear()
    ret, qep, pieces = _solve(qt, name)
    assert ret.solved, getattr(ret, "error", None)
    assert (qep, pieces) == ZOO[name][2:]
    want, _, _ = _solve(ref, name)
    np.testing.assert_allclose(ret.x_opt, want.x_opt, rtol=0, atol=X_TOL)


def test_trajectory_fingerprint_backend_invariant():
    """tests/test_models.py's fingerprint through the port: robust_avoid
    (T=2, num_obj=1, num_poly_faces=3) takes 7 QEP steps and projects 60
    pieces, the JAX package's counts on the CPU and on a TPU."""
    CACHE.clear()
    qpn = qt.setup("robust_avoid", T=2, num_obj=1, num_poly_faces=3)
    ret = qt.solve(qpn)
    assert ret.solved
    c = qpn.metrics.counters
    assert int(c.get("qep_solves", 0)) == 7
    assert int(c.get("pieces_projected", 0)) == 60


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_with_the_screen_on(monkeypatch, name):
    """use_screen=True changes no count: the screen may only skip exact LPs
    for polyhedra it witnessed (host-checked), and its gate (>= 4
    polyhedra of one dimension, no strict rows) shuts it out of every zoo
    batch."""
    monkeypatch.setattr(CONFIG, "use_screen", True)
    CACHE.clear()
    ret, qep, pieces = _solve(qt, name)
    assert ret.solved
    assert (qep, pieces) == ZOO[name][2:]
    assert qt.METRICS.counters.get("screen_polys", 0) == 0


def test_solve_many_and_flat_initialization():
    """solve_many solves each network; the flattened warm start is a point
    of the right size."""
    nets = [qt.setup("shepherd_sheep"), qt.setup("toll_setting")]
    rets = qt.solve_many(nets)
    assert all(r.solved for r in rets)
    x0 = qt.setup("simple_bilevel").get_flat_initialization()
    assert x0.shape == (4,) and np.isfinite(x0).all()


def test_checkpointing_is_not_ported(tmp_path):
    """Checkpointing is ported now (the name is the test's history):
    solve(checkpoint_path=...) solves as without it and leaves the solved
    state in the file (tests/test_torch_checkpoint.py has the rest)."""
    from qpn_tpu_torch.utils.checkpoint import load_state
    ret = qt.solve(qt.setup("shepherd_sheep"),
                   checkpoint_path=str(tmp_path / "ck"))
    assert ret.solved
    state = load_state(str(tmp_path / "ck"))
    assert state["meta"] == {"solved": True}
    np.testing.assert_array_equal(state["x"], ret.x_opt)
