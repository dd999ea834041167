"""The port's checkpoints (``qpn_tpu_torch/utils/checkpoint.py`` and
``solve(checkpoint_path=...)``) against the JAX package's: the checkpoint
cases of ``tests/test_aux.py`` on the port, a checkpoint written by either
package loaded by the other, and checkpointed solves of both packages ending
at the same point.

Tolerances: a checkpoint stores f64 arrays, so a round trip is bit-exact; a
solve's x_opt is held to the JAX package's at 1e-6 (``test_torch_solve.py``:
the same trajectory, each QEP solved to 1e-10)."""

import os

import numpy as np
import pytest
import torch

import qpn_tpu as ref_qt
from qpn_tpu.geometry import poly as ref_poly
from qpn_tpu.utils import checkpoint as ref_ck

import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry import poly
from qpn_tpu_torch.geometry.query_cache import CACHE
from qpn_tpu_torch.utils import checkpoint

# a solve runs thousands of tiny batched ops: intra-op threads make them no
# faster and contend with the other test workers
torch.set_num_threads(1)

X_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _state(mod, seed):
    """Seeded state for save_state, built with ``mod``'s Poly: x, a union
    of a box and a polyhedron with strict rows, an iterate cache."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, 2))
    p = mod.Poly(A, -rng.random(3), rng.random(3),
                 strict_l=np.array([True, False, True]), normalize=False,
                 dedupe=False)
    pu = mod.PolyUnion([mod.from_box([0.0, 0.0], [1.0, 2.0]), p])
    cache = {1: [rng.standard_normal(2) for _ in range(3)], 2: []}
    return rng.standard_normal(4), {7: pu, 9: None}, cache


def _same_union(a, b):
    assert len(a) == len(b)
    for p, r in zip(a, b):
        for f in ("A", "l", "u", "strict_l", "strict_u"):
            np.testing.assert_array_equal(getattr(p, f), getattr(r, f))


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_aux.py's round trip on the port."""
    x = np.array([1.0, 2.0, 3.0])
    pu = poly.PolyUnion([poly.from_box([0.0], [1.0]),
                         poly.from_box([2.0], [3.0])])
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(path, x, Sol={7: pu},
                          iterate_cache={1: [np.array([0.5, 0.5])]},
                          meta={"iteration": 3})
    state = checkpoint.load_state(path)
    assert np.allclose(state["x"], x)
    assert len(state["Sol"][7]) == 2
    assert state["Sol"][7][0].contains(np.array([0.5]))
    assert state["meta"]["iteration"] == 3
    assert len(state["iterate_cache"][1]) == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer, seed):
    """A file written by one package loads in the other, bit for bit."""
    path = str(tmp_path / "ck")           # save_state appends .npz
    if writer == "port":
        x, sol, cache = _state(poly, seed)
        checkpoint.save_state(path, x, Sol=sol, iterate_cache=cache,
                              meta={"iteration": seed})
        got = ref_ck.load_state(path)
    else:
        x, sol, cache = _state(ref_poly, seed)
        ref_ck.save_state(path, x, Sol=sol, iterate_cache=cache,
                          meta={"iteration": seed})
        got = checkpoint.load_state(path)
    assert os.path.exists(path + ".npz")
    np.testing.assert_array_equal(got["x"], x)
    assert sorted(got["Sol"]) == [7]
    _same_union(got["Sol"][7], sol[7])
    assert got["meta"] == {"iteration": seed}
    assert sorted(got["iterate_cache"]) == [1, 2]
    np.testing.assert_array_equal(np.stack(got["iterate_cache"][1]),
                                  np.stack(cache[1]))
    assert got["iterate_cache"][2] == []


def test_save_state_replaces_atomically(tmp_path):
    """A second save over the same path replaces the file and leaves no
    temporary file behind."""
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, np.zeros(2), meta={"iteration": 1})
    checkpoint.save_state(path, np.ones(2), meta={"iteration": 2})
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert checkpoint.load_state(path)["meta"]["iteration"] == 2


def test_solve_with_checkpoint_and_resume(tmp_path):
    """tests/test_aux.py's solve/resume case on the port, and against the
    JAX package's checkpointed solve: the same x_opt and the same pieces in
    the stored solution graph, and each package's file loads in the
    other."""
    x0 = np.array([1.0, 0.0, 0.0, 0.0])
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    path = str(tmp_path / "run.npz")
    ret = qt.solve(qpn, x0, checkpoint_path=path)
    assert ret.solved
    state = checkpoint.load_state(path)
    assert state["meta"].get("solved") is True
    assert np.allclose(state["x"], ret.x_opt)
    assert 2 in state["Sol"]
    ret2 = checkpoint.resume(qpn, path)
    assert ret2.solved
    assert np.allclose(ret2.x_opt, ret.x_opt, atol=1e-6)

    ref_path = str(tmp_path / "ref.npz")
    want = ref_qt.solve(ref_qt.setup("simple_bilevel", gen_solution_map=True),
                        x0, checkpoint_path=ref_path)
    np.testing.assert_allclose(ret.x_opt, want.x_opt, rtol=0, atol=X_TOL)
    ref_state = checkpoint.load_state(ref_path)
    assert ref_state["meta"] == state["meta"]
    assert sorted(ref_state["Sol"]) == sorted(state["Sol"])
    for node in state["Sol"]:
        assert len(ref_state["Sol"][node]) == len(state["Sol"][node])
    assert len(ref_ck.load_state(path)["Sol"][2]) == len(state["Sol"][2])


def test_solve_with_checkpoint_writes_frontiers(tmp_path):
    qpn = qt.setup("simple_bilevel")
    path = str(tmp_path / "ckpt")
    ret = qt.solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]), checkpoint_path=path)
    assert ret.solved
    fdir = path + ".frontiers"
    assert os.path.isdir(fdir) and len(os.listdir(fdir)) >= 1
    # a later solve without a checkpoint path neither resumes nor writes
    n_files = len(os.listdir(fdir))
    qt.solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]))
    assert qpn.frontier_store is None
    assert len(os.listdir(fdir)) == n_files


def test_robust_avoid_resumes_to_its_solution(tmp_path):
    """robust_avoid at the zoo's configuration: the checkpointed solve ends
    where the plain one does (x_opt, QEP and piece counts), and resuming
    from its file solves to the same point."""
    kw = dict(T=2, num_obj=1, num_poly_faces=3)
    CACHE.clear()
    plain = qt.solve(qt.setup("robust_avoid", **kw))
    plain_counts = dict(qt.METRICS.counters)
    CACHE.clear()
    qpn = qt.setup("robust_avoid", **kw)
    path = str(tmp_path / "ra")
    ret = qt.solve(qpn, checkpoint_path=path)
    assert ret.solved and plain.solved
    np.testing.assert_array_equal(ret.x_opt, plain.x_opt)
    for key in ("qep_solves", "pieces_projected"):
        assert qt.METRICS.counters[key] == plain_counts[key]
    assert sorted(checkpoint.load_state(path)["Sol"]) == sorted(
        k for k, v in ret.Sol.items() if v is not None)
    res = checkpoint.resume(qt.setup("robust_avoid", **kw), path)
    assert res.solved
    np.testing.assert_allclose(res.x_opt, ret.x_opt, rtol=0, atol=X_TOL)


class TestFrontierCheckpoint:
    """tests/test_aux.py's mid-enumeration kill/resume on the port: a
    resumed enumerator reproduces the full piece set from its stored
    frontier, including from a frontier the JAX package stored."""

    @staticmethod
    def _enumerator(pkg, store=None):
        if pkg == "port":
            from qpn_tpu_torch.algorithm import (_prepare_qp_tasks,
                                                 verify_solutions_batch)
            from qpn_tpu_torch.enumeration import process_solution_graph
            qpn = qt.setup("simple_bilevel")
        else:
            from qpn_tpu.algorithm import (_prepare_qp_tasks,
                                           verify_solutions_batch)
            from qpn_tpu.enumeration import process_solution_graph
            qpn = ref_qt.setup("simple_bilevel")
        x = np.array([0.0, 1.0, 0.5, 0.5])
        leaf = sorted(qpn.network_depth_map[qpn.num_levels()])[0]
        prep = _prepare_qp_tasks(qpn, leaf, x, {})
        ret = verify_solutions_batch(prep.tasks, x)[0]
        assert ret.solution
        return process_solution_graph(
            prep.qp, prep.base_constraints, prep.dec_inds, x, ret.lam,
            exploration_vertices=10, frontier_store=store)

    @staticmethod
    def _key(polys):
        return {tuple(np.round(p.A.flatten(), 5).tolist())
                + tuple(np.round(p.l, 5).tolist()) for p in polys}

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_kill_resume_reproduces_piece_set(self, tmp_path, writer):
        truth = self._key(self._enumerator("port").collect())
        if writer == "port":
            store = checkpoint.FrontierStore(str(tmp_path / "f"))
        else:
            store = ref_ck.FrontierStore(str(tmp_path / "f"))
        gen = self._enumerator(writer, store)
        # simulate a kill after ONE frontier generation
        Ks = list(gen.unexplored_Ks)
        gen.explored_Ks |= gen.unexplored_Ks
        gen.unexplored_Ks = set()
        gen._absorb(gen._expand_batch(Ks))
        gen._checkpoint()
        partial_count = len(gen.polys)
        del gen
        # a fresh port enumerator on the same directory resumes mid-frontier
        gen2 = self._enumerator(
            "port", checkpoint.FrontierStore(str(tmp_path / "f")))
        assert len(gen2.polys) == partial_count
        assert self._key(gen2.collect()) == truth
