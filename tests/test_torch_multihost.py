"""Two ranks of one ``torch.distributed`` process group on the CPU over gloo
(``qpn_tpu_torch/parallel/multihost.py`` and ``launch.py``): the port of
``tests/test_multihost.py``.  Each rank runs one sharded equilibrium
superstep, a lockstep ``solve()`` ensemble with its waves split over the
ranks, and the shared-matrix route with the mesh; every rank's view must
match the single-process port (z to 1e-12, statuses, iterations, keep
masks and piece counts exactly) and the JAX package (z to 1e-8; x_opt to
``tests/test_torch_solve.py``'s 1e-6).

The launcher's own guarantees are tested here too: a rank that raises
fails the call at once (its peer waits in a collective and is killed), a
rank that hangs is killed at the join timeout, and no rank imports JAX.
"""

import time

import numpy as np
import pytest
import torch

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import shared_kkt as ref_shared
from qpn_tpu.parallel import mesh as ref_mesh
from qpn_tpu.parallel import sharded as ref_sharded
import qpn_tpu as ref_qt

import _torch_dist_worker as worker
import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops.shared_kkt import solve_kkt_avi_shared
from qpn_tpu_torch.parallel import launch, mesh, multihost, sharded

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 400.0
WS = [np.array([0.0, 1.0]), np.array([1.0, 1.5])]
SUPERSTEP = dict(num_scenarios=16, T=2, num_obj=1, num_poly_faces=4, seed=0,
                 tol=1e-8)
SHARED = dict(num_scenarios=32, T=2, num_obj=1, num_poly_faces=4, seed=0)


def _spawn(n, cases, timeout_s=SPAWN_TIMEOUT_S):
    old = CONFIG.device
    CONFIG.device = "cpu"
    try:
        return launch.spawn(worker.run_cases, n, (cases,),
                            timeout_s=timeout_s)
    finally:
        CONFIG.device = old


@pytest.fixture(scope="module")
def ranks():
    return _spawn(2, [("info", "info", {}),
                      ("superstep", "superstep", SUPERSTEP),
                      ("lockstep", "lockstep", dict(ws=WS)),
                      ("shared", "shared", dict(SHARED, tol=1e-8))])


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def one_rank_mesh():
    return mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                     device=torch.device("cpu"), backend="gloo")


def test_process_info_and_global_mesh(ranks):
    for i, r in enumerate(ranks):
        info = r["info"]
        assert info["info"] == dict(process_index=i, process_count=2,
                                    local_devices=1, global_devices=2)
        assert info["shape"] == {"scenario": 1, "branch": 2}
        assert info["axis_names"] == ("scenario", "branch")
        assert info["backend"] == "gloo" and info["device"] == "cpu"


def test_ranks_import_no_jax(ranks):
    for r in ranks:
        assert r["info"]["jax"] == []


def test_process_info_without_group():
    assert multihost.process_info() == dict(
        process_index=0, process_count=1, local_devices=1, global_devices=1)


def test_two_process_superstep_parity(ranks):
    spec = dict(SUPERSTEP)
    tol = spec.pop("tol")
    batch = scenario_batch_gavis(**spec)
    one = sharded.equilibrium_superstep(one_rank_mesh(), batch, tol=tol)
    ref = ref_sharded.equilibrium_superstep(ref_mesh.make_mesh(8), batch,
                                            tol=tol)
    for i, r in enumerate(ranks):
        d = r["superstep"]
        np.testing.assert_allclose(d["z"], one["z"].numpy(), rtol=0,
                                   atol=1e-12, err_msg=f"rank {i}")
        np.testing.assert_array_equal(d["keep"], one["keep"].numpy())
        assert float(d["converged_frac"]) == float(one["converged_frac"])
        np.testing.assert_allclose(d["z"], np.asarray(ref["z"]), rtol=0,
                                   atol=1e-8, err_msg=f"rank {i}")
        np.testing.assert_array_equal(d["keep"], np.asarray(ref["keep"]))
        assert abs(float(d["converged_frac"])
                   - float(ref["converged_frac"])) < 1e-12


def test_two_process_lockstep_parity(ranks):
    for r in ranks:
        d = r["lockstep"]
        assert all(d["solved"]) and d["waves"] >= 1
    for k, w in enumerate(WS):
        x0 = np.concatenate([w, [0.0, 0.0]])
        one = qt.solve(qt.setup("simple_bilevel"), x0)
        ref = ref_qt.solve(ref_qt.setup("simple_bilevel"), x0)
        assert one.solved and ref.solved
        pieces = {j: len(v) for j, v in one.Sol.items() if v is not None}
        for r in ranks:
            d = r["lockstep"]
            np.testing.assert_allclose(d["x_opts"][k], one.x_opt, rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(d["x_opts"][k], ref.x_opt, rtol=0,
                                       atol=1e-6)
            assert d["pieces"][k] == pieces


def test_two_process_shared_route_parity(ranks):
    sb = scenario_batch_gavis(**SHARED)
    one = solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"], None,
                               tol=1e-8, structure=sb["structure"])
    ref = ref_shared.solve_kkt_avi_shared(
        sb["M"][0], sb["q"], sb["l"], sb["u"], None, tol=1e-8,
        structure=sb["structure"], mesh=ref_mesh.make_mesh(8))
    for i, r in enumerate(ranks):
        d = r["shared"]
        assert d["converged"].all(), f"rank {i}"
        np.testing.assert_array_equal(d["iters"], one.iters.numpy())
        np.testing.assert_allclose(d["z"], one.z.numpy(), rtol=0,
                                   atol=1e-12, err_msg=f"rank {i}")
        np.testing.assert_allclose(d["z"], np.asarray(ref.z), rtol=0,
                                   atol=1e-8, err_msg=f"rank {i}")


def test_shared_route_ignores_a_mesh_that_does_not_divide():
    """S=6 over 4 ranks: the mesh is ignored (the JAX package's rule), so
    the call needs no process group and is the single-process route."""
    sb = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                              num_poly_faces=4, seed=0)
    four = mesh.Mesh(shape={"scenario": 2, "branch": 2}, rank=0,
                     device=torch.device("cpu"), backend="gloo")
    a = solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"], None,
                             tol=1e-8, structure=sb["structure"], mesh=four)
    b = solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"], None,
                             tol=1e-8, structure=sb["structure"])
    assert torch.equal(a.z, b.z) and torch.equal(a.iters, b.iters)


def test_failing_rank_fails_the_call_without_hanging():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _spawn(2, [("fail", "fail", {})])
    # the surviving rank sat in a barrier: it was killed, not waited for
    assert time.perf_counter() - t0 < 60


def test_hanging_rank_is_killed_at_the_join_timeout():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        _spawn(2, [("hang", "hang", {})], timeout_s=15)
    assert time.perf_counter() - t0 < 60


def test_spawn_raises_without_a_card_when_the_device_is_the_card(
        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(CONFIG, "device", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA"):
        launch.spawn(worker.run_cases, 2, ([],))


def test_init_needs_the_group_size_with_an_address():
    with pytest.raises(ValueError, match="num_processes"):
        multihost.init("localhost:1234")

