"""The port's entry points (``qpn_tpu_torch/entry.py``) against the JAX
package's ``__graft_entry__.py``: ``entry()``'s forward step to 1e-8, and
``dryrun_multichip(2)`` on the CPU over gloo, its four stages held to the
single-process port (z to 1e-12, keep masks, iterations and piece counts
exactly) and its superstep to the JAX package's on a 2-device mesh (z to
1e-8, keep exactly).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from qpn_tpu.parallel import mesh as ref_mesh
from qpn_tpu.parallel import sharded as ref_sharded
from qpn_tpu.models.robust_avoid import scenario_batch_gavis

import qpn_tpu_torch as qt
from qpn_tpu_torch import entry
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops.shared_kkt import solve_kkt_avi_shared
from qpn_tpu_torch.parallel import mesh, sharded

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture(scope="module")
def dryrun():
    old = CONFIG.device
    CONFIG.device = "cpu"
    try:
        return entry.dryrun_multichip(2, timeout_s=600)
    finally:
        CONFIG.device = old


def one_rank_mesh():
    return mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                     device=torch.device("cpu"), backend="gloo")


def test_entry_matches_graft_entry():
    import jax
    fwd, args = entry.entry()
    assert all(a.device.type == "cpu" for a in args)
    z = fwd(*args)
    assert z.shape == (4, args[1].shape[1])
    rfwd, rargs = ref_entry.entry()
    rz = np.asarray(jax.jit(rfwd)(*rargs))
    np.testing.assert_allclose(z.numpy(), rz, rtol=0, atol=1e-8)


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(CONFIG, "device", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA"):
        entry.entry() if call == "entry" else entry.dryrun_multichip(2)


def test_dryrun_prints_one_summary_line(dryrun):
    # rank 0 printed the line while the fixture ran; each rank returns it
    lines = {r["line"] for r in dryrun}
    assert len(lines) == 1
    line = lines.pop()
    assert line.startswith("dryrun_multichip: mesh=(('scenario', 1), "
                           "('branch', 2)) backend=gloo device=cpu "
                           "scenarios=4 ")
    assert "ring_pieces=8256->6192" in line


def test_dryrun_superstep_matches_port_and_jax(dryrun):
    batch = scenario_batch_gavis(num_scenarios=4, T=1, num_obj=1,
                                 num_poly_faces=3, seed=0)
    one = sharded.equilibrium_superstep(one_rank_mesh(), batch, tol=1e-6,
                                        max_iter=420)
    ref = ref_sharded.equilibrium_superstep(ref_mesh.make_mesh(2), batch,
                                            tol=1e-6, max_iter=420)
    for r in dryrun:
        np.testing.assert_allclose(r["z"], one["z"].numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(r["keep"], one["keep"].numpy())
        np.testing.assert_allclose(r["z"], np.asarray(ref["z"]), rtol=0,
                                   atol=1e-8)
        np.testing.assert_array_equal(r["keep"], np.asarray(ref["keep"]))
        assert r["frac"] == float(ref["converged_frac"])


def test_dryrun_lockstep_matches_serial_solves(dryrun):
    for k, w in enumerate(entry.LOCKSTEP_WS):
        one = qt.solve(qt.setup("simple_bilevel"),
                       np.concatenate([w, [0.0, 0.0]]))
        pieces = {j: len(v) for j, v in one.Sol.items() if v is not None}
        for r in dryrun:
            np.testing.assert_allclose(r["x_opts"][k], one.x_opt, rtol=0,
                                       atol=1e-9)
            assert r["pieces"][k] == pieces
            assert r["waves"] >= 1


def test_dryrun_shared_route_matches_single_process(dryrun):
    sb = scenario_batch_gavis(num_scenarios=8, T=2, num_obj=1,
                              num_poly_faces=4, seed=1)
    one = solve_kkt_avi_shared(sb["M"], sb["q"], sb["l"], sb["u"],
                               sb["mask"], tol=1e-8,
                               structure=sb["structure"])
    for r in dryrun:
        assert r["shared_conv"].all()
        np.testing.assert_array_equal(r["shared_iters"], one.iters.numpy())
        np.testing.assert_allclose(r["shared_z"], one.z.numpy(), rtol=0,
                                   atol=1e-12)


def test_dryrun_ring_dedup(dryrun):
    for r in dryrun:
        assert r["ring_kept"] == entry.RING_PIECES - entry.RING_PIECES // 4
        assert r["ring_waves"] >= 1
    assert dryrun[0]["ring_sigs"] == dryrun[1]["ring_sigs"]
    # every collective moved bytes across the two ranks; the superstep's
    # shapes fix its count
    for r in dryrun:
        assert r["bytes"]["ring"] > 0 and r["bytes"]["superstep"] > 0
        assert r["secs"]["ring"] > 0
