"""The port's multi-device layer (``qpn_tpu_torch/parallel/mesh.py``,
``sharded.py``, the ``_sharding`` paths of ``ops/avi.py`` and
``ops/batch_qp.py``) on the CPU over gloo, with 2 and 4 ranks, against the
single-process port and the JAX package's sharded functions on the 8-device
virtual CPU mesh (``tests/test_parallel.py``'s cases).

One process group of each size serves every case of this module
(``tests/_torch_dist_worker.py`` holds the rank bodies, free of JAX); each
spawn has a join timeout and each group the launcher's collective timeout.

Tolerances, as the port's rules set them: statuses, ``converged``,
``iters``, keep masks and piece counts exactly; z within 1e-12 of the
single-process port (a lane solved in a block of another batch size may
differ in its last bits: batched products sum in another order) and within
1e-8 of the JAX package (``tests/test_parallel.py``'s bound).
"""

import numpy as np
import pytest
import torch

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import avi as ref_avi
from qpn_tpu.ops import batch_qp as ref_qp
from qpn_tpu.parallel import mesh as ref_mesh
from qpn_tpu.parallel import sharded as ref_sharded

import _torch_dist_worker as worker
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import avi, batch_qp
from qpn_tpu_torch.parallel import launch, mesh, sharded

torch.set_num_threads(1)        # as in the ranks

Z_PORT = 1e-12
Z_JAX = 1e-8
SPAWN_TIMEOUT_S = 400.0


def _avi_problems(B, n=6, seed=0):
    rng = np.random.default_rng(seed)
    Ms, qs = [], []
    for _ in range(B):
        G = rng.standard_normal((n, n))
        Ms.append(G @ G.T + 0.5 * np.eye(n))
        qs.append(rng.standard_normal(n))
    return dict(M=np.array(Ms), q=np.array(qs), l=np.zeros((B, n)),
                u=np.full((B, n), np.inf), z0=np.zeros((B, n)),
                mask=np.ones((B, n), dtype=bool), tol=1e-10)


def _qp_problems(B=5, n=4, m=3, seed=2, lp=False):
    """Seeded QPs (or LPs, P = 0, with 2n rows so that they are bounded)
    with one masked row."""
    rng = np.random.default_rng(seed)
    if lp:
        m = 2 * n
    G = rng.standard_normal((B, n, n))
    P = np.zeros((B, n, n)) if lp else G @ G.transpose(0, 2, 1) + np.eye(n)
    A = rng.standard_normal((B, m, n))
    x = rng.standard_normal((B, n))
    Ax = np.einsum("bmn,bn->bm", A, x)
    mask = np.ones((B, m), dtype=bool)
    mask[0, -1] = False
    return dict(P=P, q=rng.standard_normal((B, n)), A=A, l=Ax - 1.0,
                u=Ax + 1.0, mask=mask)


PRUNE8 = dict(act=np.array([[1, 0], [1, 0], [2, 2], [1, 0], [3, 1], [2, 2],
                            [0, 0], [0, 0]], dtype=np.int32),
              resid=np.zeros(8))
CHAIN = dict(act=np.zeros((8, 3), dtype=np.int32),
             resid=np.array([2e-13, 1e-13, 0.0, 5e-14, 1.5e-13, 0.5e-13,
                             2.5e-13, 1e-14]))
SUPERSTEP16 = dict(num_scenarios=16, T=1, num_obj=1, num_poly_faces=3,
                   seed=0, tol=1e-6, max_iter=420)
SHARED16 = dict(num_scenarios=16, T=8, num_obj=4, num_poly_faces=4, seed=0,
                tol=1e-8)


def _common_cases():
    return [
        ("avi", "avi", _avi_problems(16)),
        ("avi_padded", "avi_padded", _avi_problems(7, seed=3)),
        ("qp_padded", "qp_padded", _qp_problems()),
        ("lp_padded", "qp_padded", dict(_qp_problems(seed=4, lp=True),
                                        _prefer_lemke=True)),
        ("prune8", "prune", PRUNE8),
        ("chain", "prune", CHAIN),
        ("superstep", "superstep", SUPERSTEP16),
    ]


def _spawn(n, cases):
    old = CONFIG.device
    CONFIG.device = "cpu"
    try:
        return launch.spawn(worker.run_cases, n, (cases,),
                            timeout_s=SPAWN_TIMEOUT_S)
    finally:
        CONFIG.device = old


@pytest.fixture(scope="module")
def ranks():
    """Each world size's per-rank results: the common cases at 2 and 4
    ranks, the trajectory-scale superstep at 2."""
    return {2: _spawn(2, _common_cases() + [
                ("shared_superstep", "superstep", SHARED16)]),
            4: _spawn(4, _common_cases() + [("info", "info", {})])}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def one_rank_mesh():
    """A mesh of one rank, with no process group: every gather is the
    identity, so the sharded functions run as the single-process port."""
    return mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                     device=torch.device("cpu"), backend="gloo")


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(r[key][k], first[k])
        else:
            np.testing.assert_array_equal(r[key], first)
    return first


# --------------------------------------------------------------------------
#  mesh arithmetic (no processes)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_axes_match_jax(n):
    jm = ref_mesh.make_mesh(n)
    s, b = mesh.mesh_axes(n)
    assert (s, b) == (jm.shape["scenario"], jm.shape["branch"])
    assert s * b == n


def test_mesh_axes_explicit_scenario_axis_and_rejects_bad_split():
    assert mesh.mesh_axes(8, scenario_axis=2) == (2, 4)
    with pytest.raises(ValueError):
        mesh.mesh_axes(6, scenario_axis=4)


def test_make_mesh_raises_without_process_group():
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        mesh.make_mesh(2)


def test_sharding_blocks_are_row_major():
    m = mesh.Mesh(shape={"scenario": 2, "branch": 2}, rank=3,
                  device=torch.device("cpu"), backend="gloo")
    assert m.size == 4 and m.axis_names == ("scenario", "branch")
    assert m.coords() == {"scenario": 1, "branch": 1}
    assert mesh.scenario_sharding(m).block_index() == 3
    assert mesh.branch_sharding(m).block_index() == 1
    assert mesh.replicated(m).blocks == 1
    assert mesh.block_rows(m, 10) == slice(9, 10)


# --------------------------------------------------------------------------
#  sharded functions at 2 and 4 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_avi_matches_single_process_and_jax(ranks, world):
    p = _avi_problems(16)
    got = _same_on_every_rank(ranks[world], "avi")
    t = [torch.as_tensor(p[k]) for k in ("M", "q", "l", "u", "z0", "mask")]
    one = avi.solve_avi_batch(*t, tol=p["tol"], max_iter=840)
    assert got["converged"].all()
    np.testing.assert_array_equal(got["converged"], one.converged.numpy())
    np.testing.assert_array_equal(got["iters"], one.iters.numpy())
    np.testing.assert_allclose(got["z"], one.z.numpy(), rtol=0, atol=Z_PORT)
    ref = ref_sharded.sharded_avi_solve(
        ref_mesh.make_mesh(world), *(p[k] for k in ("M", "q", "l", "u",
                                                    "z0", "mask")),
        tol=p["tol"])
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got["z"], np.asarray(ref.z), rtol=0,
                               atol=Z_JAX)


@pytest.mark.parametrize("world", [2, 4])
def test_avi_padded_sharding_pads_inert_lanes(ranks, world):
    p = _avi_problems(7, seed=3)
    got = _same_on_every_rank(ranks[world], "avi_padded")
    t = [torch.as_tensor(p[k]) for k in ("M", "q", "l", "u", "z0", "mask")]
    one = avi.solve_avi_batch_padded(*t, tol=p["tol"])
    assert got["z"].shape == (7, 6)
    for k in ("converged", "iters"):
        np.testing.assert_array_equal(got[k], getattr(one, k).numpy())
    np.testing.assert_allclose(got["z"], one.z.numpy(), rtol=0, atol=Z_PORT)
    ref = ref_avi.solve_avi_batch_padded(
        *(p[k] for k in ("M", "q", "l", "u", "z0", "mask")), tol=p["tol"],
        _sharding=ref_mesh.scenario_sharding(ref_mesh.make_mesh(world)),
        _min_batch=world)
    np.testing.assert_allclose(got["z"], np.asarray(ref.z), rtol=0,
                               atol=Z_JAX)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["qp_padded", "lp_padded"])
def test_qp_padded_sharding_matches_single_process(ranks, world, key):
    kw = _qp_problems() if key == "qp_padded" else dict(
        _qp_problems(seed=4, lp=True), _prefer_lemke=True)
    got = _same_on_every_rank(ranks[world], key)
    args = [kw.pop(k) for k in ("P", "q", "A", "l", "u", "mask")]
    one = batch_qp.solve_qp_batch_padded(*args, **kw)
    assert got["x"].shape == one.x.shape
    np.testing.assert_array_equal(got["status"], one.status)
    np.testing.assert_array_equal(got["iters"], one.iters)
    for f in ("x", "y", "obj"):
        np.testing.assert_allclose(got[f], getattr(one, f), rtol=0,
                                   atol=Z_PORT)
    ref = ref_qp.solve_qp_batch_padded(
        *args, _sharding=ref_mesh.scenario_sharding(
            ref_mesh.make_mesh(world)), _min_batch=world, **kw)
    np.testing.assert_array_equal(got["status"], np.asarray(ref.status))
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_containment_prune_deterministic(ranks, world):
    """One survivor per duplicate group, the lowest index, whatever the
    split; the JAX package's mask bit for bit."""
    keep = _same_on_every_rank(ranks[world], "prune8")
    assert keep.tolist() == [True, False, True, False, True, False, True,
                             False]
    ref = ref_sharded.sharded_containment_prune(
        ref_mesh.make_mesh(world), PRUNE8["act"], PRUNE8["resid"])
    np.testing.assert_array_equal(keep, np.asarray(ref))


@pytest.mark.parametrize("world", [2, 4])
def test_containment_prune_tiebreak_is_transitive(ranks, world):
    keep = _same_on_every_rank(ranks[world], "chain")
    assert keep.sum() == 1 and keep[0]
    ref = ref_sharded.sharded_containment_prune(
        ref_mesh.make_mesh(world), CHAIN["act"], CHAIN["resid"])
    np.testing.assert_array_equal(keep, np.asarray(ref))
    np.testing.assert_array_equal(
        keep, sharded.sharded_containment_prune(
            one_rank_mesh(), CHAIN["act"], CHAIN["resid"]).numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_equilibrium_superstep(ranks, world):
    got = _same_on_every_rank(ranks[world], "superstep")
    spec = dict(SUPERSTEP16)
    tol, max_iter = spec.pop("tol"), spec.pop("max_iter")
    batch = scenario_batch_gavis(**spec)
    one = sharded.equilibrium_superstep(one_rank_mesh(), batch, tol=tol,
                                        max_iter=max_iter)
    assert np.isfinite(got["z"]).all() and got["keep"].shape == (16,)
    np.testing.assert_array_equal(got["keep"], one["keep"].numpy())
    assert float(got["converged_frac"]) == float(one["converged_frac"])
    np.testing.assert_allclose(got["z"], one["z"].numpy(), rtol=0,
                               atol=Z_PORT)
    ref = ref_sharded.equilibrium_superstep(ref_mesh.make_mesh(world), batch,
                                            tol=tol, max_iter=max_iter)
    np.testing.assert_allclose(got["z"], np.asarray(ref["z"]), rtol=0,
                               atol=Z_JAX)
    np.testing.assert_array_equal(got["keep"], np.asarray(ref["keep"]))
    assert float(got["converged_frac"]) == float(ref["converged_frac"])


def test_equilibrium_superstep_routes_shared_at_trajectory_scale(ranks):
    """T=8, num_obj=4 (n=608): the superstep takes the shared-matrix route
    with the mesh; every lane certified, as in the single-process port (M
    is rank-deficient at T=8, so z is held to the port, not the JAX
    package)."""
    got = _same_on_every_rank(ranks[2], "shared_superstep")
    assert float(got["converged_frac"]) == 1.0
    assert got["shared_kkt_solves"] > 0
    assert got["keep"].shape == (16,)
    spec = dict(SHARED16)
    tol = spec.pop("tol")
    one = sharded.equilibrium_superstep(one_rank_mesh(),
                                        scenario_batch_gavis(**spec),
                                        tol=tol)
    np.testing.assert_array_equal(got["keep"], one["keep"].numpy())
    np.testing.assert_allclose(got["z"], one["z"].numpy(), rtol=0,
                               atol=Z_PORT)


def test_four_ranks_form_one_mesh(ranks):
    infos = [r["info"] for r in ranks[4]]
    assert [i["rank"] for i in infos] == [0, 1, 2, 3]
    for i in infos:
        assert i["shape"] == {"scenario": 2, "branch": 2}
        assert i["backend"] == "gloo" and i["device"] == "cpu"
        assert i["info"]["process_count"] == 4
        assert i["info"]["global_devices"] == 4
        assert i["jax"] == []
