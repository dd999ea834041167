"""The port's ring-rotated prune and duplicate mask
(``qpn_tpu_torch/parallel/ring.py``) and the collective dedup of
``geometry/setops.remove_subsets`` on the CPU over gloo, with 2 and 4 ranks,
against the all-gather prune, a numpy set test, the host dedup and the JAX
package's ring functions on the 8-device virtual CPU mesh (the ring half of
``tests/test_banded_ring.py``).  Keep masks and duplicate masks are integer
logic and must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

from qpn_tpu.parallel import mesh as ref_mesh
from qpn_tpu.parallel import ring as ref_ring

import _torch_dist_worker as worker
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.entry import RING_PIECES, ring_pieces
from qpn_tpu_torch.geometry import setops
from qpn_tpu_torch.parallel import launch, mesh, ring

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 400.0
DEDUP_N = 1024 + 6          # not a multiple of 4: the filler lanes pad it


def _prune_input():
    rng = np.random.default_rng(3)
    B, k = 64, 5
    act = rng.integers(0, 3, size=(B, k)).astype(np.int32)
    act[1] = act[0]                    # exact duplicate group
    act[10] = act[0]
    resid = rng.random(B)
    resid[1] = resid[0]                # tie inside the group: index breaks
    return dict(act=act, resid=resid)


def _dup_input():
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 5, size=(16, 3)).astype(np.int32)
    # candidates: half are copies of reference rows, half fresh
    cand = np.concatenate([ref[::2], 99 + np.arange(24).reshape(8, 3)
                           .astype(np.int32)])
    return dict(sig=cand, ref=ref)


def _random_dup_input():
    rng = np.random.default_rng(1)
    return dict(sig=rng.integers(0, 3, size=(32, 2)).astype(np.int32),
                ref=rng.integers(0, 3, size=(8, 2)).astype(np.int32))


def _cases():
    return [("ring_prune", "ring_prune", _prune_input()),
            ("gather_prune", "prune", _prune_input()),
            ("dup", "ring_dup", _dup_input()),
            ("dup_random", "ring_dup", _random_dup_input()),
            ("dedup", "dedup", dict(n=DEDUP_N))]


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
    """The ring cases at 2 and 4 ranks; the 8256-piece remove_subsets at
    2."""
    return {2: _spawn(2, _cases() + [
                ("remove_subsets", "remove_subsets", dict(n=RING_PIECES)),
                ("dedup_in_broker", "dedup_in_broker", dict(n=DEDUP_N))]),
            4: _spawn(4, _cases())}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _all_ranks(results, key):
    first = results[0][key]
    for r in results[1:]:
        if isinstance(first, dict):
            for k, v in first.items():
                assert r[key][k] == v if not isinstance(v, np.ndarray) \
                    else np.array_equal(r[key][k], v)
        else:
            np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("world", [2, 4])
def test_ring_prune_matches_all_gather_prune_and_jax(ranks, world):
    keep_ring = _all_ranks(ranks[world], "ring_prune")
    keep_ag = _all_ranks(ranks[world], "gather_prune")
    np.testing.assert_array_equal(keep_ring, keep_ag)
    assert keep_ring[[0, 1, 10]].sum() == 1
    p = _prune_input()
    ref = ref_ring.ring_containment_prune(ref_mesh.make_mesh(world),
                                          p["act"], p["resid"])
    np.testing.assert_array_equal(keep_ring, np.asarray(ref))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["dup", "dup_random"])
def test_ring_duplicate_mask(ranks, world, key):
    hit = _all_ranks(ranks[world], key)
    d = _dup_input() if key == "dup" else _random_dup_input()
    refset = {r.tobytes() for r in d["ref"]}
    want = np.array([r.tobytes() in refset for r in d["sig"]])
    np.testing.assert_array_equal(hit, want)
    ref = ref_ring.ring_duplicate_mask(ref_mesh.make_mesh(world), d["sig"],
                                       d["ref"])
    np.testing.assert_array_equal(hit, np.asarray(ref))
    if key == "dup":
        assert hit[:8].all() and not hit[8:].any()


@pytest.mark.parametrize("world", [2, 4])
def test_dedup_signatures_collective_matches_host_loop(ranks, world):
    """Above one rank the dedup is collective (filler lanes pad the pieces
    to a multiple of the ranks); its survivors are the host loop's, the last
    of each duplicate group."""
    got = _all_ranks(ranks[world], "dedup")
    pu = ring_pieces(DEDUP_N)
    ids = {id(p): i for i, p in enumerate(pu.polys)}
    host = [ids[id(p)] for p in setops._dedup_signatures(pu).polys]
    np.testing.assert_array_equal(got["kept"], host)
    assert len(host) == DEDUP_N - DEDUP_N // 4
    assert got["counters"]["prune_dedup_sharded"] == DEDUP_N
    assert "prune_dedup_host" not in got["counters"]


def test_dedup_from_a_lockstep_thread_runs_the_host_loop(ranks):
    """Scenario threads would meet the other ranks' collectives in thread
    order, so under a broker the dedup stays on the host: same survivors."""
    got = _all_ranks(ranks[2], "dedup_in_broker")
    np.testing.assert_array_equal(got["kept"],
                                  _all_ranks(ranks[2], "dedup")["kept"])
    assert got["counters"]["prune_dedup_host"] == DEDUP_N
    assert "prune_dedup_sharded" not in got["counters"]


def test_remove_subsets_ring_regime_across_two_ranks(ranks):
    """8192+64 pieces through the production dedup entry across 2 ranks:
    the ring prune fires, n − n//4 pieces survive, and they are the set the
    JAX package's dry run expects (each box once)."""
    got = _all_ranks(ranks[2], "remove_subsets")
    assert got["n"] == RING_PIECES - RING_PIECES // 4
    assert got["counters"]["ring_prune_waves"] >= 1
    assert got["counters"]["prune_dedup_sharded"] == RING_PIECES
    pu = ring_pieces(RING_PIECES)
    want = sorted({setops.piece_signature(p).tobytes() for p in pu.polys})
    assert got["sigs"] == want


def test_ring_rejects_more_than_two_axes():
    m = mesh.Mesh(shape={"a": 2, "b": 2, "c": 2}, rank=0,
                  device=torch.device("cpu"), backend="gloo")
    d = _dup_input()
    with pytest.raises(ValueError, match="1-D and 2-D"):
        ring.ring_duplicate_mask(m, d["sig"], d["ref"])
    p = _prune_input()
    with pytest.raises(ValueError, match="1-D and 2-D"):
        ring.ring_containment_prune(m, p["act"], p["resid"])


def test_ring_at_one_rank_is_the_identity_rotation():
    """A one-rank mesh sweeps its own block once and sends nothing."""
    m = mesh.Mesh(shape={"scenario": 1, "branch": 1}, rank=0,
                  device=torch.device("cpu"), backend="gloo")
    t = torch.arange(6).reshape(3, 2)
    assert mesh.rotate(m, t) is t
    d = _dup_input()
    hit = ring.ring_duplicate_mask(m, d["sig"], d["ref"]).numpy()
    assert hit[:8].all() and not hit[8:].any()
    p = _prune_input()
    from qpn_tpu_torch.parallel.sharded import sharded_containment_prune
    np.testing.assert_array_equal(
        ring.ring_containment_prune(m, p["act"], p["resid"]).numpy(),
        sharded_containment_prune(m, p["act"], p["resid"]).numpy())


def test_ring_rejects_rows_that_do_not_split():
    m = mesh.Mesh(shape={"scenario": 1, "branch": 2}, rank=0,
                  device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="equal blocks"):
        ring.ring_duplicate_mask(m, np.zeros((3, 2), np.int32),
                                 np.zeros((4, 2), np.int32))
