"""The whole domain of each kernel: the instance its launcher picks from the
shape, and the host build of the instances for lanes past shared memory.

Each kernel has an instance whose working set lives in a block's shared
memory, and one for lanes that do not fit the block's opt-in limit (232448
bytes on an H100), whose large array stays in device memory: K1's tableau
(``csrc/lemke_lane.cuh``), K2's M (``csrc/eg_lane.cuh``), K3's A
(``csrc/screen_lane.cuh``).  Between the two, each kernel spreads a lane over
the shared memory of a cluster of 2-8 blocks (``lane_cluster_ranks``,
``eg_cluster_ranks``, ``screen_cluster_ranks``: the fewest ranks whose bands
fit; K2's cluster instance, which holds part of a band in its threads'
registers, the fewest whose rank fits its 320 threads and the limit, within
the same domain); past 8 ranks the device-memory instance takes the lane.  The choice is a pure function of
the shape and the limit, built here with g++ from the kernels' headers; the
tests pin its boundaries.  The g++ host instances run the lane code of the instance the
launcher picks, on a lane carved as that instance carves it; at the new
sizes they are held to the plain PyTorch versions with each file's
contract:

* K1 (robust_avoid lanes, n = 114, 152, 190; f32 at the hot route's
  tolerances, f64 at the re-pivot's): status and pivot counts identical,
  z after the f64 refactorization within 1e-10;
* K2 (n = 239, 304): z within 1e-5 of the lane scale after 300 steps (f32
  sums in another order), as ``test_torch_eg.py``;
* K3 (260 rows in dimension 240, the global instance forced; 520 rows in
  dimension 500): x within 1e-5 of its scale and max |v| within 1e-5
  relative, as ``test_torch_screen.py``.

Where the card holds a large array in device memory or in shared memory,
the sums are the same: both carvings give the same bits (K2's cluster
instance sums in its own partition).  K1's cluster instance spaces its band
rows so that its pass reads them without bank conflicts where the band
still fits (``lane_cluster_stride``).
"""

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, lemke_cuda, screen
from qpn_tpu_torch.ops import screen_cuda
from qpn_tpu_torch.ops.avi import natural_residual
from qpn_tpu_torch.utils.cuda_build import HOPPER_SMEM_OPTIN

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
Z_TOL = 1e-10
EG_RTOL = 1e-5
SCREEN_TOL = 1e-5
SCREEN_STEPS, SCREEN_LR = 120, 0.05
BIG_OPTIN = 1 << 40        # a limit every lane fits


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


# --- the choice of instance --------------------------------------------------

@pytest.mark.parametrize("itemsize,n,want", [
    (4, 38, lemke_cuda.LANE_SHARED), (4, 135, lemke_cuda.LANE_SHARED),
    (4, 136, lemke_cuda.LANE_CLUSTER), (8, 38, lemke_cuda.LANE_SHARED),
    (8, 94, lemke_cuda.LANE_SHARED), (8, 95, lemke_cuda.LANE_CLUSTER),
    (4, 374, lemke_cuda.LANE_CLUSTER), (4, 375, lemke_cuda.LANE_GLOBAL),
    (8, 257, lemke_cuda.LANE_CLUSTER), (8, 258, lemke_cuda.LANE_GLOBAL)],
    ids=["f32_38", "f32_135", "f32_136", "f64_38", "f64_94", "f64_95",
         "f32_374", "f32_375", "f64_257", "f64_258"])
def test_k1_instance_at_its_boundary(itemsize, n, want):
    assert lemke_cuda.host_lane_instance(n, itemsize,
                                         HOPPER_SMEM_OPTIN) == want
    fits = lemke_cuda.host_lane_bytes(n, itemsize) <= HOPPER_SMEM_OPTIN
    assert fits == (want == lemke_cuda.LANE_SHARED)
    # a lane of the global instance stays 16-byte aligned in the workspace
    assert lemke_cuda.host_lane_bytes(n, itemsize) % 16 == 0


# The cluster's ranks at their boundaries: the first n that needs R ranks
# and the last that fits them; 0 past 8 ranks.
@pytest.mark.parametrize("itemsize,n,ranks", [
    (4, 136, 2), (4, 190, 2), (4, 191, 3), (4, 232, 3), (4, 233, 4),
    (4, 350, 7), (4, 351, 8), (4, 374, 8), (4, 375, 0),
    (8, 95, 2), (8, 133, 2), (8, 134, 3), (8, 152, 3), (8, 244, 7),
    (8, 245, 8), (8, 257, 8), (8, 258, 0)])
def test_k1_cluster_ranks_at_their_boundaries(itemsize, n, ranks):
    assert lemke_cuda.host_cluster_ranks(n, itemsize,
                                         HOPPER_SMEM_OPTIN) == ranks
    if ranks:
        assert lemke_cuda.host_band_bytes(n, itemsize,
                                          ranks) <= HOPPER_SMEM_OPTIN
    if ranks != 2:
        fewer = 8 if ranks == 0 else ranks - 1
        assert lemke_cuda.host_band_bytes(n, itemsize,
                                          fewer) > HOPPER_SMEM_OPTIN
    # one rank's part of a lane is the whole lane at R = 1
    assert lemke_cuda.host_band_bytes(n, itemsize, 1) == \
        lemke_cuda.host_lane_bytes(n, itemsize)


def _conflict_free(ld, n, itemsize):
    """Whether the 32 entries a warp of K1's fused pass reads at once (one
    of each of 4 chunks of 8 rows ld apart) lie on different banks (f64:
    the 16 of each half-warp on different pairs)."""
    C = (3 * n + 1 + 3) // 4
    words = 32 if itemsize == 4 else 16
    slots = words // 4
    return all(len({(s * ld + g * C) % words for s in range(h, h + slots)
                    for g in range(4)}) == words
               for h in range(0, 8, slots))


@pytest.mark.parametrize("itemsize,n", [
    (4, 136), (4, 152), (4, 190), (4, 374), (8, 95), (8, 152), (8, 257)])
def test_k1_cluster_stride(itemsize, n):
    """The cluster instance's band rows lie at a stride of at least 3n+2
    at which the fused pass's reads meet no bank conflict where the band
    still fits the limit at the picked ranks (else at the odd stride, so the
    ranks stay lane_cluster_ranks'); a limit of 0 bytes keeps the odd
    stride."""
    ranks = lemke_cuda.host_cluster_ranks(n, itemsize, HOPPER_SMEM_OPTIN)
    odd = (3 * n + 2) | 1
    ld = lemke_cuda.host_cluster_stride(n, itemsize, ranks, HOPPER_SMEM_OPTIN)
    assert 3 * n + 2 <= ld < 3 * n + 2 + 64
    assert ld == odd or _conflict_free(ld, n, itemsize)
    # the shapes phase 20 times (f64 at n=95 fits only at the odd stride)
    if n in (136, 152, 190):
        assert _conflict_free(ld, n, itemsize)
    assert lemke_cuda.host_cluster_stride(n, itemsize, ranks, 0) == odd


@pytest.mark.parametrize("n,want", [
    (38, eg_cuda.EG_REGISTER), (128, eg_cuda.EG_REGISTER),
    (129, eg_cuda.EG_SHARED), (238, eg_cuda.EG_SHARED),
    (239, eg_cuda.EG_CLUSTER), (304, eg_cuda.EG_CLUSTER),
    (671, eg_cuda.EG_CLUSTER), (672, eg_cuda.EG_GLOBAL)])
def test_k2_instance_at_its_boundary(n, want):
    assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == want


# K2's cluster instance keeps its domain (n = 239-671 on an H100: some
# cluster of at most 8 blocks holds M's bands in shared memory), and takes
# the fewest ranks whose rank fits 320 threads (a group of 4 on every two
# rows: band rows up to 160) and, beside the part of the band its threads
# hold in registers, the limit.
@pytest.mark.parametrize("n,ranks", [
    (239, 2), (304, 2), (320, 2), (321, 3), (480, 3), (481, 4), (592, 4),
    (593, 5), (640, 5), (641, 6), (671, 6), (672, 0)])
def test_k2_cluster_ranks_at_their_boundaries(n, ranks):
    assert eg_cuda.host_cluster_ranks(n, HOPPER_SMEM_OPTIN) == ranks
    if not ranks:
        return
    nb = -(-n // ranks)
    assert nb <= 160
    assert eg_cuda.host_cluster_rank_bytes(n, ranks) <= HOPPER_SMEM_OPTIN
    if ranks > 2:
        fewer = -(-n // (ranks - 1))
        assert fewer > 160 or eg_cuda.host_cluster_rank_bytes(
            n, ranks - 1) > HOPPER_SMEM_OPTIN


def test_k2_cluster_domain_is_kept():
    """Every n of 239-671 takes the cluster instance on an H100 (its domain
    before the instance held part of M in registers), with ranks; 238 the
    block instance, 672 the global one."""
    for n in range(239, 672):
        assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == \
            eg_cuda.EG_CLUSTER, n
        assert eg_cuda.host_cluster_reach(n, HOPPER_SMEM_OPTIN), n
        assert 2 <= eg_cuda.host_cluster_ranks(n, HOPPER_SMEM_OPTIN) <= 8, n
        # a thread's registers hold the first 60 entries of its chunk
        assert eg_cuda.host_cluster_chunk(n) >= 60, n
    assert eg_cuda.host_instance(238, HOPPER_SMEM_OPTIN) == eg_cuda.EG_SHARED
    assert eg_cuda.host_instance(672, HOPPER_SMEM_OPTIN) == eg_cuda.EG_GLOBAL
    assert not eg_cuda.host_cluster_reach(672, HOPPER_SMEM_OPTIN)
    assert eg_cuda.host_cluster_chunk(304) == 76
    assert eg_cuda.host_cluster_chunk(241) == 64


def test_k2_block_instance_takes_its_whole_domain():
    """Every n of 129-238 takes the block instance on an H100, and its
    launch fits one block there: the chunk is one the launcher instantiates
    (36-60 columns), its threads (a group of four on every three rows while
    the registers hold whole chunks of up to 48 columns, on every two rows
    past that) within the instance's launch bound (the threads of n = 4 ·
    chunk) and 1024, and its shared memory (z, z½ and the entries past the
    48 in registers) within the limit.  Up to n = 192 the registers hold
    all of M.  Under any limit, a lane whose chunk passes 60 columns takes
    another instance."""
    for n in range(129, 239):
        assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == \
            eg_cuda.EG_SHARED, n
        C = eg_cuda.host_cluster_chunk(n)
        assert C in range(36, 61, 4), n
        rows = 3 if C <= 48 else 2
        threads = eg_cuda.host_block_threads(n)
        assert threads == -(-(-(-n // rows) * 4) // 32) * 32, n
        assert threads <= eg_cuda.host_block_threads(4 * C) <= 1024, n
        zs = 2 * 4 * (C | 4) * 4
        assert eg_cuda.host_block_bytes(n) == zs + (
            threads * rows * (C - 48) * 4 if C > 48 else 0), n
        assert eg_cuda.host_block_bytes(n) <= HOPPER_SMEM_OPTIN, n
    assert eg_cuda.host_cluster_chunk(192) == 48
    assert eg_cuda.host_block_threads(190) == 256
    assert eg_cuda.host_block_threads(238) == 480
    # under any limit, no lane whose chunk the launcher does not instantiate
    assert eg_cuda.host_instance(240, BIG_OPTIN) == eg_cuda.EG_SHARED
    assert eg_cuda.host_instance(241, BIG_OPTIN) == eg_cuda.EG_CLUSTER


# The global instance's ranks: the card's resident blocks (an H100's 132,
# one an SM) shared among the batch's lanes, at most 8 for K1 and n; R = 1
# where B alone fills the card, where a rank's own part does not fit the
# limit (K1 f64 past n = 2323, f32 past 4468), where the card holds nothing
# or the limit is unknown.
@pytest.mark.parametrize("itemsize,n,lanes,resident,optin,ranks", [
    (8, 304, 16, 132, HOPPER_SMEM_OPTIN, 8),
    (8, 304, 17, 132, HOPPER_SMEM_OPTIN, 7),
    (8, 304, 33, 132, HOPPER_SMEM_OPTIN, 4),
    (8, 304, 66, 132, HOPPER_SMEM_OPTIN, 2),
    (8, 304, 67, 132, HOPPER_SMEM_OPTIN, 1),
    (8, 304, 1, 132, HOPPER_SMEM_OPTIN, 8),
    (4, 375, 256, 132, HOPPER_SMEM_OPTIN, 1),
    (8, 3, 1, 132, HOPPER_SMEM_OPTIN, 3),
    (8, 2323, 1, 132, HOPPER_SMEM_OPTIN, 8),
    (8, 2324, 1, 132, HOPPER_SMEM_OPTIN, 1),
    (4, 4468, 1, 132, HOPPER_SMEM_OPTIN, 8),
    (4, 4469, 1, 132, HOPPER_SMEM_OPTIN, 1),
    (8, 304, 16, 0, HOPPER_SMEM_OPTIN, 1),
    (8, 304, 16, 132, -1, 1),
    (8, 304, 0, 132, HOPPER_SMEM_OPTIN, 1)],
    ids=["f64_B16", "f64_B17", "f64_B33", "f64_B66", "f64_B67_fills",
         "f64_B1_cap", "f32_B256_fills", "f64_n3", "f64_own_fits",
         "f64_own_past", "f32_own_fits", "f32_own_past", "no_resident",
         "unknown_limit", "no_lanes"])
def test_k1_global_ranks_at_their_boundaries(itemsize, n, lanes, resident,
                                             optin, ranks):
    assert lemke_cuda.host_global_ranks(n, itemsize, lanes, resident,
                                        optin) == ranks
    if ranks > 1:
        assert lanes * ranks <= resident
        assert lemke_cuda.host_spread_own_bytes(n, itemsize) <= optin
    # the workspace: the whole lane at R = 1, else R bands, each 16-byte
    # aligned
    ws = lemke_cuda.host_global_lane_bytes(n, itemsize, ranks)
    if ranks == 1:
        assert ws == lemke_cuda.host_lane_bytes(n, itemsize)
    assert ws % (16 * ranks) == 0


# K2: the fewest ranks whose band of M fits the limit where B lanes of them
# fit the card (n = 684: 9 ranks up to 14 lanes), else resident / B ranks
# reading their bands in place; R = 1 where B alone fills the card.
@pytest.mark.parametrize("n,lanes,resident,optin,ranks,band", [
    (684, 4, 132, HOPPER_SMEM_OPTIN, 9, True),
    (684, 14, 132, HOPPER_SMEM_OPTIN, 9, True),
    (684, 15, 132, HOPPER_SMEM_OPTIN, 8, False),
    (684, 66, 132, HOPPER_SMEM_OPTIN, 2, False),
    (684, 67, 132, HOPPER_SMEM_OPTIN, 1, False),
    (672, 1, 132, HOPPER_SMEM_OPTIN, 9, True),
    (711, 14, 132, HOPPER_SMEM_OPTIN, 9, True),
    (712, 14, 132, HOPPER_SMEM_OPTIN, 9, False),
    (712, 13, 132, HOPPER_SMEM_OPTIN, 10, True),
    (2000, 4, 132, HOPPER_SMEM_OPTIN, 33, False),
    (684, 4, 0, HOPPER_SMEM_OPTIN, 1, False),
    (684, 4, 132, -1, 1, False),
    (684, 0, 132, HOPPER_SMEM_OPTIN, 1, False)],
    ids=["n684_B4", "n684_B14", "n684_B15_in_place", "n684_B66",
         "n684_B67_fills", "n672_B1", "n711_B14", "n712_B14_in_place",
         "n712_B13", "n2000_B4_in_place", "no_resident", "unknown_limit",
         "no_lanes"])
def test_k2_global_ranks_at_their_boundaries(n, lanes, resident, optin,
                                             ranks, band):
    assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == eg_cuda.EG_GLOBAL
    assert eg_cuda.host_global_ranks(n, lanes, resident, optin) == ranks
    assert eg_cuda.host_global_band_fits(n, ranks, optin) == band
    if band:
        # the fewest ranks whose band fits
        assert eg_cuda.host_band_bytes(n, ranks) <= optin
        assert eg_cuda.host_band_bytes(n, ranks - 1) > optin
    if ranks > 1:
        assert lanes * ranks <= resident


@pytest.mark.parametrize("n,ranks,optin,fits", [
    (684, 1, 1 << 40, False), (684, 8, HOPPER_SMEM_OPTIN, False),
    (684, 9, HOPPER_SMEM_OPTIN, True), (711, 9, HOPPER_SMEM_OPTIN, True),
    (712, 9, HOPPER_SMEM_OPTIN, False), (130, 9, 0, False),
    (684, 33, -1, False)],
    ids=["R1_in_place", "n684_R8", "n684_R9", "n711_R9", "n712_R9",
         "no_limit", "unknown_limit"])
def test_k2_global_band_switch(n, ranks, optin, fits):
    """A global rank's band of M sits in its shared memory exactly where it
    fits the limit and the lane is spread; at R = 1 M is read in place."""
    assert eg_cuda.host_global_band_fits(n, ranks, optin) == fits


@pytest.mark.parametrize("m,n,want", [
    (18, 18, screen_cuda.SCREEN_WARP), (32, 32, screen_cuda.SCREEN_WARP),
    (33, 33, screen_cuda.SCREEN_SHARED), (238, 238, screen_cuda.SCREEN_SHARED),
    (239, 239, screen_cuda.SCREEN_CLUSTER),
    (260, 240, screen_cuda.SCREEN_CLUSTER),
    (473, 473, screen_cuda.SCREEN_CLUSTER),
    (474, 474, screen_cuda.SCREEN_GLOBAL),
    (937, 240, screen_cuda.SCREEN_CLUSTER),
    (938, 240, screen_cuda.SCREEN_GLOBAL)])
def test_k3_instance_at_its_boundary(m, n, want):
    """K3's shared instance up to m = n = 238 on an H100, then its cluster
    instance while some cluster of at most 8 blocks holds A twice (m = n up
    to 473; 937 rows in dimension 240), then the global instance."""
    assert screen_cuda.host_instance(m, n, HOPPER_SMEM_OPTIN) == want


@pytest.mark.parametrize("m,n,ranks", [
    (237, 240, 2), (238, 240, 3), (239, 239, 3), (260, 240, 3),
    (813, 240, 7), (814, 240, 8), (473, 473, 8), (474, 474, 0)])
def test_k3_cluster_ranks_at_their_boundaries(m, n, ranks):
    """The fewest ranks whose row and column bands fit the limit (R = 2 only
    where one block nearly fits: A is on chip twice), 0 past 8."""
    assert screen_cuda.host_cluster_ranks(m, n, HOPPER_SMEM_OPTIN) == ranks


def test_k3_cluster_bytes():
    """A rank's part at 260 rows in dimension 240: x, v, the row band (87
    rows at the odd stride 241), the column band (80 columns of 260 rows
    at the odd stride 261), in 16-byte units, then its l and u and 96
    partial maxima: 170472 bytes at R = 3, 254288 at R = 2 (past an H100's
    232448)."""
    assert screen_cuda.host_cluster_bytes(260, 240, 3) == 4 * (
        240 + 260 + 20968 + 20880 + 2 * 87 + 96)
    assert screen_cuda.host_cluster_bytes(260, 240, 3) == 170472
    assert screen_cuda.host_cluster_bytes(260, 240, 2) == 254288


def test_a_failed_limit_query_picks_the_global_instances():
    """A negative limit (minus a CUDA error) fits nothing."""
    assert lemke_cuda.host_lane_instance(38, 4, -1) == lemke_cuda.LANE_GLOBAL
    assert eg_cuda.host_instance(130, -1) == eg_cuda.EG_GLOBAL
    assert screen_cuda.host_instance(40, 40, -1) == screen_cuda.SCREEN_GLOBAL
    assert screen_cuda.host_instance(260, 240, -1) == (
        screen_cuda.SCREEN_GLOBAL)
    assert screen_cuda.host_cluster_ranks(260, 240, -1) == 0


# --- K1: lanes past shared memory --------------------------------------------

@pytest.mark.parametrize("dtype,kw", [(torch.float32, HOT),
                                      (torch.float64, F64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("T,n", [(3, 114), (4, 152), (5, 190)],
                         ids=["n114", "n152", "n190"])
def test_k1_host_instance_matches_plain_loop_midsize(T, n, dtype, kw):
    b = scenario_batch_gavis(num_scenarios=8, T=T, num_obj=2,
                             num_poly_faces=4, seed=0)
    M, q, l, u, z0 = (torch.as_tensor(b[k]) for k in
                      ("M", "q", "l", "u", "z0"))
    vm = torch.as_tensor(b["mask"])
    assert q.shape == (8, n)
    init = lemke.lemke_setup(M.to(dtype), q.to(dtype), l.to(dtype),
                             u.to(dtype), z0.to(dtype), vm, tol=kw["tol"])
    host = lemke_cuda.lemke_pivot_host(init, **kw)
    plain = lemke.lemke_pivot_torch(init, **kw)
    assert torch.equal(host.status, plain.status)
    assert torch.equal(host.piv, plain.piv)
    assert (host.status == lemke.LEMKE_SUCCESS).all()
    zs = []
    for res in (host, plain):
        z, ok = lemke.refactor_batch(M, q, l, u, res.basis, res.val, vm)
        assert bool(ok.all())
        assert float(natural_residual(M, q, l, u, z, vm).max()) <= 1e-9
        zs.append(z)
    assert float((zs[0] - zs[1]).abs().max()) <= Z_TOL


# --- K2: M read in place ------------------------------------------------------

def _box_avi(n, seed, B=4):
    """Seeded monotone box AVIs (``test_torch_eg.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    return eg.eg_prepare(*(torch.as_tensor(a) for a in
                           (M, q, l, u, np.zeros((B, n)))),
                         torch.ones(B, n, dtype=torch.bool))


@pytest.mark.parametrize("steps", [0, 1, 300])
@pytest.mark.parametrize("n", [239, 304])
def test_k2_global_instance_matches_plain_loop(n, steps):
    """M read in place, as the global instance reads it (a limit of 0
    bytes picks it; at an H100's these n take the cluster instance)."""
    p = _box_avi(n, seed=n)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    assert eg_cuda.host_instance(n, 0) == eg_cuda.EG_GLOBAL
    zh = eg_cuda.eg_steps_host(*ins, steps, optin=0)
    zp = eg.eg_steps_torch(*ins, steps)
    if steps == 0:
        assert torch.equal(zh, p.z0)
    scale = 1.0 + float(zp.abs().max())
    assert float((zh - zp).abs().max()) <= EG_RTOL * scale


def test_k2_global_and_shared_carvings_give_the_same_bits():
    """The block instance and the cluster instance sum in one partition,
    four chunks a row: each gives exactly the bits of one rank in that
    partition.  Under a limit every lane fits, the block instance takes the
    lanes whose chunk the launcher instantiates (n = 240, chunk 60) and no
    wider ones (n = 304, chunk 76, takes the cluster instance), as on the
    card.  M read in place by the global instance (a limit of 0 bytes) sums
    a row in one chunk: within 1e-5 of the lane scale of the others after
    50 steps."""
    for n, big in ((240, eg_cuda.EG_SHARED), (304, eg_cuda.EG_CLUSTER)):
        p = _box_avi(n, seed=3, B=2)
        ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
        assert eg_cuda.host_instance(n, 0) == eg_cuda.EG_GLOBAL
        assert eg_cuda.host_instance(n, BIG_OPTIN) == big
        assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == \
            eg_cuda.EG_CLUSTER
        z = eg_cuda.eg_steps_host(*ins, 50, optin=0)
        zc = eg_cuda.eg_steps_host(*ins, 50)
        one = eg_cuda.eg_steps_host(*ins, 50, ranks=1)
        assert torch.equal(zc, one), n
        assert torch.equal(eg_cuda.eg_steps_host(*ins, 50, optin=BIG_OPTIN),
                           one), n
        scale = 1.0 + float(z.abs().max())
        assert float((zc - z).abs().max()) <= EG_RTOL * scale, n


# --- K3: A in device memory ----------------------------------------------------

def _polys(B, m, n, seed, centre=0.1):
    """Seeded polyhedra without strict rows around a centre of scale
    ``centre``, every odd one empty by two rows with one normal and bounds 2
    apart; returns (polys, empty truth)."""
    from qpn_tpu_torch.geometry import Poly
    rng = np.random.default_rng(seed)
    polys, truth = [], np.zeros(B, dtype=bool)
    for b in range(B):
        A = rng.standard_normal((m, n))
        ax = A @ (centre * rng.standard_normal(n))
        w = 0.5 + rng.random(m)
        l, u = ax - w, ax + w
        u[2] = np.inf
        if b % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, np.inf
            l[1], u[1] = -np.inf, ax[0] - 1.0
            truth[b] = True
        polys.append(Poly(A, l, u, normalize=False, dedupe=False))
    return polys, truth


def _k3_global_against_plain_loop(B, m, n, seed, optin):
    """The global instance's host build under the opt-in limit ``optin`` on
    seeded polyhedra: within 1e-5 of the plain loop, and the bits of the
    shared instance's carving."""
    polys, _ = _polys(B, m, n, seed=seed)
    ins = [torch.as_tensor(a) for a in screen.screen_prepare(polys)]
    assert ins[0].shape == (B, m, n)
    assert screen_cuda.host_instance(m, n, optin) == screen_cuda.SCREEN_GLOBAL
    xh, vh = screen_cuda.screen_steps_host(*ins, SCREEN_STEPS, SCREEN_LR,
                                           optin=optin)
    xp, vp = screen.screen_steps_torch(*ins, SCREEN_STEPS, SCREEN_LR)
    assert bool(torch.isfinite(xh).all()) and bool(torch.isfinite(vh).all())
    xerr = (xh - xp).abs().amax(1) / (1.0 + xp.abs().amax(1))
    assert float(xerr.max()) <= SCREEN_TOL
    assert float(((vh - vp).abs() / (1.0 + vp)).max()) <= SCREEN_TOL
    # A read in place and from its column-major copy, or copied as the
    # shared instance copies it: same bits
    xs, vs = screen_cuda.screen_steps_host(*ins, SCREEN_STEPS, SCREEN_LR,
                                           generic=True)
    assert torch.equal(xh, xs) and torch.equal(vh, vs)


def test_k3_global_instance_matches_plain_loop():
    """At 260 rows in dimension 240, which an H100 sends to the cluster
    instance, with the global instance forced (a limit of 0 bytes)."""
    _k3_global_against_plain_loop(4, 260, 240, seed=0, optin=0)


def test_k3_global_instance_past_the_cluster_reach():
    """At 520 rows in dimension 500, past a cluster of 8 blocks on an H100:
    the global instance picked at its limit, on 2 polyhedra."""
    _k3_global_against_plain_loop(2, 520, 500, seed=5,
                                  optin=HOPPER_SMEM_OPTIN)


def test_k3_global_instance_verdicts_on_the_cpu(monkeypatch):
    """is_empty_batch with the screen on and the host build of the global
    instance as the screen's engine (an opt-in limit of 0 bytes sends
    polyhedra of 40 rows in dimension 36 there): the nonempty polyhedra,
    centred on the origin, are witnessed; every verdict is the truth."""
    from qpn_tpu_torch.geometry import is_empty_batch
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.utils.metrics import METRICS
    polys, truth = _polys(4, 40, 36, seed=1, centre=0.0)
    assert screen_cuda.host_instance(40, 36, 0) == screen_cuda.SCREEN_GLOBAL
    calls = []

    def host_engine(A, l, u, x0, steps, lr):
        calls.append(tuple(A.shape))
        return screen_cuda.screen_steps_host(A, l, u, x0, steps, lr, optin=0)

    monkeypatch.setattr(CONFIG, "use_screen", True)
    monkeypatch.setattr(screen, "screen_engine", lambda device: host_engine)
    CACHE.clear()
    METRICS.reset()
    np.testing.assert_array_equal(is_empty_batch(polys), truth)
    CACHE.clear()
    assert calls == [(4, 40, 36)]
    assert METRICS.counters["screen_witnessed"] == 2
