"""The spread global-memory instances of K1 (``csrc/lemke_lane.cuh``) and K2
(``csrc/eg_lane.cuh``), through their host emulation.

Past a cluster's reach the global instances spread a lane over R blocks on
any SMs where the batch leaves SMs idle: rank k holds a band of the lane's
rows (K1: its band of the tableau in the device-memory workspace at a fixed
stride from its peers', its scalars and column-length vectors in its own
shared memory; K2: its band of M in its shared memory where it fits, else
read in place, the lane's z and z½ exchanged through device memory), and
the ranks meet at a barrier of their own in device memory.  The g++ host
build carves the ranks as the card's blocks are carved and runs each phase
for rank 0, 1, ..., R-1 in turn between the points where the card's ranks
meet.  No sum changes order, so the emulation at any R gives the bits of
R = 1 (today's global instance: one block a lane): status, pivots, basis,
nonbasic and basic values for K1, z for K2.  At R = 8, K1 also lands where
the JAX package's KKT solve does on the same numpy inputs.

The global instance is forced with a limit of shared memory that no lane
fits (``optin=0``, M read in place for K2), or, where a rank's own part
must fit (K1's pick) or K2's band should, a limit just that large; lanes
are small (K1: robust_avoid n = 38, 57; K2: n = 130) with one case at
(g)'s width, K1 f64 at n = 304 on 4 lanes (its 16 lanes take about 23 s
of one CPU core; the GPU tests run all 16).
"""

import functools

import numpy as np
import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, lemke_cuda
from qpn_tpu_torch.utils.cuda_build import (HOPPER_RESIDENT_BLOCKS,
                                            HOPPER_SMEM_OPTIN)

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
JAX_Z_TOL = 1e-8
PICKED = None              # the ranks the launcher picks for the batch
K1_LANES = 24              # an H100 picks 132 // 24 = 5 ranks a lane
K2_N, K2_LANES = 130, 3    # the smallest generic rows; 44 ranks in place


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@functools.lru_cache(maxsize=None)
def _ensemble(S, T, num_obj):
    return scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                                num_poly_faces=4, seed=0)


def _k1_init(S, T, num_obj, dtype, kw):
    b = _ensemble(S, T, num_obj)
    M, q, l, u = (torch.as_tensor(b[k]).to(dtype) for k in ("M", "q", "l",
                                                            "u"))
    return lemke.lemke_setup(M, q, l, u, torch.zeros_like(q),
                             torch.as_tensor(b["mask"]), tol=kw["tol"])


def _equal(spread, one):
    for name in one._fields:
        assert torch.equal(getattr(spread, name), getattr(one, name)), name


# --- K1 ---------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 3, 8, PICKED],
                         ids=["R2", "R3", "R8", "picked"])
@pytest.mark.parametrize("dtype,kw", [(torch.float32, HOT),
                                      (torch.float64, F64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("T,num_obj,n", [(2, 1, 38), (3, 1, 57)],
                         ids=["n38", "n57"])
def test_k1_spread_emulation_gives_the_one_block_bits(T, num_obj, n, dtype,
                                                      kw, ranks):
    init = _k1_init(K1_LANES, T, num_obj, dtype, kw)
    itemsize = init.T.element_size()
    assert init.T.shape[1] == n
    # the smallest limit a rank's own part fits: the global instance, and
    # the pick spreads it
    optin = lemke_cuda.host_spread_own_bytes(n, itemsize)
    assert lemke_cuda.host_lane_instance(n, itemsize, optin) == \
        lemke_cuda.LANE_GLOBAL
    assert lemke_cuda.host_global_ranks(
        n, itemsize, K1_LANES, HOPPER_RESIDENT_BLOCKS, optin) == 5
    one = lemke_cuda.lemke_pivot_host(init, optin=optin, ranks=1, **kw)
    spread = lemke_cuda.lemke_pivot_host(init, optin=optin, ranks=ranks,
                                         **kw)
    assert (one.status == lemke.LEMKE_SUCCESS).all()
    _equal(spread, one)


def test_k1_spread_emulation_at_the_stragglers_width():
    """(g)'s shape: f64 lanes of n = 304 (robust_avoid T=8, num_obj=2) at
    the ranks an H100 picks for its 16 stragglers, on 4 of them."""
    init = _k1_init(4, 8, 2, torch.float64, F64)
    n = init.T.shape[1]
    assert n == 304
    assert lemke_cuda.host_lane_instance(n, 8, HOPPER_SMEM_OPTIN) == \
        lemke_cuda.LANE_GLOBAL
    ranks = lemke_cuda.host_global_ranks(n, 8, 16, HOPPER_RESIDENT_BLOCKS,
                                         HOPPER_SMEM_OPTIN)
    assert ranks == 8
    one = lemke_cuda.lemke_pivot_host(init, ranks=1, **F64)
    assert (one.status == lemke.LEMKE_SUCCESS).all()
    _equal(lemke_cuda.lemke_pivot_host(init, ranks=ranks, **F64), one)


def test_k1_spread_emulation_matches_the_jax_package():
    """The f32 pivot path of the KKT route (``avi.solve_kkt_avi_batch``'s
    setup, tolerances and pivot budget) spread over 8 ranks as the global
    instance spreads it, then the f64 refactorization, against the JAX
    package's KKT solve at S=8, n=57: status and pivot counts lane for
    lane, z within 1e-8 (bases are never compared)."""
    from qpn_tpu.ops import avi as ref_avi
    b = _ensemble(8, 3, 1)
    ref = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                      b["mask"], b["structure"], tol=1e-8)
    M, q, l, u = (torch.as_tensor(b[k]) for k in ("M", "q", "l", "u"))
    vm = torch.as_tensor(b["mask"])
    B, n = q.shape
    assert n == 57
    max_pivots = 256
    while max_pivots < min(4096, 16 * n + 256):
        max_pivots *= 2
    f32 = torch.float32
    pivot = functools.partial(lemke_cuda.lemke_pivot_host, optin=0, ranks=8)
    _, status, piv, basis, val = lemke.solve_lemke_batch_state(
        M.to(f32), q.to(f32), l.to(f32), u.to(f32),
        torch.zeros(B, n, dtype=f32), vm, pivot=pivot, tol=1e-6,
        piv_tol=1e-5, max_pivots=max_pivots)
    z, ok = lemke.refactor_batch(M, q, l, u, basis, val, vm)
    assert bool(np.all(np.asarray(ref.converged)))
    assert (status == lemke.LEMKE_SUCCESS).all() and bool(ok.all())
    np.testing.assert_array_equal(piv.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=JAX_Z_TOL)


# --- K2 ---------------------------------------------------------------------

def _box_avi(n, B, seed):
    """Seeded monotone box AVIs (``test_torch_eg.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.where(rng.random((B, n)) < 0.5, 0.0, -np.inf)
    u = np.where(rng.random((B, n)) < 0.3, 1.0, np.inf)
    p = eg.eg_prepare(*(torch.as_tensor(a) for a in
                        (M, q, l, u, np.zeros((B, n)))),
                      torch.ones(B, n, dtype=torch.bool))
    return (p.M, p.q, p.l, p.u, p.z0, p.tau)


# in place: a limit of 0 bytes, no band fits (R2, R3, R8 and the pick's 44
# ranks); in shared memory: the limit of a band at 9 ranks (9, 12 and the
# pick's 9 ranks)
K2_CARVINGS = [("in_place", 2), ("in_place", 3), ("in_place", 8),
               ("in_place", PICKED), ("band", 9), ("band", 12),
               ("band", PICKED)]


@pytest.mark.parametrize("steps", [0, 1, 300])
@pytest.mark.parametrize("carving,ranks", K2_CARVINGS,
                         ids=["in_place_R2", "in_place_R3", "in_place_R8",
                              "in_place_picked", "band_R9", "band_R12",
                              "band_picked"])
def test_k2_spread_emulation_gives_the_one_block_bits(carving, ranks, steps):
    ins = _box_avi(K2_N, K2_LANES, seed=K2_N)
    optin = 0 if carving == "in_place" else eg_cuda.host_band_bytes(K2_N, 9)
    assert eg_cuda.host_instance(K2_N, optin) == eg_cuda.EG_GLOBAL
    picked = eg_cuda.host_global_ranks(K2_N, K2_LANES,
                                       HOPPER_RESIDENT_BLOCKS, optin)
    assert picked == (44 if carving == "in_place" else 9)
    R = picked if ranks is PICKED else ranks
    assert eg_cuda.host_global_band_fits(K2_N, R, optin) == (carving == "band")
    one = eg_cuda.eg_steps_host(*ins, steps, optin=optin, ranks=1)
    assert bool(torch.isfinite(one).all())
    if steps == 0:
        assert torch.equal(one, ins[4])
    assert torch.equal(eg_cuda.eg_steps_host(*ins, steps, optin=optin,
                                             ranks=ranks), one)


@pytest.mark.parametrize("steps", [0, 1, 300])
def test_k2_column_major_copy_gives_the_shared_instance_bits(steps):
    """One block a lane of the global instance (a limit of 0 bytes, R = 1)
    reads M from the column-major copy that it writes at its start: the
    same products in the same column order as a rank's row-major band of M
    in shared memory (9 ranks under a limit that fits their bands and no
    cluster's), so the same bits.  The block instance that an H100 picks at
    this n sums in four chunks a row: within 1e-5 of the lane scale."""
    ins = _box_avi(K2_N, K2_LANES, seed=K2_N + 1)
    assert eg_cuda.host_instance(K2_N, HOPPER_SMEM_OPTIN) == eg_cuda.EG_SHARED
    optin = eg_cuda.host_band_bytes(K2_N, 9)
    assert eg_cuda.host_instance(K2_N, optin) == eg_cuda.EG_GLOBAL
    assert eg_cuda.host_global_band_fits(K2_N, 9, optin)
    band = eg_cuda.eg_steps_host(*ins, steps, optin=optin, ranks=9)
    one = eg_cuda.eg_steps_host(*ins, steps, optin=0, ranks=1)
    assert torch.equal(one, band)
    block = eg_cuda.eg_steps_host(*ins, steps)
    scale = 1.0 + float(one.abs().max())
    assert float((block - one).abs().max()) <= 1e-5 * scale


def test_k2_whole_batch_takes_one_block_a_lane():
    """Where the lanes fill the card (67 at an H100's 132 resident blocks),
    the pick is R = 1 and the emulation reads the column-major copy: the
    bits of R = 1 forced, within 1e-5 of the lane scale of the block
    instance after 20 steps."""
    lanes = 67
    ins = _box_avi(K2_N, lanes, seed=K2_N + 2)
    assert eg_cuda.host_global_ranks(K2_N, lanes, HOPPER_RESIDENT_BLOCKS,
                                     0) == 1
    z = eg_cuda.eg_steps_host(*ins, 20, optin=0)
    assert torch.equal(z, eg_cuda.eg_steps_host(*ins, 20, optin=0, ranks=1))
    scale = 1.0 + float(z.abs().max())
    assert float((eg_cuda.eg_steps_host(*ins, 20) - z).abs().max()) \
        <= 1e-5 * scale


def test_k2_spread_emulation_matches_plain_loop():
    """The picked spread at an H100's limit on lanes past the cluster's
    reach is still the plain loop's iteration: z within 1e-5 of the lane
    scale after 300 steps (f32 sums in another order), as
    ``test_torch_eg.py``."""
    n = 684
    ins = _box_avi(n, 2, seed=n)
    assert eg_cuda.host_instance(n, HOPPER_SMEM_OPTIN) == eg_cuda.EG_GLOBAL
    assert eg_cuda.host_global_ranks(n, 2, HOPPER_RESIDENT_BLOCKS,
                                     HOPPER_SMEM_OPTIN) == 9
    zh = eg_cuda.eg_steps_host(*ins, 300)
    zp = eg.eg_steps_torch(*ins, 300)
    scale = 1.0 + float(zp.abs().max())
    assert float((zh - zp).abs().max()) <= 1e-5 * scale
