"""Parity of the port's KKT ensemble solve with the JAX package's at the lane
sizes between the flagship (n=38) and the shared-matrix route (n >= 192).

robust_avoid ensembles at T=3, 4, 5 with num_obj=2 (n = 114, 152, 190 per
lane; every one tagged ``shared_M`` but below ``CONFIG.shared_kkt_min_n``)
take the per-lane Lemke route of ``ops/avi.solve_kkt_avi_batch``.  On the
card their f32 lanes (and above n = 94 their f64 re-pivots) need the
global-memory instance of the pivot kernel; here on the CPU the plain loop
runs them.  The same numpy arrays go through both packages at S=8, seed 0,
tol 1e-8: every lane certified in both, pivot counts equal lane for lane,
and z within 1e-8 (both land on an exact f64 refactorization of a
complementary basis; bases are never compared).
"""

import numpy as np
import pytest

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import avi as ref_avi

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import avi
from qpn_tpu_torch.utils.metrics import METRICS

TOL = 1e-8
Z_TOL = 1e-8

# (T, num_obj, n per lane)
SIZES = [(3, 2, 114), (4, 2, 152), (5, 2, 190)]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.mark.parametrize("T,num_obj,n", SIZES,
                         ids=[f"n{n}" for _, _, n in SIZES])
def test_solve_kkt_avi_batch_matches_reference_midsize(T, num_obj, n):
    b = scenario_batch_gavis(num_scenarios=8, T=T, num_obj=num_obj,
                             num_poly_faces=4, seed=0)
    assert b["q"].shape == (8, n) and b["structure"]["shared_M"]
    assert n < CONFIG.shared_kkt_min_n
    ref = ref_avi.solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"],
                                      b["mask"], b["structure"], tol=TOL)
    t = avi.batch_from_numpy(b)
    METRICS.reset()
    res = avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"], t["mask"],
                                  t["structure"], tol=TOL)
    assert METRICS.counters["kkt_shared_route"] == 0
    assert METRICS.counters["kkt_uncertified_lanes"] == 0
    assert bool(np.all(np.asarray(ref.converged)))
    assert bool(res.converged.all())
    assert float(res.resid.max()) <= TOL
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=Z_TOL)
