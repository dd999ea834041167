"""The CUDA kernel's lane code, built for the host, against the JAX
package's pivot engine.

``csrc/lemke_lane.cuh`` holds the per-lane step functions of the Hopper
kernel as ``__host__ __device__`` code; ``csrc/lemke_lane_host.cpp`` runs
them as thread 0 of 1 with no-op barriers.  g++ builds that host instance
here in seconds (no torch headers), and ``ops/lemke_cuda.lemke_pivot_host``
loads it with ctypes.  It is the only evidence of the kernel's logic that a
machine without a card can give: the same cases as ``test_torch_lemke.py``,
with the same contract (identical status and pivot counts, refactorized
residual below 1e-9).
"""

import numpy as np
import pytest
import torch

from qpn_tpu_torch.ops import lemke
from qpn_tpu_torch.ops.lemke_cuda import lemke_pivot_host

from test_torch_lemke import (CASES, HOT, assert_same_path, port_state,
                              reference_state, tensors)

F64 = dict(tol=1e-11, piv_tol=1e-11)


@pytest.mark.parametrize("name,build,max_pivots", CASES,
                         ids=[c[0] for c in CASES])
def test_host_lane_matches_xla_engine(name, build, max_pivots):
    problem = build()
    ref = reference_state(*problem, max_pivots)
    port = port_state(*problem, max_pivots, lemke_pivot_host)
    assert_same_path(port, ref, problem)
    if name == "padded_solved_at_start":
        assert int(port[2][0]) == 0
        assert (port[0][:, 6:] == 0).all()


@pytest.mark.parametrize("dtype,kw", [(np.float32, HOT), (np.float64, F64)],
                         ids=["f32", "f64"])
def test_host_lane_matches_xla_engine_on_scenarios(dtype, kw):
    """The flagship ensemble's shape (n=38) at S=16, in the kernel's f32
    instance (the hot route) and its f64 instance (the re-pivot)."""
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    b = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    problem = (b["M"], b["q"], b["l"], b["u"], b["mask"])
    ref = reference_state(*problem, 1024, dtype=dtype, **kw)
    port = port_state(*problem, 1024, lemke_pivot_host, dtype=dtype, **kw)
    assert_same_path(port, ref, problem)
    assert (port[1] == lemke.LEMKE_SUCCESS).all()


def test_host_lane_matches_plain_loop_from_one_setup():
    """Both engines from one LemkeInit: the terminal nonbasic values and the
    pivot counts agree (the contract chip_smoke.py checks on the card)."""
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    b = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                             num_poly_faces=4, seed=1)
    M, q, l, u, z0 = tensors(np.float32, *(b[k] for k in
                                           ("M", "q", "l", "u", "z0")))
    init = lemke.lemke_setup(M, q, l, u, z0, torch.as_tensor(b["mask"]),
                             tol=HOT["tol"])
    host = lemke_pivot_host(init, max_pivots=1024, **HOT)
    plain = lemke.lemke_pivot_torch(init, max_pivots=1024, **HOT)
    assert torch.equal(host.status, plain.status)
    assert torch.equal(host.piv, plain.piv)
    np.testing.assert_array_equal(host.val.numpy(), plain.val.numpy())
