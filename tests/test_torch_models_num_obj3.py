"""``tests/test_models.py::test_robust_avoid_simple_num_obj3_solves`` through
the port, held to the JAX package: robust_avoid_simple with three coupled
obstacle/certificate branches needs the whole robustness ladder (vacuous-
combo guard, joint-feasibility screen, alternate failing combos, perturb-to-
continue).  Both packages must solve it with the same QEP solves and pieces
projected and x_opt within 1e-6 (the zoo's tolerance).  It takes about a
minute in each package on the CPU, so it has a file of its own, which a
test worker runs beside the others.
"""

import numpy as np
import torch

import qpn_tpu as ref
import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.geometry.query_cache import CACHE

torch.set_num_threads(1)

X_TOL = 1e-6


def _solve(pkg):
    qpn = pkg.setup("robust_avoid_simple", num_obj=3)
    ret = pkg.solve(qpn)
    c = qpn.metrics.counters
    return ret, int(c.get("qep_solves", 0)), int(c.get("pieces_projected", 0))


def test_robust_avoid_simple_num_obj3_solves(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    CACHE.clear()
    ret, qep, pieces = _solve(qt)
    want, want_qep, want_pieces = _solve(ref)
    assert ret.solved and want.solved
    assert (qep, pieces) == (want_qep, want_pieces) == (19, 282)
    assert np.all(np.isfinite(ret.x_opt))
    np.testing.assert_allclose(ret.x_opt, want.x_opt, rtol=0, atol=X_TOL)
