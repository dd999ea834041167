"""No module that the run, the harness or the reference loads has the top-
level name ``jax``, ``jaxlib``, ``flax`` or ``qpn_tpu`` (compared whole: the
port's ``qpn_tpu_torch`` is another name), and the reference loads nothing
of the program at all.  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from qpnbench.tests.small_bench import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "qpn_tpu"}

TOPS = """
import json, sys
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + TOPS], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    loaded = tops("""
import numpy as np, torch
from qpnbench.reference import check, lemke, pool, robust_avoid
from qpnbench import harness
bench = harness.Bench()
_, _, mix, config = bench.cell("ra_T5o2.kkt_s256")
prob, q, l, u = pool.lanes(config, dict(mix, lanes=4, pool=1, pool_seed=3))
n = prob.M.shape[0]
z, _, _ = lemke.solve(torch.as_tensor(prob.M).expand(4, n, n).contiguous(),
                      *(torch.as_tensor(a[0]) for a in (q, l, u)),
                      max_pivots=lemke.max_pivots(n), **lemke.F64)
assert check.residuals(prob.M, q[0], l[0], u[0], z.numpy()).max() <= 1e-8
""")
    assert not loaded & (FORBIDDEN | {"qpn_tpu_torch"})


def test_a_run_loads_no_jax():
    loaded = tops("""
import time
import torch
torch.set_num_threads(1)
from qpn_tpu_torch.config import CONFIG
CONFIG.device = "cpu"
from qpnbench import harness
from qpnbench.tests.small_bench import small_root
import pathlib, tempfile
root = small_root(pathlib.Path(tempfile.mkdtemp()))
for w, tr in (("ra_T2o1.kkt_s256", True), ("ra_T2o1.generic_s256", False)):
    r, _ = harness.run(harness.Bench(root), w, 5, 0.2, tr,
                       time.perf_counter(), device="cpu", log=lambda m: None)
    assert r["correct"]
import qpnbench.run, qpnbench.control, qpnbench.fixed_work
""")
    assert "qpn_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_names_compare_whole(monkeypatch):
    from qpnbench import harness
    monkeypatch.setitem(sys.modules, "qpn_tpu_torch_like", sys)
    assert "qpn_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()
