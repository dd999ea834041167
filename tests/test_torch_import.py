"""The port imports neither JAX nor the JAX package: ``qpn_tpu/config.py``
switches on x64 and the XLA cache at import, and the GPU machine has no JAX.
Checked in a fresh interpreter, since this test process imports both."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import qpn_tpu_torch
import qpn_tpu_torch.algorithm, qpn_tpu_torch.ops.lemke_cuda
import qpn_tpu_torch.utils.cuda_build, qpn_tpu_torch.utils.native
qpn_tpu_torch.models.robust_avoid.scenario_batch_gavis(num_scenarios=2, T=2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "qpn_tpu"))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
