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
import qpn_tpu_torch.ops.avi, qpn_tpu_torch.ops.eg, qpn_tpu_torch.ops.eg_cuda
import qpn_tpu_torch.utils.cuda_build, qpn_tpu_torch.utils.native
import qpn_tpu_torch.ops.batch_qp, qpn_tpu_torch.ops.screen
import qpn_tpu_torch.ops.screen_cuda, qpn_tpu_torch.geometry.setops
import qpn_tpu_torch.geometry.project, qpn_tpu_torch.geometry.vertices
import qpn_tpu_torch.geometry.rays, qpn_tpu_torch.geometry.query_cache
import qpn_tpu_torch.enumeration, qpn_tpu_torch.requests
import qpn_tpu_torch.parallel.sharded, qpn_tpu_torch.ops.shared_kkt
import qpn_tpu_torch.ops.banded, qpn_tpu_torch.printing
import qpn_tpu_torch.utils.checkpoint, qpn_tpu_torch.utils.flops
import qpn_tpu_torch.utils.profiling, qpn_tpu_torch.parallel.lockstep
import qpn_tpu_torch.parallel.procpool, qpn_tpu_torch.parallel.mesh
import qpn_tpu_torch.parallel.multihost, qpn_tpu_torch.parallel.ring
import qpn_tpu_torch.parallel.launch, qpn_tpu_torch.entry
for name in ("simple_bilevel", "four_player_matrix_game", "robust_avoid",
             "deep_synthetic", "rock_paper_scissors", "toll_setting",
             "chainstore", "trilevel_escape", "shepherd_sheep",
             "robust_constrained", "control_avoid", "interpolation_avoid"):
    qpn_tpu_torch.setup(name)
qpn_tpu_torch.CONFIG.device = "cpu"     # the default is the card
qpn_tpu_torch.entry.entry()
qpn_tpu_torch.solve(qpn_tpu_torch.setup("shepherd_sheep"))
qpn_tpu_torch.parallel.lockstep.solve_many_lockstep(
    [qpn_tpu_torch.setup("shepherd_sheep")])
b = qpn_tpu_torch.models.robust_avoid.scenario_batch_gavis(num_scenarios=2,
                                                           T=2)
qpn_tpu_torch.ops.shared_kkt.solve_kkt_avi_shared(
    b["M"], b["q"], b["l"], b["u"], b["mask"], structure=b["structure"])
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
