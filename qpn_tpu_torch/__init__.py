"""qpn_tpu_torch — the PyTorch/CUDA port of qpn_tpu (Quadratic Program
Networks).

The port holds model building for all sixteen setups, the multilevel
equilibrium ``solve()`` with its solution graphs and the geometry layer
(``geometry``), and the batched engines: the KKT-AVI ensemble solve
(``ops.avi.solve_kkt_avi_batch``), the generic adaptive AVI solve, the
batched ADMM (``ops.batch_qp``) and the feasibility screen (``ops.screen``).
Three loops run in hand-written Hopper kernels for CUDA tensors: the Lemke
pivot loop (``csrc/lemke_pivot.cu``), the extragradient warm start
(``csrc/eg_warmstart.cu``) and the feasibility screen (``csrc/screen.cu``).
The host algorithm puts its batched work on ``CONFIG.device``; scenario
ensembles run serially (``solve_many``), with their batched calls fused
(``parallel.lockstep.solve_many_lockstep``) or in spawned processes
(``parallel.procpool.solve_many_processes``), and over the ranks of a
``torch.distributed`` process group (``parallel.mesh``, ``parallel.sharded``;
``entry.dryrun_multichip``).  The package
imports neither ``jax`` nor ``qpn_tpu``; ``qpn_tpu`` stays the reference that
the tests hold this package against.
"""

from .config import CONFIG, NumericConfig  # noqa: F401
from .geometry.poly import Poly, PolyUnion, intersect, from_box  # noqa: F401
from .options import QPNetOptions  # noqa: F401
from .network import QP, Constraint, Quadratic, Linear, QPNet  # noqa: F401
from .frontend import variables, variable  # noqa: F401
from .models import setup  # noqa: F401
from .algorithm import solve, solve_many  # noqa: F401
from .ops.avi import solve_kkt_avi_batch, batch_from_numpy  # noqa: F401
from .utils.metrics import METRICS  # noqa: F401
from .printing import install_reprs as _install_reprs

_install_reprs()
