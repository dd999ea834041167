"""qpn_tpu_torch — the PyTorch/CUDA port of qpn_tpu (Quadratic Program
Networks).

Slice 1 of the port: model building for the robust-avoidance scenario
ensembles and the batched KKT-AVI ensemble solve
(``ops.avi.solve_kkt_avi_batch``), whose pivot loop runs in a hand-written
Hopper kernel (``csrc/lemke_pivot.cu``) for CUDA tensors.  The package
imports neither ``jax`` nor ``qpn_tpu``; ``qpn_tpu`` stays the reference that
the tests hold this package against.
"""

from .config import CONFIG, NumericConfig  # noqa: F401
from .geometry.poly import Poly, PolyUnion, intersect, from_box  # noqa: F401
from .options import QPNetOptions  # noqa: F401
from .network import QP, Constraint, Quadratic, Linear, QPNet  # noqa: F401
from .frontend import variables, variable  # noqa: F401
from .models import setup  # noqa: F401
from .ops.avi import solve_kkt_avi_batch, batch_from_numpy  # noqa: F401
from .utils.metrics import METRICS  # noqa: F401
