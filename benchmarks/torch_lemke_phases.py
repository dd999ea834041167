#!/usr/bin/env python3
"""SM cycles per phase of the port's Lemke pivot kernel (K1) on one NVIDIA
GPU.

    python3 benchmarks/torch_lemke_phases.py

Builds ``qpn_tpu_torch/csrc/lemke_pivot.cu`` with ``-DQPN_LEMKE_PROFILE``
(the phase clocks of ``csrc/lemke_lane.cuh``: ``clock64`` around each phase,
summed by thread 0 over a lane's iterations) and runs it once on the
flagship ensemble (robust_avoid, S=256, T=2, num_obj=1, num_poly_faces=4,
seed 0; n=38, f32).  The first two blocks of the launch print their iteration count and the cycles of

* ratios: basic values and ratio test, with its barrier;
* decide: the first warp's decision, with its barrier; inside it: the min
  ratio, the tie set, the lexicographic refinement, and the rest (pivot
  element, outcome to shared memory, a non-pivot step's bookkeeping);
* stage: pivot row and entering column staged by all threads beside thread
  0's bookkeeping, with its barrier;
* update: the rank-1 update, with its barrier.

The clocks cost some tens of cycles each and serialise what they stand
between: read the numbers as shares, and take a kernel's time from
``benchmarks/torch_kernels_ab.py`` or ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis  # noqa: E402
from qpn_tpu_torch.ops import lemke, lemke_cuda  # noqa: E402
from qpn_tpu_torch.ops.avi import batch_from_numpy  # noqa: E402
from qpn_tpu_torch.utils import cuda_build  # noqa: E402

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_lemke_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    csrc = cuda_build.CSRC_DIR
    so = cuda_build.build_library(
        "lemke_pivot_profile", [csrc / "lemke_pivot.cu"],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
         "-DQPN_LEMKE_PROFILE"], [csrc / "lemke_lane.cuh"])
    lib = ctypes.CDLL(str(so))
    lib.qpn_lemke_pivot_f32.restype = ctypes.c_int
    lib.qpn_lemke_pivot_f32.argtypes = lemke_cuda._PARAMS + [ctypes.c_void_p]
    data = batch_from_numpy(scenario_batch_gavis(
        num_scenarios=256, T=2, num_obj=1, num_poly_faces=4, seed=0))
    M, q, l, u = (data[k].float() for k in ("M", "q", "l", "u"))
    init = lemke.lemke_setup(M, q, l, u, torch.zeros_like(q), data["mask"],
                             tol=HOT["tol"])
    plain = lemke.lemke_pivot_torch(init, **HOT)
    out = lemke_cuda._outputs(init)
    rc = lib.qpn_lemke_pivot_f32(
        *lemke_cuda._args(init, out, HOT["tol"], HOT["piv_tol"],
                          HOT["max_pivots"]),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0 or not (torch.equal(out.status, plain.status)
                       and torch.equal(out.piv, plain.piv)):
        sys.exit(f"profiled kernel: rc {rc}, or status and pivots differ "
                 "from the plain loop")


if __name__ == "__main__":
    main()
