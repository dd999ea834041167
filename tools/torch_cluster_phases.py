#!/usr/bin/env python3
"""SM cycles per phase of the cluster instance of the port's Lemke pivot
kernel (K1) on one NVIDIA GPU.

    python3 tools/torch_cluster_phases.py

Builds ``qpn_tpu_torch/csrc/lemke_pivot.cu`` with ``-DQPN_LEMKE_PROFILE``
(the phase clocks of ``csrc/lemke_lane.cuh``, as
``benchmarks/torch_lemke_phases.py`` does for the flagship's shared
instance) and runs its cluster entry point once on each of the lanes of
``chip_smoke.py``'s phase 20 that take it (robust_avoid, num_obj=2,
num_poly_faces=4, seed 0): f32 at T=5 (n=190, 256 lanes) and f64 at T=4
(n=152, 16 lanes), over the ranks the launcher picks.  The first two
blocks (the first cluster's ranks 0 and 1) print their iteration count and
the cycles of

* ratios: phase A (basic values and ratios of the rank's band) with its
  cluster barrier;
* decide: phase B with its block barrier; inside it the min ratio, the tie
  set, the lexicographic refinement and the rest;
* stage: phase S with its cluster barrier;
* update: phase C (the band's rank-1 update) with its block barrier.

The clocks serialise what they stand between: read the numbers as shares,
and take the kernel's time from ``chip_smoke.py``.  The script fails unless
the profiled build gives the status and pivots of the wrapper's own.
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
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
# (T, dtype, pivot tolerances, lanes)
SHAPES = ((5, torch.float32, HOT, 256), (4, torch.float64, F64, 16))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_cluster_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    csrc = cuda_build.CSRC_DIR
    so = cuda_build.build_library(
        "lemke_pivot_profile", [csrc / "lemke_pivot.cu"],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
         "-DQPN_LEMKE_PROFILE"],
        [csrc / "lemke_lane.cuh", csrc / "cluster_launch.cuh"])
    lib = ctypes.CDLL(str(so))
    for T, dtype, kw, lanes in SHAPES:
        data = batch_from_numpy(scenario_batch_gavis(
            num_scenarios=lanes, T=T, num_obj=2, num_poly_faces=4, seed=0))
        init = lemke.lemke_setup(*(data[k].to(dtype) for k in
                                   ("M", "q", "l", "u", "z0")), data["mask"],
                                 tol=kw["tol"])
        n = init.T.shape[1]
        instance, ranks = lemke_cuda.card_instance(
            n, init.T.element_size(), init.T.device)
        if instance != lemke_cuda.LANE_CLUSTER:
            sys.exit(f"torch_cluster_phases: n={n} does not take the "
                     "cluster instance")
        want = lemke_cuda.lemke_pivot_cuda(init, **kw)
        ty = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(lib, f"qpn_lemke_pivot_cluster_{ty}")
        fn.restype = ctypes.c_int
        fn.argtypes = lemke_cuda._PARAMS + [ctypes.c_int, ctypes.c_void_p]
        out = lemke_cuda._outputs(init)
        print(f"K1 cluster {ty} B={lanes} n={n}, {ranks} blocks a lane "
              f"[{card}]:", flush=True)
        rc = fn(*lemke_cuda._args(init, out, kw["tol"], kw["piv_tol"],
                                  kw["max_pivots"]),
                ranks, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0 or not (torch.equal(out.status, want.status)
                           and torch.equal(out.piv, want.piv)):
            sys.exit(f"profiled kernel {ty} n={n}: rc {rc}, or status and "
                     "pivots differ from the wrapper's")


if __name__ == "__main__":
    main()
