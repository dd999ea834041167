#!/usr/bin/env python3
"""Phase 20 (g) and (h) of ``chip_smoke.py`` alone, on one NVIDIA GPU: the
global instances of K1 and K2, spread over many SMs or one block a lane, in
a few minutes instead of the whole script's eight to ten.

    python3 tools/torch_spread_probe.py [--parent DIR]

Runs ``chip_smoke.midsize_generic`` (the generic route at n=304 with K2's
cluster instance and its A/B, then (g): the forced f64 stragglers at n=304
in K1's global instance, against the plain loop and in its spread A/B) and
``chip_smoke.large_generic`` ((h): the generic route at n=684 on the
ensemble's 256 lanes in K2's global instance at R = 1, against the plain
loop; then on 4 lanes spread over many SMs, its A/B and the refused
cooperative launches), with the same checks; it fails where they fail.

``--parent DIR`` also times the global instance at R = 1 of another
checkout's ``qpn_tpu_torch/csrc/eg_warmstart.cu`` (for example ``git
archive <commit> qpn_tpu_torch/csrc | tar -x -C DIR``; its C entry
``qpn_eg_warmstart_global_f32`` without ranks, as before the lanes spread)
against this checkout's on (h)'s 256 lanes at 20000 steps: equal bit for
bit, then timed old, new, new, old, one launch each between CUDA events.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def parent_global(parent: Path):
    """The parent's K2 global instance (one block a lane, M read in place)
    behind the wrapper's signature."""
    from qpn_tpu_torch.ops import eg_cuda
    from qpn_tpu_torch.utils import cuda_build
    csrc = parent / "qpn_tpu_torch" / "csrc"
    so = cuda_build.build_library(
        "parent_eg", [csrc / "eg_warmstart.cu"],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS],
        sorted(csrc.glob("*.cuh")))
    lib = ctypes.CDLL(str(so))
    fn = lib.qpn_eg_warmstart_global_f32
    fn.restype, fn.argtypes = ctypes.c_int, eg_cuda._PARAMS + [ctypes.c_void_p]

    def run(M, q, l, u, z0, tau, steps):
        out = torch.empty_like(z0)
        rc = fn(*eg_cuda._args(M, q, l, u, z0, tau, out, steps),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's eg kernel: rc {rc}")
        return out
    return run


def parent_ab(parent: Path, device, say, card) -> None:
    """Old against new K2 global at R = 1 on (h)'s whole batch."""
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import eg, eg_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy
    old = parent_global(parent)
    S, T, num_obj = chip_smoke.LARGE_GENERIC
    data = batch_from_numpy(scenario_batch_gavis(
        num_scenarios=S, T=T, num_obj=num_obj,
        num_poly_faces=chip_smoke.FACES, seed=chip_smoke.SEED))
    p = eg.eg_prepare(*(data[k] for k in chip_smoke.KEYS))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    steps = chip_smoke.EG_STEPS

    def new():
        return eg_cuda._launch(*ins, steps, instance=eg_cuda.EG_GLOBAL,
                               ranks=1)

    zo, zn = old(*ins, steps), new()
    torch.cuda.synchronize(device)
    if not torch.equal(zo, zn):
        chip_smoke.fail(f"K2 global R = 1: the parent's z differs on "
                        f"{int((zo != zn).sum())} entries")
    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        old(*ins, steps) if name == "old" else new()
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / 1e3)
    B, n = p.q.shape
    t_o, t_n = (sum(times[k]) / 2 for k in ("old", "new"))
    say(f"K2 global R = 1 B={B} n={n} steps={steps}: the parent's (M read "
        f"in place by rows) equal to this checkout's (its column-major "
        f"copy) bit for bit; old {[f'{t * 1e3:.4f}' for t in times['old']]} "
        f"ms, new {[f'{t * 1e3:.4f}' for t in times['new']]} ms (old, new, "
        f"new, old), old / new {t_o / t_n:.2f} [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the probe "
                        "needs a CUDA device")
    from qpn_tpu_torch.utils import native
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    native.library_path()
    say = chip_smoke.Clock()
    if ns.parent is not None:
        parent_ab(ns.parent, device, say, card)
    chip_smoke.midsize_generic(device, say, card)
    chip_smoke.large_generic(device, say, card)


if __name__ == "__main__":
    main()
