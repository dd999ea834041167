#!/usr/bin/env python3
"""K3's instances past a block's shared memory alone, on one NVIDIA GPU: the
parts of ``chip_smoke.py`` phase 20 (d) that need no host LP, in a minute or
two instead of the whole script's eight to ten.

    python3 tools/torch_screen_probe.py [--parent DIR]

Prints nvcc's register and spill report (``-Xptxas -v``) for
``csrc/screen.cu``; then, on seeded polyhedra of 260 rows in dimension 240,
the cluster instance against the bits of its g++ emulation (the ranks the
wrapper picks, and 2 and 8 ranks through the private launcher), a cluster of
16 blocks refused with ``RuntimeError``, and ``chip_smoke.k3_ab`` at B = 4
and 128 (cluster against global, bit-equal, timed); then the global
instance at 520 x 500 on 4 polyhedra against its host bits and the plain
loop (``chip_smoke.compare_screen``).  It fails where those checks fail.

``--parent DIR`` also times another checkout's ``csrc/screen.cu`` (for
example ``git archive <commit> qpn_tpu_torch/csrc | tar -x -C DIR``; its C
entries ``qpn_screen_f32`` and ``qpn_screen_global_f32`` without a
workspace, as before the global instance read a column-major copy) against
this checkout's: the global instance at 260 x 240, B = 4 against the
cluster instance and the global one; the shared instance at 120 x 100, B =
64; the warp instance at the flagship's 18 x 18, B = 4096.  Each pair equal
bit for bit, then timed old, new, new, old: the median of 7 launches
between CUDA events each time, each kernel through its library's C entry
(no wrapper, so that both are timed alike).  Every line carries the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

STEPS, LR = chip_smoke.SCREEN_STEPS, chip_smoke.SCREEN_LR


def ptxas_report(say) -> None:
    """nvcc's -Xptxas -v lines for csrc/screen.cu."""
    from qpn_tpu_torch.utils import cuda_build
    out = ROOT / "build" / "screen_ptxas.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
         str(out), str(cuda_build.CSRC_DIR / "screen.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc screen.cu: {proc.stderr}")
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    keep = [ln for ln in lines if "warp_kernel" not in ln]
    say("ptxas screen.cu (the warp kernel's 64 instances left out):\n  "
        + "\n  ".join(keep))


def ragged(B, m, n, seed, device):
    """Prepared inputs of chip_smoke's seeded polyhedra (centred off the
    origin, every second one empty) on the card."""
    from qpn_tpu_torch.ops import screen
    polys, _ = chip_smoke.screen_batch(B, m, n, seed)
    return [torch.as_tensor(a, device=device)
            for a in screen.screen_prepare(polys)]


def cluster_checks(device, say, card) -> None:
    """The cluster instance's bits against its emulation at the picked,
    2 and 8 ranks; a refused size raises."""
    from qpn_tpu_torch.ops import screen_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    ins = ragged(4, 260, 240, chip_smoke.SEED, device)
    chip_smoke.k3_host_bits(ins, "cluster", say)
    for ranks, shape in ((2, (120, 100)), (8, (260, 240))):
        sub = ins if shape == (260, 240) else ragged(4, *shape, 7, device)
        xk, vk = screen_cuda._launch(*sub, STEPS, LR, ranks=ranks,
                                     instance=screen_cuda.SCREEN_CLUSTER)
        xh, vh = screen_cuda.screen_steps_host(*(a.cpu() for a in sub),
                                               STEPS, LR, ranks=ranks)
        chip_smoke.host_bits(f"K3 cluster R={ranks} {shape}", [xk, vk],
                             [xh, vh])
    say(f"K3 cluster at R = 2 (120 x 100) and R = 8 (260 x 240) through the "
        f"private launcher: the bits of the g++ emulation of those ranks "
        f"[{card}]")
    METRICS.reset()
    try:
        screen_cuda._launch(*ins, 10, LR, ranks=16,
                            instance=screen_cuda.SCREEN_CLUSTER)
    except RuntimeError as e:
        message = str(e)
    else:
        chip_smoke.fail("K3: a cluster of 16 blocks was not refused")
    if sum(METRICS.launches.values()) != 0:
        chip_smoke.fail(f"K3: the refused launch counted {METRICS.launches}")
    screen_cuda.feasibility_screen_cuda(*ins, 10, LR)
    torch.cuda.synchronize(device)
    say(f"K3 cluster of 16 blocks refused: {message!r}; the next launch "
        f"ran ({dict(METRICS.launches)}) [{card}]")


def direct(fn, *extra):
    """A screen library's C entry ``fn`` behind the plain-loop signature,
    called with no check (old and new timed alike: the kernel alone)."""
    from qpn_tpu_torch.ops import screen_cuda

    def run(A, l, u, x0):
        B, m, n = A.shape
        x_out = torch.empty_like(x0)
        v_out = torch.empty(B, dtype=torch.float32, device=A.device)
        ws = [e(B, m, n) if callable(e) else e for e in extra]
        rc = fn(*screen_cuda._args(A, l, u, x0, x_out, v_out, STEPS, LR),
                *(w.data_ptr() if isinstance(w, torch.Tensor) else w
                  for w in ws),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"screen kernel: rc {rc}")
        return x_out, v_out
    return run


def workspace(B, m, n):
    """The global instance's column-major copies of A, on the card."""
    return torch.empty(B * m * n, dtype=torch.float32, device="cuda")


def parent_library(parent: Path):
    """The parent's qpn_screen_f32 and qpn_screen_global_f32 (no
    workspace)."""
    from qpn_tpu_torch.ops import screen_cuda
    from qpn_tpu_torch.utils import cuda_build
    csrc = parent / "qpn_tpu_torch" / "csrc"
    so = cuda_build.build_library(
        "parent_screen", [csrc / "screen.cu"],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS],
        sorted(csrc.glob("*.cuh")))
    lib = ctypes.CDLL(str(so))
    for fn in (lib.qpn_screen_f32, lib.qpn_screen_global_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = screen_cuda._PARAMS + [ctypes.c_void_p]
    return direct(lib.qpn_screen_f32), direct(lib.qpn_screen_global_f32)


def turns(label, old, news, device, say, card) -> None:
    """old against each of ``news`` (name -> function): equal bits, then
    old, new, new, old, the median of REPEATS launches each time."""
    xo, vo = old()
    for name, new in news.items():
        xn, vn = new()
        torch.cuda.synchronize(device)
        if not (torch.equal(xo, xn) and torch.equal(vo, vn)):
            chip_smoke.fail(f"K3 {label}: the parent's bits differ from "
                            f"{name}'s")
    times = {"old": [], **{name: [] for name in news}}
    for name in ("old", *news, *reversed(news), "old"):
        fn = old if name == "old" else news[name]
        times[name].append(chip_smoke.device_timed(fn, device))
    text = ", ".join(f"{name} {[f'{t * 1e3:.4f}' for t in ts]} ms"
                     for name, ts in times.items())
    t_old = statistics.mean(times["old"])
    ratios = ", ".join(f"old / {name} {t_old / statistics.mean(ts):.2f}"
                       for name, ts in times.items() if name != "old")
    say(f"K3 {label}: the parent's equal bit for bit; {text} (in turns, "
        f"each the median of {chip_smoke.REPEATS}); {ratios} [{card}]")


def parent_ab(parent: Path, device, say, card) -> None:
    """The parent's K3 against this checkout's, each through its C entry."""
    from qpn_tpu_torch.ops import screen_cuda
    old_picked, old_global = parent_library(parent)
    lib = screen_cuda.LIB.cuda()
    ins = ragged(4, 260, 240, chip_smoke.SEED, device)
    ranks = screen_cuda.card_instance(260, 240, device)[1]
    turns("260 x 240 B=4, the parent's global instance",
          lambda: old_global(*ins),
          {"cluster": lambda: direct(lib.qpn_screen_cluster_f32, ranks)(
              *ins),
           "global": lambda: direct(lib.qpn_screen_global_f32, workspace)(
               *ins)},
          device, say, card)
    for B, m, n in ((64, 120, 100), (4096, 18, 18)):
        ins_s = ragged(B, m, n, 1, device)
        turns(f"{m} x {n} B={B}, instance "
              f"{screen_cuda.card_instance(m, n, device)[0]}",
              lambda: old_picked(*ins_s),
              {"new": lambda: direct(lib.qpn_screen_f32)(*ins_s)}, device,
              say, card)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the probe "
                        "needs a CUDA device")
    from qpn_tpu_torch.ops import screen
    from qpn_tpu_torch.ops import screen_cuda
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    say = chip_smoke.Clock()
    ptxas_report(say)
    screen_cuda.build()
    say(f"built; largest SM clock {chip_smoke.card_max_sm_mhz()} MHz")
    cluster_checks(device, say, card)
    if ns.parent is not None:
        parent_ab(ns.parent, device, say, card)
    m, n = chip_smoke.DOMAIN_SCREEN_M, chip_smoke.DOMAIN_SCREEN_N
    for B in (chip_smoke.DOMAIN_SCREEN_B, chip_smoke.SCREEN_AB_B):
        polys, _ = chip_smoke.screen_batch(B, m, n, chip_smoke.SEED + 1)
        chip_smoke.k3_ab(polys, device, say, card)
    polys, truth = chip_smoke.screen_batch(
        chip_smoke.DOMAIN_SCREEN_B, *chip_smoke.SCREEN_GLOBAL_MN,
        chip_smoke.SEED)
    chip_smoke.k3_host_bits([torch.as_tensor(a, device=device) for a in
                             screen.screen_prepare(polys)], "global", say)
    chip_smoke.compare_screen(polys, truth, device, say, card,
                              "past the cluster's reach")


if __name__ == "__main__":
    main()
