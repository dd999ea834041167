#!/usr/bin/env python3
"""The cluster instances of the port's Lemke pivot kernel (K1) and
extragradient kernel (K2) alone, on one NVIDIA GPU.

    python3 tools/torch_cluster_phases.py [--parent DIR] [--variants]

Prints nvcc's register and spill report (``-Xptxas -v``) for
``csrc/lemke_pivot.cu`` and ``csrc/eg_warmstart.cu``; then the SM cycles of
each phase:

* K1, built with ``-DQPN_LEMKE_PROFILE`` (the clocks of
  ``csrc/lemke_lane.cuh``), its cluster entry point run once on the lanes of
  ``chip_smoke.py``'s phase 20 that take it (robust_avoid, num_obj=2,
  num_poly_faces=4, seed 0): f32 at T=5 (n=190, 256 lanes) and f64 at T=4
  (n=152, 16 lanes).  The first two blocks (the first cluster's ranks 0 and
  1) print their iteration count and the cycles of the fused loop's parts:
  the barrier after the pass, the decision (B, with its block barrier;
  inside it the least ratio, the tie set, the lexicographic refinement and
  the rest), the staging (S, with its cluster barrier) and the pass (the
  update of a pivot and the next step's basic values and ratios).  The
  script fails unless the profiled build gives the wrapper's status and
  pivots;
* K2, built with ``-DQPN_EG_PROFILE``, its cluster entry point on T=8 (n=304,
  256 lanes) at 2000 steps: the cycles of a block's half-steps' sums (up to
  the writes into the ranks) against its cluster barrier, and z equal to the
  wrapper's.

The clocks serialise what they stand between: read them as shares, and the
kernels' times from the A/B below or from ``chip_smoke.py``.  Each time is
printed beside its floors, computed from the shape (not measured): K2's
f32 issue floor (with -fmad=false a product and its add are two
instructions, an SM issuing 128 a cycle) and its chain of C + 2 dependent
adds a half-step at 4 cycles an add; the old design's floor of streaming the
band from shared memory every half-step (128 bytes a cycle); K1's floor of
reading and writing the band once a pivot.  Waves: the clusters of B lanes
that the card holds at once, one block an SM; clocks at the card's largest
SM clock.

``--parent DIR`` (the parent's ``qpn_tpu_torch/csrc`` from ``git archive
<commit> qpn_tpu_torch/csrc | tar -x -C DIR``) builds the parent's two
libraries and times old, new, new, old through each C entry (the median of
7 launches between CUDA events each time; K2 at 20000 steps of 3): K2's
cluster instance at n=304, B=256, 20000 steps (the new partition's z
against the old one's, within 1e-4 of the lane scale, and the bits of the
g++ emulation on 8 lanes at 300 steps); K1's cluster instance at f32 n=190
and n=152, B=256, and f64 n=152, B=16 (equal bit for bit); and the
flagship's instances, K1 shared f32 at n=38, B=256, and K2's register
instance at n=38, B=256, 20000 steps (equal bit for bit).

``--variants`` times K2's cluster instance at n=304, B=256, 20000 steps
built with other triples of (threads a block at most, rows a thread,
entries of a row a thread holds in registers) than ``csrc/eg_lane.cuh``'s,
written into a copy of ``csrc/`` under ``build/``: fewer and more
registers, and one row a thread (the first design of this instance), each
with its ptxas report, its ranks and its time in turns with the shipped
triple; all give the shipped triple's bits (the partition does not depend
on them).

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis  # noqa: E402
from qpn_tpu_torch.ops import eg, eg_cuda, lemke, lemke_cuda  # noqa: E402
from qpn_tpu_torch.ops.avi import batch_from_numpy  # noqa: E402
from qpn_tpu_torch.utils import cuda_build  # noqa: E402

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
# (T, dtype, pivot tolerances, lanes) of K1's cluster instance
K1_SHAPES = ((5, torch.float32, HOT, 256), (4, torch.float32, HOT, 256),
             (4, torch.float64, F64, 16))
K2_T, K2_LANES, K2_STEPS, K2_PROFILE_STEPS = 8, 256, 20000, 2000
K2_TOL = 1e-4          # another partition of the sums, 20000 steps
# (threads a block at most, rows a thread, entries of a row in registers)
# of the K2 variants; the shipped triple is csrc/eg_lane.cuh's
VARIANTS = ((320, 2, 56), (320, 2, 64), (640, 1, 56), (640, 1, 48))
SHIPPED = (320, 2, 60)
_NAMES = ("kEgClusterThreads", "kEgClusterRows", "kEgClusterRegs")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def ptxas(src: Path, say, label: str, extra=()) -> str:
    """nvcc's -Xptxas -v lines for the cluster and flagship kernels of
    ``src``; returns the text."""
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = ROOT / "build" / f"{label}_ptxas.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *flags, *extra, "-I", str(src.parent),
         "-Xptxas", "-v", "-c", "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc {src}: {proc.stderr}")
    lines = proc.stderr.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if not m or not re.search(
                r"cluster|register_kernel|lemke_pivot_kernel", m.group(1)):
            continue
        name = m.group(1)
        spill = next((x.strip() for x in lines[i + 1:i + 3] if "spill" in x),
                     "")
        regs = next((x.strip() for x in lines[i + 1:i + 4]
                     if "registers" in x), "")
        keep.append(f"{name}: {regs.replace('ptxas info    : ', '')}; "
                    f"{spill}")
    text = "\n  ".join(keep)
    say(f"ptxas {label}:\n  {text}")
    return text


def build(name: str, csrc: Path, source: str, extra=()) -> ctypes.CDLL:
    so = cuda_build.build_library(
        name, [csrc / source],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *extra],
        sorted(csrc.glob("*.cuh")))
    return ctypes.CDLL(str(so))


def lemke_entry(lib, ty):
    fn = getattr(lib, f"qpn_lemke_pivot_cluster_{ty}")
    fn.restype = ctypes.c_int
    fn.argtypes = lemke_cuda._PARAMS + [ctypes.c_int, ctypes.c_void_p]
    return fn


def lemke_shared_entry(lib):
    fn = lib.qpn_lemke_pivot_f32
    fn.restype = ctypes.c_int
    fn.argtypes = lemke_cuda._PARAMS + [ctypes.c_void_p]
    return fn


def eg_entry(lib, cluster=True):
    fn = lib.qpn_eg_warmstart_cluster_f32 if cluster \
        else lib.qpn_eg_warmstart_f32
    fn.restype = ctypes.c_int
    fn.argtypes = eg_cuda._PARAMS + ([ctypes.c_int] if cluster else []) + [
        ctypes.c_void_p]
    return fn


def run_lemke(fn, init, kw, *extra):
    out = lemke_cuda._outputs(init)
    rc = fn(*lemke_cuda._args(init, out, kw["tol"], kw["piv_tol"],
                              kw["max_pivots"]), *extra,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        chip_smoke.fail(f"K1 entry: rc {rc}")
    return out


def run_eg(fn, ins, steps, *extra):
    out = torch.empty_like(ins[4])
    rc = fn(*eg_cuda._args(*ins, out, steps), *extra,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        chip_smoke.fail(f"K2 entry: rc {rc}")
    return out


def k1_init(T, dtype, kw, lanes, device, num_obj=2):
    data = batch_from_numpy(scenario_batch_gavis(
        num_scenarios=lanes, T=T, num_obj=num_obj, num_poly_faces=4, seed=0),
        device)
    return lemke.lemke_setup(*(data[k].to(dtype) for k in
                               ("M", "q", "l", "u", "z0")), data["mask"],
                             tol=kw["tol"])


def k2_inputs(T, lanes, device, num_obj=2):
    data = batch_from_numpy(scenario_batch_gavis(
        num_scenarios=lanes, T=T, num_obj=num_obj, num_poly_faces=4, seed=0),
        device)
    p = eg.eg_prepare(*(data[k] for k in chip_smoke.KEYS))
    return (p.M, p.q, p.l, p.u, p.z0, p.tau)


def k1_profile(device, say, card) -> None:
    lib = build("lemke_pivot_profile", cuda_build.CSRC_DIR, "lemke_pivot.cu",
                ["-DQPN_LEMKE_PROFILE"])
    for T, dtype, kw, lanes in (K1_SHAPES[0], K1_SHAPES[2]):
        init = k1_init(T, dtype, kw, lanes, device)
        n = init.T.shape[1]
        instance, ranks = lemke_cuda.card_instance(
            n, init.T.element_size(), device)
        if instance != lemke_cuda.LANE_CLUSTER:
            chip_smoke.fail(f"n={n} does not take K1's cluster instance")
        want = lemke_cuda.lemke_pivot_cuda(init, **kw)
        ty = "f32" if dtype == torch.float32 else "f64"
        print(f"K1 cluster {ty} B={lanes} n={n}, {ranks} blocks a lane, "
              f"profiled [{card}]:", flush=True)
        out = run_lemke(lemke_entry(lib, ty), init, kw, ranks)
        torch.cuda.synchronize()
        if not (torch.equal(out.status, want.status)
                and torch.equal(out.piv, want.piv)):
            chip_smoke.fail(f"profiled K1 {ty} n={n}: status and pivots "
                            "differ from the wrapper's")
    say(f"K1 profiled [{card}]")


def k2_profile(device, say, card) -> None:
    lib = build("eg_warmstart_profile", cuda_build.CSRC_DIR,
                "eg_warmstart.cu", ["-DQPN_EG_PROFILE"])
    ins = k2_inputs(K2_T, K2_LANES, device)
    n = ins[0].shape[1]
    instance, ranks = eg_cuda.card_instance(n, device)
    print(f"K2 cluster B={K2_LANES} n={n} steps={K2_PROFILE_STEPS}, {ranks} "
          f"blocks a lane, profiled [{card}]:", flush=True)
    z = run_eg(eg_entry(lib), ins, K2_PROFILE_STEPS, ranks)
    want = eg_cuda.eg_warmstart_cuda(*ins, K2_PROFILE_STEPS)
    torch.cuda.synchronize()
    if not torch.equal(z, want):
        chip_smoke.fail("profiled K2: z differs from the wrapper's")
    say(f"K2 profiled [{card}]")


def turns(label, old, new, device, say, card, repeats=chip_smoke.REPEATS):
    """old, new, new, old, each the median of ``repeats`` launches between
    CUDA events.  Returns (old times, new times) in seconds."""
    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        fn = old if name == "old" else new
        times[name].append(chip_smoke.device_timed(fn, device, repeats))
    t_old, t_new = (statistics.mean(times[k]) for k in ("old", "new"))
    say(f"{label}: old {[f'{t * 1e3:.4f}' for t in times['old']]} ms, new "
        f"{[f'{t * 1e3:.4f}' for t in times['new']]} ms (in turns, each the "
        f"median of {repeats}); old / new {t_old / t_new:.2f} [{card}]")
    return times["old"], times["new"]


def parent_ab(parent: Path, device, say, card) -> None:
    csrc = parent / "qpn_tpu_torch" / "csrc"
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(build, f"parent_{s.split('.')[0]}", csrc, s)
                for s in ("lemke_pivot.cu", "eg_warmstart.cu")]
        old_lk, old_eg = (j.result() for j in jobs)
    new_lk, new_eg = lemke_cuda.LIB.cuda(), eg_cuda.LIB.cuda()
    # K2's cluster instance: another partition, so within K2_TOL
    ins = k2_inputs(K2_T, K2_LANES, device)
    n = ins[0].shape[1]
    _, ranks = eg_cuda.card_instance(n, device)
    zo = run_eg(eg_entry(old_eg), ins, K2_STEPS, ranks)
    zn = run_eg(eg_entry(new_eg), ins, K2_STEPS, ranks)
    torch.cuda.synchronize()
    err = float(((zo - zn).abs().amax(1) / (1 + zo.abs().amax(1))).max())
    if not err <= K2_TOL:
        chip_smoke.fail(f"K2 n={n}: the new partition's z differs from the "
                        f"parent's by {err!r} of the lane scale")
    sub = tuple(a[:chip_smoke.HOST_BIT_LANES] for a in ins)
    zk = run_eg(eg_entry(new_eg), sub, 300, ranks)
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in sub), 300,
                               optin=eg_cuda.LIB.optin(device))
    chip_smoke.host_bits("K2 cluster (probe)", [zk], [zh])
    _, t_new = turns(
        f"K2 cluster B={K2_LANES} n={n} steps={K2_STEPS} ({ranks} blocks a "
        f"lane; z within {err:.3g} of the lane scale of the parent's, the "
        f"g++ emulation's bits on {chip_smoke.HOST_BIT_LANES} lanes)",
        lambda: run_eg(eg_entry(old_eg), ins, K2_STEPS, ranks),
        lambda: run_eg(eg_entry(new_eg), ins, K2_STEPS, ranks),
        device, say, card, repeats=3)
    issue, chain, stream = chip_smoke.k2_cluster_floors(n, ranks, K2_LANES,
                                                        K2_STEPS)
    bnd = chip_smoke.eg_bound(ins, zn, K2_STEPS)
    t = statistics.median(t_new) * 1e3
    say(f"K2 cluster floors (computed): issue {issue:.3f} ms, chain "
        f"{chain:.3f} ms, the old design's band streaming {stream:.3f} ms; "
        f"bound {bnd[0]:.5f} ms by {bnd[1]}, share {bnd[0] / t * 100:.2f} % "
        f"[{card}]")
    # K1's cluster instance: the same bits
    for T, dtype, kw, lanes in K1_SHAPES:
        init = k1_init(T, dtype, kw, lanes, device)
        n = init.T.shape[1]
        ty = "f32" if dtype == torch.float32 else "f64"
        _, ranks = lemke_cuda.card_instance(n, init.T.element_size(), device)
        ro = run_lemke(lemke_entry(old_lk, ty), init, kw, ranks)
        rn = run_lemke(lemke_entry(new_lk, ty), init, kw, ranks)
        torch.cuda.synchronize()
        for name, a, b in zip(ro._fields, ro, rn):
            if not torch.equal(a, b):
                chip_smoke.fail(f"K1 {ty} n={n}: {name} differs from the "
                                "parent's")
        _, t_new = turns(
            f"K1 cluster {ty} B={lanes} n={n} ({ranks} blocks a lane; the "
            f"parent's bits)",
            lambda: run_lemke(lemke_entry(old_lk, ty), init, kw, ranks),
            lambda: run_lemke(lemke_entry(new_lk, ty), init, kw, ranks),
            device, say, card)
        bnd = chip_smoke.lemke_bound(init, rn)
        t = statistics.median(t_new) * 1e3
        floor = chip_smoke.k1_cluster_floor(n, init.T.element_size(),
                                            rn.piv, ranks)
        say(f"K1 cluster {ty} n={n}: band read and written once a pivot "
            f"(computed) {floor:.4f} ms; bound "
            f"{bnd[0]:.5f} ms by {bnd[1]}, share {bnd[0] / t * 100:.2f} % "
            f"[{card}]")
    # the flagship's instances
    init = k1_init(2, torch.float32, HOT, 256, device, num_obj=1)
    ro = run_lemke(lemke_shared_entry(old_lk), init, HOT)
    rn = run_lemke(lemke_shared_entry(new_lk), init, HOT)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(ro, rn)):
        chip_smoke.fail("K1 shared n=38: the bits differ from the parent's")
    turns("K1 shared f32 B=256 n=38 (the parent's bits)",
          lambda: run_lemke(lemke_shared_entry(old_lk), init, HOT),
          lambda: run_lemke(lemke_shared_entry(new_lk), init, HOT),
          device, say, card)
    ins = k2_inputs(2, 256, device, num_obj=1)
    zo = run_eg(eg_entry(old_eg, False), ins, K2_STEPS)
    zn = run_eg(eg_entry(new_eg, False), ins, K2_STEPS)
    torch.cuda.synchronize()
    if not torch.equal(zo, zn):
        chip_smoke.fail("K2 register n=38: the bits differ from the "
                        "parent's")
    turns(f"K2 register B=256 n=38 steps={K2_STEPS} (the parent's bits)",
          lambda: run_eg(eg_entry(old_eg, False), ins, K2_STEPS),
          lambda: run_eg(eg_entry(new_eg, False), ins, K2_STEPS),
          device, say, card)


def variant_csrc(variant) -> Path:
    """A copy of csrc/ with K2's cluster triple set to ``variant``."""
    import shutil
    d = ROOT / "build" / ("eg_variant_" + "_".join(map(str, variant)))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, d)
    head = (d / "eg_lane.cuh").read_text()
    for name, old, new in zip(_NAMES, SHIPPED, variant):
        line = f"constexpr int {name} = {old};"
        if line not in head:
            chip_smoke.fail(f"eg_lane.cuh no longer says {line!r}")
        head = head.replace(line, f"constexpr int {name} = {new};")
    (d / "eg_lane.cuh").write_text(head)
    return d


def variants(device, say, card) -> None:
    ins = k2_inputs(K2_T, K2_LANES, device)
    n = ins[0].shape[1]
    _, ranks = eg_cuda.card_instance(n, device)
    shipped = eg_entry(eg_cuda.LIB.cuda())
    want = run_eg(shipped, ins, K2_STEPS, ranks)
    dirs = {v: variant_csrc(v) for v in VARIANTS}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {v: pool.submit(build, d.name, d, "eg_warmstart.cu")
                for v, d in dirs.items()}
        libs = {v: j.result() for v, j in jobs.items()}
    for v, d in dirs.items():
        ptxas(d / "eg_warmstart.cu", say, f"K2 variant {v}")
        lib = libs[v]
        lib.qpn_eg_cluster_ranks.restype = ctypes.c_int
        lib.qpn_eg_cluster_ranks.argtypes = [ctypes.c_int, ctypes.c_longlong]
        r = lib.qpn_eg_cluster_ranks(n, eg_cuda.LIB.optin(device))
        fn = eg_entry(lib)
        z = run_eg(fn, ins, K2_STEPS, r)
        torch.cuda.synchronize()
        if not torch.equal(z, want):
            chip_smoke.fail(f"K2 variant {v}: z differs from the shipped "
                            "pair's")
        turns(f"K2 cluster n={n} B={K2_LANES} steps={K2_STEPS}: the shipped "
              f"(threads, rows, registers) {SHIPPED} at {ranks} blocks as "
              f"old against the variant {v} at {r} blocks as new (the same "
              f"bits)",
              lambda: run_eg(shipped, ins, K2_STEPS, ranks),
              lambda: run_eg(fn, ins, K2_STEPS, r), device, say, card,
              repeats=3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the probe "
                        "needs a CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    say = chip_smoke.Clock()
    for src in ("lemke_pivot.cu", "eg_warmstart.cu"):
        ptxas(cuda_build.CSRC_DIR / src, say, src)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda f: f(), (lemke_cuda.build, eg_cuda.build)))
    say(f"built; largest SM clock {chip_smoke.card_max_sm_mhz()} MHz")
    k1_profile(device, say, card)
    k2_profile(device, say, card)
    if ns.parent is not None:
        parent_ab(ns.parent, device, say, card)
    if ns.variants:
        variants(device, say, card)


if __name__ == "__main__":
    main()
