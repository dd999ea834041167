#!/usr/bin/env python3
"""Old against new design of the port's Lemke pivot kernel (K1),
extragradient kernel (K2) and feasibility-screen kernel (K3), in one process
on one NVIDIA GPU, in turns.

    python3 benchmarks/torch_kernels_ab.py --parent DIR [--out FILE]
                                           [--kernels k1,k2,k3,routes]

``DIR`` holds another checkout's ``qpn_tpu_torch/csrc`` (for example
``git archive <commit> qpn_tpu_torch/csrc | tar -x -C DIR``): its
``lemke_pivot.cu``, ``eg_warmstart.cu`` and ``screen.cu`` are built with the
same nvcc flags as this checkout's and called through the wrappers' own
argument lists.  The script stops before it calls anything if the parent's C
interface (the parameter macros and the entry points' declarations) is not
this checkout's word for word.

On the flagship ensemble (robust_avoid, S=256, T=2, num_obj=1,
num_poly_faces=4, seed 0; n=38 per lane) it

* prints ``nvcc -Xptxas -v`` (registers, shared memory, spill) for this
  checkout's sources;
* holds old and new against the plain PyTorch version (K1: identical
  status and pivot counts; K2: z within 1e-4 of the lane scale at 20000
  steps), and fails otherwise;
* times old, new, new, old: median of 7 launches between CUDA events for
  each turn, and K1 also in a row of 20 launches;
* times both flagship routes (``solve_kkt_avi_batch`` and
  ``solve_avi_batch_adaptive(mixed=True, onchip_eg_steps=20000)``, tol 1e-8)
  with the old and the new kernels in turns old, new, new, old: median of 7
  warm calls each, host clock around a call that ends in a synchronize.

K3 runs on seeded polyhedra at three shapes: 4096 of 18 rows in dimension 18
(robust_avoid's piece shape), 81 of 1-18 rows (median 2) in dimension 26 (the
largest ``is_empty_batch`` batch of a robust_avoid solve) and 4 of 18 x 18;
old and new are held against the plain PyTorch loop (1e-4 of the scale) and
the new one to the bits of its g++ host instance, then timed old, new, new,
old, a launch alone and in a row of 20.

Every line carries the card's name and power limit.  The results are also
written as JSON to ``--out`` (default ``build/kernels_ab.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis  # noqa: E402
from qpn_tpu_torch.geometry import Poly  # noqa: E402
from qpn_tpu_torch.ops import (eg, eg_cuda, lemke, lemke_cuda,  # noqa: E402
                               screen, screen_cuda)
from qpn_tpu_torch.ops.avi import (batch_from_numpy,  # noqa: E402
                                   solve_avi_batch_adaptive,
                                   solve_kkt_avi_batch)
from qpn_tpu_torch.utils import cuda_build  # noqa: E402

HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)
EG_STEPS, EG_TOL = 20000, 1e-4
SOLVE_TOL = 1e-8
REPEATS = 7
KEYS = ("M", "q", "l", "u", "z0", "mask")
ORDER = ("old", "new", "new", "old")
# (source, header, what declares its C interface)
INTERFACES = (
    ("lemke_pivot.cu", "lemke_lane.cuh",
     r"#define QPN_LEMKE_PARAMS\(T\)(?:.*\\\n)*.*\n"
     r"|int qpn_lemke_pivot_f(?:32|64)\([^{]*\{"),
    ("eg_warmstart.cu", "eg_lane.cuh",
     r"#define QPN_EG_PARAMS(?:.*\\\n)*.*\n"
     r"|int qpn_eg_warmstart_f32\([^{]*\{"),
    ("screen.cu", "screen_lane.cuh",
     r"#define QPN_SCREEN_PARAMS(?:.*\\\n)*.*\n"
     r"|int qpn_screen_f32\([^{]*\{"),
)
SCREEN_STEPS, SCREEN_LR, SCREEN_TOL = 120, 0.05, 1e-4
# (label, polyhedra, most rows, dimension, ragged row counts)
SCREEN_SHAPES = (("B=4096 18x18", 4096, 18, 18, False),
                 ("B=81 1-18x26", 81, 18, 26, True),
                 ("B=4 18x18", 4, 18, 18, False))


def device_ms(fn, repeats=REPEATS):
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def train_ms(fn, count=20, repeats=REPEATS):
    """Median ms per launch of ``count`` launches in a row between one pair
    of events: the host runs ahead of the card, so the wrapper's host time
    between two launches is hidden where it is shorter than the kernel."""
    return device_ms(lambda: [fn() for _ in range(count)], repeats) / count


def wall_ms(fn, repeats=REPEATS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def interface(csrc: Path, source: str, header: str, pattern: str):
    """The declarations of a kernel's C interface, whitespace squeezed."""
    text = (csrc / header).read_text() + (csrc / source).read_text()
    return [" ".join(m.replace("\\", " ").split())
            for m in re.findall(pattern, text)]


def check_interfaces(parent: Path) -> None:
    for source, header, pattern in INTERFACES:
        mine = interface(cuda_build.CSRC_DIR, source, header, pattern)
        theirs = interface(parent / "qpn_tpu_torch" / "csrc", source, header,
                           pattern)
        if not mine or mine != theirs:
            sys.exit(f"torch_kernels_ab: the C interface of {source} in "
                     f"{parent} is not this checkout's:\n  {theirs}\n  "
                     f"{mine}")


def parent_library(parent: Path, name: str, source: str, header: str):
    csrc = parent / "qpn_tpu_torch" / "csrc"
    so = cuda_build.build_library(
        f"parent_{name}", [csrc / source],
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS], [csrc / header])
    return ctypes.CDLL(str(so))


def old_lemke_engine(lib):
    """The parent's pivot kernel behind the wrapper's signature."""
    params = lemke_cuda._PARAMS + [ctypes.c_void_p]
    for fn in (lib.qpn_lemke_pivot_f32, lib.qpn_lemke_pivot_f64):
        fn.restype, fn.argtypes = ctypes.c_int, params

    def run(init, *, tol, piv_tol, max_pivots):
        lemke_cuda._INPUTS(init, "cuda")
        out = lemke_cuda._outputs(init)
        fn = (lib.qpn_lemke_pivot_f32 if init.T.dtype == torch.float32
              else lib.qpn_lemke_pivot_f64)
        rc = fn(*lemke_cuda._args(init, out, tol, piv_tol, max_pivots),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old lemke kernel: rc {rc}")
        return out
    return run


def old_eg_engine(lib):
    """The parent's extragradient kernel behind the wrapper's signature."""
    lib.qpn_eg_warmstart_f32.restype = ctypes.c_int
    lib.qpn_eg_warmstart_f32.argtypes = eg_cuda._PARAMS + [ctypes.c_void_p]

    def run(M, q, l, u, z0, tau, steps):
        eg_cuda._INPUTS((M, q, l, u, z0, tau), "cuda", steps=steps)
        out = torch.empty_like(z0)
        rc = lib.qpn_eg_warmstart_f32(
            *eg_cuda._args(M, q, l, u, z0, tau, out, steps),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old eg kernel: rc {rc}")
        return out
    return run


def old_screen_engine(lib):
    """The parent's screen kernel behind the wrapper's signature."""
    lib.qpn_screen_f32.restype = ctypes.c_int
    lib.qpn_screen_f32.argtypes = screen_cuda._PARAMS + [ctypes.c_void_p]

    def run(A, l, u, x0, steps, lr):
        screen_cuda._INPUTS((A, l, u, x0), "cuda", steps=steps)
        x_out = torch.empty_like(x0)
        v_out = torch.empty(A.shape[0], dtype=torch.float32, device=A.device)
        rc = lib.qpn_screen_f32(
            *screen_cuda._args(A, l, u, x0, x_out, v_out, steps, lr),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old screen kernel: rc {rc}")
        return x_out, v_out
    return run


def screen_inputs(B, m, n, ragged, device, seed=0):
    """Prepared inputs of seeded polyhedra near the origin, 30 % of the rows
    one-sided; with ``ragged`` the row counts are 1..m with median 2 (zero
    rows pad the batch)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    polys = []
    for b in range(B):
        mb = m
        if ragged and b:
            mb = int(min(m, 1 + rng.geometric(0.5)))
        A = rng.standard_normal((mb, n))
        ax = A @ (0.1 * rng.standard_normal(n))
        w = 0.5 + rng.random(mb)
        one = rng.random(mb) < 0.3
        low = one & (rng.random(mb) < 0.5)
        polys.append(Poly(A, np.where(low, -np.inf, ax - w),
                          np.where(one & ~low, np.inf, ax + w),
                          normalize=False, dedupe=False))
    return [torch.as_tensor(a, device=device)
            for a in screen.screen_prepare(polys)]


def ptxas_report(source: str) -> str:
    cmd = [cuda_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-c", "-o",
           os.devnull, str(cuda_build.CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    return proc.stderr


def turns(variants: dict):
    """Median ms of each variant for each of its turns in ``ORDER``."""
    out = {name: [] for name in variants}
    for name in ORDER:
        out[name].append(device_ms(variants[name]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=str(ROOT / "build" / "kernels_ab.json"))
    ap.add_argument("--kernels", default="k1,k2,k3,routes",
                    help="which parts to run, comma separated")
    ns = ap.parse_args()
    parts = set(ns.kernels.split(","))
    if not torch.cuda.is_available():
        sys.exit("torch_kernels_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__}

    for src in ("lemke_pivot.cu", "eg_warmstart.cu", "screen.cu"):
        rep = ptxas_report(src)
        print(f"---- ptxas -v {src}\n{rep}", flush=True)
        result[f"ptxas_{src}"] = rep
    parent = Path(ns.parent)
    check_interfaces(parent)
    old_k1 = old_lemke_engine(parent_library(parent, "lemke", "lemke_pivot.cu",
                                             "lemke_lane.cuh"))
    old_k2 = old_eg_engine(parent_library(parent, "eg", "eg_warmstart.cu",
                                          "eg_lane.cuh"))
    old_k3 = old_screen_engine(parent_library(parent, "screen", "screen.cu",
                                              "screen_lane.cuh"))
    lemke_cuda.build()
    eg_cuda.build()
    screen_cuda.build()

    dev = torch.device("cuda", 0)
    batch = scenario_batch_gavis(num_scenarios=256, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    data = batch_from_numpy(batch, dev)

    if "k1" in parts:
        time_k1(data, old_k1, result, card)
    if "k2" in parts:
        time_k2(data, old_k2, result, card)
    if "k3" in parts:
        time_k3(old_k3, dev, result, card)
    if "routes" in parts:
        time_routes(data, old_k1, old_k2, result, card)

    out = Path(ns.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}")


def time_k3(old_k3, dev, result, card) -> None:
    for label, B, m, n, ragged in SCREEN_SHAPES:
        ins = screen_inputs(B, m, n, ragged, dev)
        xp, vp = screen.screen_steps_torch(*ins, SCREEN_STEPS, SCREEN_LR)
        variants = {
            "old": lambda: old_k3(*ins, SCREEN_STEPS, SCREEN_LR),
            "new": lambda: screen_cuda.feasibility_screen_cuda(
                *ins, SCREEN_STEPS, SCREEN_LR)}
        errs = {}
        for name, fn in variants.items():
            x, v = fn()
            torch.cuda.synchronize()
            errs[name] = max(
                float(((x - xp).abs().amax(1)
                       / (1.0 + xp.abs().amax(1))).max()),
                float(((v - vp).abs() / (1.0 + vp)).max()))
            if not errs[name] <= SCREEN_TOL:
                sys.exit(f"K3 {label} {name}: differs from the plain loop by "
                         f"{errs[name]!r} of the scale")
        xh, vh = screen_cuda.screen_steps_host(*(a.cpu() for a in ins),
                                               SCREEN_STEPS, SCREEN_LR)
        if not (torch.equal(x.cpu(), xh) and torch.equal(v.cpu(), vh)):
            sys.exit(f"K3 {label}: the kernel's bits are not its host "
                     "instance's")
        ms = turns(variants)
        train = {k: train_ms(fn) for k, fn in variants.items()}
        t_plain = device_ms(lambda: screen.screen_steps_torch(
            *ins, SCREEN_STEPS, SCREEN_LR), 3)
        result[f"k3 {label}"] = {"ms": ms, "train_ms": train, "err": errs,
                                 "plain_ms": t_plain,
                                 "rows": ins[0].abs().amax(2).ne(0).sum(1)
                                 .float().median().item()}
        print(f"K3 {label} steps={SCREEN_STEPS}: old and new within "
              f"{SCREEN_TOL} of the plain loop ("
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + "), new equal to its host instance bit for bit; ms per "
              f"launch (two turns, median of {REPEATS}): "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in ms.items())
              + "; in a row of 20 launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in train.items())
              + f"; plain loop {t_plain:.4f} ms [{card}]", flush=True)


def time_k1(data, old_k1, result, card) -> None:
    for label, dtype, kw, lanes in (("f32", torch.float32, HOT, 256),
                                    ("f64", torch.float64, F64, 16)):
        M, q, l, u = (data[k][:lanes].to(dtype) for k in ("M", "q", "l", "u"))
        init = lemke.lemke_setup(M, q, l, u, torch.zeros_like(q),
                                 data["mask"][:lanes], tol=kw["tol"])
        plain = lemke.lemke_pivot_torch(init, **kw)
        variants = {"old": lambda: old_k1(init, **kw),
                    "new": lambda: lemke_cuda.lemke_pivot_cuda(init, **kw)}
        for name, fn in variants.items():
            res = fn()
            torch.cuda.synchronize()
            if not (torch.equal(res.status, plain.status)
                    and torch.equal(res.piv, plain.piv)):
                sys.exit(f"K1 {label} {name}: status or pivots differ from "
                         "the plain loop")
        ms = turns(variants)
        piv = int(plain.piv.sum()) + lanes
        train = {k: train_ms(fn) for k, fn in variants.items()}
        result[f"k1_{label}"] = {"ms": ms, "train_ms": train, "lanes": lanes,
                                 "pivot_iterations": piv,
                                 "max_pivots_a_lane": int(plain.piv.max()) + 1}
        print(f"K1 {label} B={lanes}: identical status and pivots, old and "
              f"new; ms per launch (two turns, median of {REPEATS}): "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in ms.items())
              + "; in a row of 20 launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in train.items())
              + f" [{card}]", flush=True)


def time_k2(data, old_k2, result, card) -> None:
    p = eg.eg_prepare(*(data[k] for k in KEYS))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    zp = eg.eg_steps_torch(*ins, EG_STEPS)
    variants = {"old": lambda: old_k2(*ins, EG_STEPS),
                "new": lambda: eg_cuda.eg_warmstart_cuda(*ins, EG_STEPS)}
    errs = {}
    for name, fn in variants.items():
        z = fn()
        torch.cuda.synchronize()
        err = float(((z - zp).abs().amax(1) / (1.0 + zp.abs().amax(1))).max())
        errs[name] = err
        if not err <= EG_TOL:
            sys.exit(f"K2 {name}: z differs from the plain loop by {err!r} "
                     "of the lane scale")
    ms = turns(variants)
    result["k2"] = {"ms": ms, "err": errs, "steps": EG_STEPS}
    print(f"K2 B=256 n=38 steps={EG_STEPS}: old and new within {EG_TOL} of "
          f"the plain loop (" + ", ".join(f"{k} {v:.3g}" for k, v in
                                          errs.items())
          + f"); ms per launch (two turns, median of {REPEATS}): "
          + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in ms.items())
          + f" [{card}]", flush=True)



def time_routes(data, old_k1, old_k2, result, card) -> None:
    """The two flagship routes, old and new kernels in turns."""
    new_k1, new_k2 = lemke_cuda.lemke_pivot_cuda, eg_cuda.eg_warmstart_cuda
    kkt_args = (data["M"], data["q"], data["l"], data["u"], data["mask"],
                data["structure"])
    gen_args = [data[k] for k in KEYS]
    routes = {"kkt": [], "generic": []}
    for which in ORDER:
        lemke_cuda.lemke_pivot_cuda = old_k1 if which == "old" else new_k1
        eg_cuda.eg_warmstart_cuda = old_k2 if which == "old" else new_k2
        try:
            res = solve_kkt_avi_batch(*kkt_args, tol=SOLVE_TOL)
            gen = solve_avi_batch_adaptive(*gen_args, tol=SOLVE_TOL,
                                           mixed=True,
                                           onchip_eg_steps=EG_STEPS)
            if not (bool(res.converged.all()) and bool(gen.converged.all())):
                sys.exit(f"routes with the {which} kernels: not every lane "
                         "certified")
            t_kkt = wall_ms(lambda: solve_kkt_avi_batch(*kkt_args,
                                                        tol=SOLVE_TOL))
            t_gen = wall_ms(lambda: solve_avi_batch_adaptive(
                *gen_args, tol=SOLVE_TOL, mixed=True,
                onchip_eg_steps=EG_STEPS))
        finally:
            lemke_cuda.lemke_pivot_cuda = new_k1
            eg_cuda.eg_warmstart_cuda = new_k2
        routes["kkt"].append((which, t_kkt))
        routes["generic"].append((which, t_gen))
    result["routes_ms"] = routes
    for name, rows in routes.items():
        print(f"route {name} S=256 tol={SOLVE_TOL}: conv 1.0 every turn; "
              + ", ".join(f"{w} {t:.3f} ms ({256 / t * 1e3:.1f} solves/s)"
                          for w, t in rows)
              + f"; median of {REPEATS} warm calls each [{card}]", flush=True)


if __name__ == "__main__":
    main()
