#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qpn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one Hopper card (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernel from the sources in this checkout (nvcc);
3. ensemble: the flagship scenario ensemble (robust_avoid, S=256, T=2,
   num_obj=1, num_poly_faces=4, seed 0; n=38 per lane), moved to the card;
4. the Lemke pivot kernel against its plain PyTorch version in f32 on all
   256 lanes: identical status and pivot counts, f64-refactorized residual
   at most 1e-9, refactorized z equal to 1e-9; median of 7 warm runs each,
   timed with CUDA events;
5. the same for the kernel's f64 instance on 16 lanes (tol 1e-11);
6. the main path, ``ops.avi.solve_kkt_avi_batch(..., tol=1e-8)``: every
   lane certified, the kernel's launch count above 0, the natural residual
   re-audited in numpy, z against the port's CPU path on 8 lanes; solves/s
   as the median of 7 warm runs, with the kernel and with the plain loop.

Then one JSON line for the kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
S, T_STEPS, NUM_OBJ, FACES, SEED = 256, 2, 1, 4, 0
HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)     # avi.py f32 route
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)   # straggler re-pivot
RESID_TOL = 1e-9      # refactorized natural residual of every pivot outcome
Z_TOL = 1e-9          # kernel vs plain, refactorized z (f64)
SOLVE_TOL = 1e-8      # the main path's certification tolerance
REPEATS = 7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, repeats=REPEATS):
    """Median wall seconds of ``repeats`` warm calls (one warm-up first),
    host clock around work that ends in a device synchronize."""
    fn()
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def device_timed(fn, device, repeats=REPEATS):
    """Median seconds of ``repeats`` warm calls (one warm-up first) between
    CUDA events recorded on the current stream around each call."""
    import torch
    if device.type != "cuda":
        return timed(fn, device, repeats)
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def compare_engines(data, lanes, dtype, kw, kernel, device):
    """Kernel vs plain pivot loop on the same setup: status and pivot counts
    equal on every lane, refactorized residual and z within tolerance.
    Returns (max |z_kernel - z_plain|, kernel s, plain s, kernel result)."""
    import torch
    from qpn_tpu_torch.ops import lemke
    from qpn_tpu_torch.ops.avi import natural_residual
    M, q, l, u = (data[k][:lanes] for k in ("M", "q", "l", "u"))
    vm = data["mask"][:lanes]
    init = lemke.lemke_setup(M.to(dtype), q.to(dtype), l.to(dtype),
                             u.to(dtype), torch.zeros_like(q, dtype=dtype),
                             vm, tol=kw["tol"])
    outs = {}
    for name, engine in (("kernel", kernel),
                         ("plain", lemke.lemke_pivot_torch)):
        res = engine(init, **kw)
        z, ok = lemke.refactor_batch(M, q, l, u, res.basis, res.val, vm)
        r = natural_residual(M, q, l, u, z, vm)
        if not bool(ok.all()) or not float(r.max()) <= RESID_TOL:
            fail(f"{name} {dtype}: refactorization ok on {int(ok.sum())}/"
                 f"{lanes} lanes, max residual {float(r.max())!r}")
        outs[name] = (res, z)
    (rk, zk), (rp, zp) = outs["kernel"], outs["plain"]
    if not torch.equal(rk.status, rp.status):
        bad = int((rk.status != rp.status).sum())
        fail(f"{dtype}: status differs on {bad} lanes")
    if not torch.equal(rk.piv, rp.piv):
        bad = int((rk.piv != rp.piv).sum())
        fail(f"{dtype}: pivot counts differ on {bad} lanes")
    err = float((zk - zp).abs().max())
    if not err <= Z_TOL:
        fail(f"{dtype}: refactorized z differs by {err!r}")
    t_k = device_timed(lambda: kernel(init, **kw), device)
    t_p = device_timed(lambda: lemke.lemke_pivot_torch(init, **kw), device)
    return err, t_k, t_p, rk


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "qpn_tpu_torch")):
        fail("the qpn_tpu_torch package is not next to chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import lemke_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_kkt_avi_batch
    from qpn_tpu_torch.utils.metrics import METRICS

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    lemke_cuda.build()
    print(f"build: csrc/lemke_pivot.cu in {time.perf_counter() - t0:.1f} s")

    # 3. ensemble
    batch = scenario_batch_gavis(num_scenarios=S, T=T_STEPS, num_obj=NUM_OBJ,
                                 num_poly_faces=FACES, seed=SEED)
    data = batch_from_numpy(batch, device)
    B, n = data["q"].shape
    print(f"ensemble: robust_avoid S={B} T={T_STEPS} num_obj={NUM_OBJ} "
          f"n={n} structure={data['structure']}")

    # 4. kernel vs plain, f32, all lanes
    err32, t_k32, t_p32, r32 = compare_engines(
        data, B, torch.float32, HOT, lemke_cuda.lemke_pivot_cuda, device)
    piv = r32.piv.double() + 1
    print(f"lemke_pivot f32 B={B} n={n}: status and pivots identical on all "
          f"lanes (pivots {int(piv.min())}-{int(piv.max())}, median "
          f"{float(piv.median()):.0f}), max |dz| {err32:.3g} <= {Z_TOL}; "
          f"kernel {t_k32 * 1e3:.4f} ms, plain {t_p32 * 1e3:.4f} ms "
          f"(median of {REPEATS}) [{card}]")

    # 5. kernel vs plain, f64 instance
    err64, t_k64, t_p64, _ = compare_engines(
        data, 16, torch.float64, F64, lemke_cuda.lemke_pivot_cuda, device)
    print(f"lemke_pivot f64 B=16 n={n}: status and pivots identical, max "
          f"|dz| {err64:.3g}; kernel {t_k64 * 1e3:.4f} ms, plain "
          f"{t_p64 * 1e3:.4f} ms [{card}]")

    # 6. main path
    args = (data["M"], data["q"], data["l"], data["u"], data["mask"],
            data["structure"])
    METRICS.reset()
    res = solve_kkt_avi_batch(*args, tol=SOLVE_TOL)
    torch.cuda.synchronize(device)
    launches = METRICS.launches[lemke_cuda.KERNEL]
    uncertified = METRICS.counters["kkt_uncertified_lanes"]
    if launches < 1:
        fail("the main path did not launch the lemke_pivot kernel")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != (B, n) or not np.isfinite(z).all():
        fail(f"z has shape {z.shape} or non-finite values")
    if conv != 1.0 or uncertified != 0:
        fail(f"conv {conv}, {uncertified} uncertified lanes")
    # re-audit on the host in numpy, f64: Φ(z) = z − clip(z − (Mz+q), l, u)
    M, q, l, u = batch["M"], batch["q"], batch["l"], batch["u"]
    F = np.einsum("bij,bj->bi", M, z) + q
    resid = np.abs(z - np.clip(z - F, l, u)).max(axis=1)
    if not resid.max() <= SOLVE_TOL:
        fail(f"numpy audit: max natural residual {resid.max()!r}")
    # small-input reference: the port's CPU path (plain loop) on 8 lanes
    cpu = batch_from_numpy({k: v[:8] if k != "structure" else v
                            for k, v in batch.items()}, "cpu")
    ref = solve_kkt_avi_batch(cpu["M"], cpu["q"], cpu["l"], cpu["u"],
                              cpu["mask"], cpu["structure"], tol=SOLVE_TOL)
    same = ref.iters.numpy() == res.iters[:8].cpu().numpy()
    dz = np.abs(ref.z.numpy() - z[:8])[same]
    if not same.any() or not dz.max() <= Z_TOL:
        fail(f"CPU reference: {same.sum()}/8 lanes with equal pivots, "
             f"max |dz| {dz.max() if dz.size else None}")
    t_kernel = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                     device)
    CONFIG.lemke_kernel = "torch"
    try:
        t_plain = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                        device)
    finally:
        CONFIG.lemke_kernel = "auto"
    print(f"main path solve_kkt_avi_batch S={B} tol={SOLVE_TOL}: conv "
          f"{conv}, max resid {resid.max():.3g}, {launches} kernel "
          f"launch(es), {int(uncertified)} uncertified; "
          f"{B / t_kernel:.1f} solves/s with the kernel "
          f"({t_kernel * 1e3:.3f} ms), {B / t_plain:.1f} solves/s with the "
          f"plain loop ({t_plain * 1e3:.3f} ms); CPU reference z within "
          f"{dz.max():.3g} on {int(same.sum())}/8 lanes [{card}]")

    print(json.dumps({"kernels": [{
        "name": lemke_cuda.KERNEL, "route": "cuda",
        "source": "qpn_tpu_torch/csrc/lemke_pivot.cu",
        "replaces": "qpn_tpu/ops/lemke_pallas.py:118",
        "launches": launches, "max_abs_err": err32,
        "ms": t_k32 * 1e3, "plain_ms": t_p32 * 1e3}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
