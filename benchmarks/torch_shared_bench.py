#!/usr/bin/env python3
"""The port's shared-matrix route (``qpn_tpu_torch/ops/shared_kkt.py``) on
one NVIDIA GPU, at the three rows the JAX package's records name for it:

    python3 benchmarks/torch_shared_bench.py [--rows large,hard,t16]
                                             [--out FILE]

* ``large``: robust_avoid T=8, num_obj=4, num_poly_faces=4, S=1024, seed 0
  (n=608 per lane);
* ``hard``: the same model at seed 2, S=512 (the dual-degenerate class that
  goes to the ADMM rung);
* ``t16``: T=16, S=512, seed 7 (n=1216 per lane).

Each row is solved at tol 1e-8 through ``solve_kkt_avi_shared`` from tensors
already on the card: one cold call, then the median, least and most of three
warm calls (host clock around a call that ends in a synchronize), every lane
certified and re-audited in numpy, with the route's ``stats`` and
``phase_t``, its rung counters, and the peak device memory of a call.

With the large row come three extra measurements: round 0 as the route
runs it (f32 LU and f64 refinement) beside a plain f64 LU of the same basis
matrices; the extragradient pre-pass with plain f32 GEMMs beside TF32 ones
(time, and how many labels and lanes differ); and ``torch.profiler`` over
200 pre-pass steps (launches, and the share of the wall time in which the
card was busy).

Every line carries the card's name and power limit; the results are also
written as JSON to ``--out`` (default ``build/shared_bench.json``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis  # noqa: E402
from qpn_tpu_torch.ops import shared_kkt  # noqa: E402
from qpn_tpu_torch.ops.avi import batch_from_numpy  # noqa: E402
from qpn_tpu_torch.utils.metrics import METRICS  # noqa: E402

TOL = 1e-8
ROWS = {
    "large": dict(num_scenarios=1024, T=8, num_obj=4, num_poly_faces=4,
                  seed=0),
    "hard": dict(num_scenarios=512, T=8, num_obj=4, num_poly_faces=4, seed=2),
    "t16": dict(num_scenarios=512, T=16, num_obj=4, num_poly_faces=4, seed=7),
}
RUNGS = ("shared_kkt_chip_admm_rung", "shared_kkt_admm_escalation",
         "shared_kkt_generic_escalation")


def synced(fn):
    """(result, seconds) of fn(), the clock stopped after a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_row(name, cfg, card):
    batch = scenario_batch_gavis(**cfg)
    M0 = batch["M"][0]
    # the one shared matrix goes to the card, not its S copies
    t = batch_from_numpy({k: (v[:1] if k == "M" else v)
                          for k, v in batch.items()})
    S, n = t["q"].shape

    def solve(stats=None, **kw):
        return shared_kkt.solve_kkt_avi_shared(
            t["M"], t["q"], t["l"], t["u"], t["mask"], tol=TOL,
            structure=t["structure"], stats=stats, **kw)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    METRICS.reset()
    stats = {}
    res, cold = synced(lambda: solve(stats))
    peak = torch.cuda.max_memory_allocated()
    rungs = {k: int(METRICS.counters[k]) for k in RUNGS}
    z = res.z.cpu().numpy()
    F = z @ M0.T + batch["q"]
    resid = np.abs(z - np.clip(z - F, batch["l"], batch["u"])).max(axis=1)
    conv = float(res.converged.double().mean())
    if conv != 1.0 or not resid.max() <= TOL:
        sys.exit(f"{name}: conv {conv}, max residual {resid.max()!r}")
    warm = [synced(solve)[1] for _ in range(3)]
    row = dict(config=cfg, S=S, n=n, conv=conv, max_resid=float(resid.max()),
               cold_s=cold, warm_s=warm,
               solves_per_s=S / statistics.median(warm),
               rungs=rungs, stats=stats, peak_bytes=peak, base_bytes=base)
    print(f"{name}: S={S} n={n} conv {conv} max resid {resid.max():.3g}; "
          f"cold {cold:.3f} s, warm median {statistics.median(warm):.3f} s "
          f"({min(warm):.3f}-{max(warm):.3f}), "
          f"{S / statistics.median(warm):.1f} solves/s; rungs {rungs}; "
          f"stats {json.dumps(stats)}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    return row, batch, t


def lu_extras(batch, t, card):
    """Round 0 as the route runs it beside a plain f64 LU of the same basis
    matrices, from the labels of a real pre-pass."""
    f32, f64 = torch.float32, torch.float64
    M64 = t["M"][0]
    M32 = M64.to(f32)
    Q, L, U = t["q"], t["l"], t["u"]
    S, n = Q.shape
    scale = 1.0 + float(np.abs(batch["q"]).max())
    Lip = float(np.linalg.norm(batch["M"][0], 2))
    Z = torch.clamp(torch.zeros(S, n, dtype=f32, device=Q.device),
                    L.to(f32), U.to(f32))
    _, _, at_l, at_u = shared_kkt._eg_steps(
        M32.T.contiguous(), Q.to(f32), L.to(f32), U.to(f32), Z,
        np.float32(0.9 / Lip), 2000, float(np.float32(1e-4 * scale)))

    def mixed():
        return shared_kkt._round0_solve(M32, M64, at_l, at_u, Q, L, U, 1)

    def plain64():
        free = ~(at_l | at_u)
        bval = torch.where(at_l, torch.where(torch.isfinite(L), L, 0.0),
                           torch.where(torch.isfinite(U), U, 0.0))
        buf = torch.where(free[:, None, :], M64.T[None],
                          torch.eye(n, dtype=f64, device=Q.device))
        lu, piv, info = torch.linalg.lu_factor_ex(buf.mT)
        z = torch.linalg.lu_solve(
            lu, piv, torch.where(free, -Q, bval)[:, :, None])[:, :, 0]
        z = torch.where((info == 0)[:, None], z, torch.nan)
        return z, shared_kkt._nat_resid(z, z @ M64.T + Q, L, U)

    out = {}
    for label, fn in (("f32_lu_f64_refine", mixed), ("f64_lu", plain64)):
        fn()
        times = [synced(fn)[1] for _ in range(3)]
        rn = fn()[1]
        out[label] = dict(seconds=times,
                          certified=int((rn <= TOL).sum()),
                          non_finite=int(torch.isinf(rn).sum()))
    print(f"round 0 on {S} lanes of n={n} from the labels of 2000 pre-pass "
          "steps: " + "; ".join(
              f"{k} {statistics.median(v['seconds']):.3f} s (median of 3), "
              f"{v['certified']} lanes certified, {v['non_finite']} singular"
              for k, v in out.items()) + f" [{card}]", flush=True)
    return out


def tf32_extras(batch, t, card):
    """The pre-pass with plain f32 GEMMs and with TF32 ones."""
    f32 = torch.float32
    M32 = t["M"][0].to(f32)
    Q, L, U = (t[k].to(f32) for k in ("q", "l", "u"))
    S, n = Q.shape
    scale = 1.0 + float(np.abs(batch["q"]).max())
    Lip = float(np.linalg.norm(batch["M"][0], 2))
    Z = torch.clamp(torch.zeros(S, n, dtype=f32, device=Q.device), L, U)
    args = (M32.T.contiguous(), Q, L, U, Z, np.float32(0.9 / Lip), 2000, 10,
            float(np.float32(1e-4 * scale)), max(TOL, 1e-5 * scale), S // 128)
    out, labels = {}, {}
    for prec in ("highest", "tf32"):
        with shared_kkt._matmul_precision(prec):
            shared_kkt._eg_run(*args)
            (_, r, at_l, at_u, k), secs = synced(
                lambda: shared_kkt._eg_run(*args))
        labels[prec] = (at_l, at_u)
        out[prec] = dict(seconds=secs, chunks=k, max_resid=float(r.max()))
    diff = ((labels["highest"][0] != labels["tf32"][0])
            | (labels["highest"][1] != labels["tf32"][1]))
    out["labels_differing"] = int(diff.sum())
    out["lanes_differing"] = int(diff.any(1).sum())
    stats = {}
    res = shared_kkt.solve_kkt_avi_shared(
        t["M"], t["q"], t["l"], t["u"], t["mask"], tol=TOL,
        structure=t["structure"], stats=stats, eg_prec="tf32")
    out["tf32_solve"] = dict(conv=float(res.converged.double().mean()),
                             stats=stats)
    print(f"pre-pass S={S} n={n}: f32 {out['highest']['seconds']:.3f} s in "
          f"{out['highest']['chunks']} chunks of 2000 steps, TF32 "
          f"{out['tf32']['seconds']:.3f} s in {out['tf32']['chunks']}; "
          f"{out['labels_differing']} labels differ on "
          f"{out['lanes_differing']} lanes; the whole solve with TF32: conv "
          f"{out['tf32_solve']['conv']}, stats {json.dumps(stats)} [{card}]",
          flush=True)
    return out


def profile_extras(batch, t, card):
    """torch.profiler over 200 pre-pass steps: launches and the card's busy
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    f32 = torch.float32
    M32 = t["M"][0].to(f32)
    Q, L, U = (t[k].to(f32) for k in ("q", "l", "u"))
    S, n = Q.shape
    Lip = float(np.linalg.norm(batch["M"][0], 2))
    Z = torch.clamp(torch.zeros(S, n, dtype=f32, device=Q.device), L, U)
    args = (M32.T.contiguous(), Q, L, U, Z, np.float32(0.9 / Lip), 200, 1e-3)
    shared_kkt._eg_steps(*args)
    _, plain = synced(lambda: shared_kkt._eg_steps(*args))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced(lambda: shared_kkt._eg_steps(*args))
    busy_us, launches, top = 0.0, 0, []
    on_card = torch.autograd.DeviceType.CUDA
    for ev in prof.key_averages():
        if ev.key == "cudaLaunchKernel":
            launches = ev.count
        # kernels only: an operator's entry repeats its kernels' device time
        if getattr(ev, "device_type", None) != on_card:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            busy_us += dev_us
            top.append((dev_us, ev.key, ev.count))
    top.sort(reverse=True)
    out = dict(steps=200, wall_s=wall, unprofiled_wall_s=plain,
               device_busy_s=busy_us / 1e6, launches=launches,
               top=[(k, us / 1e6, c) for us, k, c in top[:6]])
    share = (f"{busy_us / 1e6 / wall:.3f} of the profiled wall time"
             if busy_us > 0 else "not measured (no device time in the trace)")
    print(f"profile of 200 pre-pass steps S={S} n={n}: wall {wall:.4f} s "
          f"under the profiler, {plain:.4f} s without; {launches} "
          f"cudaLaunchKernel calls; card busy {busy_us / 1e6:.4f} s, {share}; "
          f"device kernels {out['top']} [{card}]", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="large,hard,t16")
    ap.add_argument("--out",
                    default=str(ROOT / "build" / "shared_bench.json"))
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_shared_bench: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "tol": TOL}
    out = Path(ns.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out.write_text(json.dumps(result, indent=1))

    for name in ns.rows.split(","):
        row, batch, t = run_row(name, ROWS[name], card)
        result[name] = row
        save()
        if name == "large":
            for key, fn in (("round0_lu", lu_extras), ("tf32", tf32_extras),
                            ("profile", profile_extras)):
                result[key] = fn(batch, t, card)
                save()
        del batch, t
        torch.cuda.empty_cache()
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
