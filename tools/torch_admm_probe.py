"""The batched ADMM's block kernel (``csrc/admm_block.cu``) on the card:
its build report, its time against the plain loop it replaces, and the
shared-matrix route with and without it.

    python3 tools/torch_admm_probe.py [--out chiprun_out/admm_probe.json]

On a CUDA card, on the QPs of the shared-matrix route's ADMM rung
(robust_avoid T=8, num_obj=4: n=96, m=256; ``tests/_torch_admm.py``):

1. ``nvcc -Xptxas -v`` of the kernel: registers, shared memory, spills of
   each row count;
2. one block (25 iterations) of a late block's inputs at B = 15 and B = 1:
   the kernel between CUDA events (median of 7 runs of 20 launches), its
   device time under ``torch.profiler``, and the plain loop's 25
   iterations of ``batch_qp._iterate`` (host clock, synchronized);
3. ``solve_qp_batch`` at the rung's two tolerances on 15 lanes, kernel and
   plain loop in turns: wall time, blocks, host syncs, statuses;
4. the KKT entry on the benchmark's n=608 ensemble of 1024 lanes
   (``tools/torch_sync_probe.py``'s row ``kkt_n608_s1024_shared``), kernel
   and plain loop in turns: call time, the spans ``qpn.shared.*``, host
   syncs and ADMM blocks a call.
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
sys.path.insert(0, str(ROOT / "tests"))


def ptxas() -> list[str]:
    from qpn_tpu_torch.utils.cuda_build import CSRC_DIR, nvcc_path
    out = subprocess.run(
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-c", "-o",
         "/dev/null", str(CSRC_DIR / "admm_block.cu")],
        capture_output=True, text=True)
    return [ln.strip() for ln in out.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def event_ms(fn, launches=20, runs=7) -> float:
    import torch
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def wall_ms(fn, runs=5) -> float:
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, name) -> float:
    """Device time of the kernels whose name holds ``name`` in one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0.0)
               for e in prof.key_averages() if name in e.key) / 1e3


def blocks(dev, report):
    import torch
    from _torch_admm import capture_blocks, plain_block, shared_qps
    from qpn_tpu_torch.ops import admm_cuda
    _, seen = capture_blocks(shared_qps(15, dev), eps=1e-4, polish=False)
    tensors, sigma, alpha, iters = seen[min(10, len(seen) - 1)]
    kw = dict(sigma=sigma, alpha=alpha, iters=iters)
    for B in (15, 1):
        ins = [t[:B].clone() for t in tensors]
        def k():
            admm_cuda.admm_block_cuda(*ins, **kw)
        row = {"kernel_ms": event_ms(k),
               "kernel_device_ms": device_ms(k, "admm_block_kernel")}

        def plain():
            plain_block(*ins, **kw)
        row["plain_ms"] = wall_ms(plain)
        row["plain_device_ms"] = device_ms(plain, "")
        fresh = [t[:B].clone() for t in tensors]
        got = admm_cuda.admm_block_cuda(*[t.clone() for t in fresh], **kw)
        want = plain_block(*[t.clone() for t in fresh], **kw)
        row["max_rel_vs_plain"] = max(
            float(((g - w).abs() / (1 + w.abs().amax(1, keepdim=True))).max())
            for g, w in zip(got, want))
        report["block"][f"B{B}"] = row
        print("block B=%d" % B, json.dumps(row), flush=True)
    del torch


def solves(dev, report):
    import torch
    from _torch_admm import shared_qps
    from qpn_tpu_torch.ops import batch_qp
    from qpn_tpu_torch.utils.metrics import METRICS
    qps = shared_qps(15, dev)
    plain = lambda *a: None  # noqa: E731
    real = batch_qp._fused_block
    out = {}
    for turn, pick in (("kernel", real), ("plain", plain), ("kernel2", real),
                       ("plain2", plain)):
        batch_qp._fused_block = pick
        try:
            c0 = dict(METRICS.counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols = [batch_qp.solve_qp_batch(**qps, eps=eps, polish=False)
                    for eps in (1e-4, 1e-6)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
        finally:
            batch_qp._fused_block = real
        c = {k: v - c0.get(k, 0.0) for k, v in METRICS.counters.items()}
        out[turn] = {"ms": dt, "blocks": c.get("admm_blocks", 0.0),
                     "fused": c.get("admm_fused_blocks", 0.0),
                     "host_syncs": c.get("host_syncs", 0.0),
                     "status": [s.status.tolist() for s in sols],
                     "iters": [s.iters.tolist() for s in sols]}
        print("solve_qp_batch 15 lanes", turn, json.dumps(
            {k: v for k, v in out[turn].items() if k not in ("status",
                                                             "iters")}),
            flush=True)
    out["same_status"] = out["kernel"]["status"] == out["plain"]["status"]
    out["same_iters"] = out["kernel"]["iters"] == out["plain"]["iters"]
    print("same status", out["same_status"], "same iterations",
          out["same_iters"], flush=True)
    report["solve"] = out


def route(dev, report):
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import avi, batch_qp
    from qpn_tpu_torch.utils.metrics import METRICS
    b = scenario_batch_gavis(num_scenarios=1024, T=8, num_obj=4,
                             num_poly_faces=4, seed=0)
    t = avi.batch_from_numpy(b, dev)

    def call():
        return avi.solve_kkt_avi_batch(t["M"], t["q"], t["l"], t["u"],
                                       t["mask"], t["structure"], tol=1e-8)
    real = batch_qp._fused_block
    plain = lambda *a: None  # noqa: E731
    call()
    out = {}
    for turn, pick in (("kernel", real), ("plain", plain), ("kernel2", real),
                       ("plain2", plain)):
        batch_qp._fused_block = pick
        try:
            call()
            c0 = dict(METRICS.counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [call() for _ in range(2)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 2 * 1e3
        finally:
            batch_qp._fused_block = real
        c = {k: (v - c0.get(k, 0.0)) / 2 for k, v in METRICS.counters.items()}
        row = {"call_ms": dt,
               "converged": min(float(r.converged.double().mean())
                                for r in res),
               "resid_max": max(float(r.resid.max()) for r in res),
               **{k: c.get(k, 0.0) for k in (
                   "host_syncs", "admm_blocks", "admm_fused_blocks",
                   "admm_lanes")},
               **{k[5:] + "_ms": v * 1e3 for k, v in sorted(c.items())
                  if k.startswith("time/qpn.shared")
                  or k == "time/qpn.kkt.shared"}}
        out[turn] = row
        print("route n=608 S=1024", turn, json.dumps(row), flush=True)
    report["route"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/admm_probe.json")
    ap.add_argument("--skip-route", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "torch": torch.__version__, "block": {}}
    report["ptxas"] = ptxas()
    print("\n".join(report["ptxas"]), flush=True)
    blocks(dev, report)
    solves(dev, report)
    if not args.skip_route:
        route(dev, report)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
