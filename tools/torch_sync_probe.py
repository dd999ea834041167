"""Where the port's two ensemble routes wait on the card, and what their spans
cost.

    python3 tools/torch_sync_probe.py [--out build/sync_probe.json]

On a CUDA card.  For one call of each route (the KKT route at n=38 and
n=190 and with every straggler branch forced, the generic route at n=38
with 20000 extragradient steps, the KKT entry's shared-matrix route at
n=608 on 1024 lanes, whose replicated M takes 3 GB of the card; robust_avoid
ensembles of ``models/robust_avoid.scenario_batch_gavis``):

1. the sync warnings of ``torch.cuda.set_sync_debug_mode("warn")`` against
   the rise of ``METRICS`` ``host_syncs``, each warning by the line of the
   program that raised it;
2. under ``torch.profiler``, every CUDA runtime call that can block the host
   (stream, event and device synchronizations, blocking copies, frees and
   allocations), by the innermost host operation and ``qpn.*`` span around
   it: a library call that waits inside itself shows here even where PyTorch
   does not warn;
3. the spans and syncs a call records, their cost on this host (``timeit``
   of an empty span, of the sync helper around a no-op, of a tensor bump),
   and the untraced call time, for the estimate of the instrumentation's
   share of a call; and the call time again once the process has run the
   profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import timeit
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D", "cudaFree",
            "cudaMalloc", "cudaFreeHost", "cudaHostAlloc", "cudaMallocHost",
            "cudaStreamWaitEvent", "cuStreamSynchronize", "cuCtxSynchronize",
            "cuMemFree", "cuMemAlloc", "cuMemcpyDtoH")
# library calls that may wait inside themselves: each call's shapes and the
# blocking runtime calls it holds
LIBRARY = ("aten::linalg_lu_factor_ex", "aten::_cholesky_solve_helper",
           "aten::linalg_cholesky_ex", "aten::linalg_lu_solve")


def routes(device):
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import avi

    def data(S, T, K):
        b = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=K,
                                 num_poly_faces=4, seed=0)
        return avi.batch_from_numpy(b, device)

    def kkt(t, tol):
        return lambda: avi.solve_kkt_avi_batch(
            t["M"], t["q"], t["l"], t["u"], t["mask"], t["structure"],
            tol=tol)

    def generic(t):
        return lambda: avi.solve_avi_batch_adaptive(
            t["M"], t["q"], t["l"], t["u"], t["z0"], t["mask"], tol=1e-8,
            onchip_eg_steps=20000)
    d38, d38w, d190 = data(16, 2, 1), data(256, 2, 1), data(256, 5, 2)
    del torch
    return {"kkt_n38_s16": kkt(d38, 1e-8),
            "kkt_n38_s64": kkt(data(64, 2, 1), 1e-8),
            "kkt_n38_s128": kkt(data(128, 2, 1), 1e-8),
            "kkt_n38_s256": kkt(d38w, 1e-8),
            "kkt_n190_s256": kkt(d190, 1e-8),
            "kkt_n38_s16_stragglers": kkt(d38, 1e-300),
            "generic_n38_s16": generic(d38),
            "generic_n38_s256": generic(d38w),
            "kkt_n608_s1024_shared": kkt(data(1024, 8, 4), 1e-8)}


def counters():
    from qpn_tpu_torch.utils.metrics import METRICS
    return dict(METRICS.counters)


def delta(c0, c1):
    return {k: v - c0.get(k, 0.0) for k, v in c1.items()
            if v - c0.get(k, 0.0)}


def sync_warnings(fn):
    import torch
    c0 = counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    d = delta(c0, counters())
    found = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    where = Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    for w in found)
    return {"warnings": len(found), "host_syncs": d.get("host_syncs", 0.0),
            "by_line": dict(where.most_common())}


def innermost(spans, t):
    """The innermost (name) of nested spans [(start, end, name)] holding t."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best[2] if best else None


def blocking_calls(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in xs if e.get("cat") == "cpu_op"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith("qpn.")]
    runtime = Counter()
    blocking = Counter()
    stamps = []
    for e in xs:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        runtime[e["name"]] += 1
        if e["name"] in BLOCKING:
            t = float(e["ts"])
            stamps.append((t, e["name"]))
            blocking[(e["name"], innermost(ops, t) or "-",
                      innermost(spans, t) or "-")] += 1
    library = Counter()
    for e in xs:
        if e.get("cat") == "cpu_op" and e["name"] in LIBRARY:
            s0 = float(e["ts"])
            s1 = s0 + float(e.get("dur", 0))
            held = sorted(Counter(n for t, n in stamps
                                  if s0 <= t <= s1).items())
            dims = json.dumps(e.get("args", {}).get("Input Dims"))
            library[(e["name"], dims, json.dumps(held),
                     innermost(spans, s0) or "-")] += 1
    return {"runtime_calls": dict(runtime.most_common()),
            "blocking": [[*k, v] for k, v in blocking.most_common()],
            "library": [[*k, v] for k, v in sorted(library.items())],
            "span_names": sorted({n for _, _, n in spans})}


def costs():
    import torch
    from qpn_tpu_torch.utils.metrics import Metrics
    m = Metrics()
    n = 200000
    empty = timeit.timeit(lambda: None, number=n) / n

    def span():
        with m.timer("qpn.probe"):
            pass
    out = {"span_s": timeit.timeit(span, number=n) / n - empty,
           "sync_helper_s": timeit.timeit(lambda: m.sync(len, ()),
                                          number=n) / n
           - timeit.timeit(lambda: len(()), number=n) / n}
    flag = torch.zeros(256, dtype=torch.bool, device="cuda")
    k = 20000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        m.bump("probe", flag)
    out["tensor_bump_s"] = (time.perf_counter() - t0) / k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        int(flag.sum())
    out["int_sum_read_s"] = (time.perf_counter() - t0) / k
    return out


def call_time(fn, calls):
    import torch
    c0 = counters()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / calls
    return dt, {k: v / calls for k, v in delta(c0, counters()).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/sync_probe.json")
    args = ap.parse_args()
    import torch
    import torch.autograd.profiler as ap_
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": smi,
              "profiler_flag": hasattr(ap_, "_is_profiler_enabled"),
              "routes": {}}
    # costs and untraced calls first: a process that has run the profiler
    # with CUDA activity stays slower after it (the traced part below)
    report["costs"] = costs()
    print("costs", json.dumps(report["costs"]), flush=True)
    fns = routes(dev)
    calls = {name: 3 if any(k in name for k in ("stragglers", "generic",
                                                 "shared")) else 30
             for name in fns}
    for name, fn in fns.items():
        fn()
        fn()
        torch.cuda.synchronize()
        dt, per_call = call_time(fn, calls[name])
        report["routes"][name] = {"call_s": dt, "per_call": per_call,
                                  "sync": sync_warnings(fn)}
        print(name, json.dumps({"call_ms": dt * 1e3,
                                **report["routes"][name]["sync"]}),
              flush=True)
        print("   per call", json.dumps(per_call), flush=True)
    for name, fn in fns.items():
        row = report["routes"][name]
        # the forced stragglers' ADMM makes a trace of ~1e5 events: not read
        row["trace"] = ({"blocking": []} if "stragglers" in name
                        else blocking_calls(fn))
        print(name, "blocking", json.dumps(row["trace"]["blocking"][:12]),
              flush=True)
        for lib in row["trace"].get("library", []):
            print("   ", json.dumps(lib), flush=True)
    for name, fn in fns.items():
        row = report["routes"][name]
        row["call_s_after_profile"], _ = call_time(fn, calls[name])
        print(name, "call ms untraced %.4f, after a profile %.4f" % (
            row["call_s"] * 1e3, row["call_s_after_profile"] * 1e3),
            flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
