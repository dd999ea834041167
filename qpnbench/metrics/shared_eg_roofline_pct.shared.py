"""shared_eg_roofline_pct.shared (%, device trace): the least time the card
could take for a call's pre-pass products on the shared-matrix route
(``work_shared.py``: the (S, n) @ (n, n) float32 GEMMs the program ran,
``METRICS`` ``shared_eg_gemms``, over the window's calls, at the float32
peak), over those products' device time a traced call (the float32 GEMM
kernels launched most often, ``work_shared.eg_gemm_kernels``).  Nothing
without a trace, or where the program counts no such products."""

from qpnbench import work_shared


def read(rec):
    t = rec.trace
    gemms = rec.counters.get("shared_eg_gemms")
    if t is None or not gemms or not rec.latencies:
        return None
    s = work_shared.eg_gemm_seconds(t) / t.calls
    if s <= 0:
        return None
    least = work_shared.eg_least_s(rec.n, rec.mix["lanes"],
                                   gemms / len(rec.latencies))
    return least / s * 100.0
