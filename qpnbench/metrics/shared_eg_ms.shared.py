"""shared_eg_ms.shared (ms, program span): the shared-matrix route's
extragradient pre-pass a call, its per-chunk reads and the fetch of z
included (``METRICS`` ``time/qpn.shared.eg``), over the calls of the window.
The window's counters include its traced calls.  Nothing where the program
records no such span."""


def read(rec):
    eg = rec.counters.get("time/qpn.shared.eg")
    if eg is None or not rec.latencies:
        return None
    return eg / len(rec.latencies) * 1e3
