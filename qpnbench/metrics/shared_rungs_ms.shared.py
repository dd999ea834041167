"""shared_rungs_ms.shared (ms, program span): the shared-matrix route's
rungs a call, everything after the delta ladder and before the final audit:
the ADMM rung and its host polish, the ADMM route, the host least-squares
solves, the generic escalation (``METRICS`` ``time/qpn.shared.rungs``), over
the calls of the window.  The window's counters include its traced calls.
Nothing where the program records no such span."""


def read(rec):
    rungs = rec.counters.get("time/qpn.shared.rungs")
    if rungs is None or not rec.latencies:
        return None
    return rungs / len(rec.latencies) * 1e3
