"""host_dispatch_ms.kkt (ms, program span): the host's time in the KKT
route while it does not wait on the card, a call: the span over the entry
(``METRICS`` ``time/qpn.kkt``) less the blocked reads inside it
(``time/qpn.sync``), over the calls of the window.  The window's counters
include its traced calls, whose profiler ranges add host time.  Nothing
where the program records no span."""


def read(rec):
    route = rec.counters.get("time/qpn.kkt")
    if route is None or not rec.latencies:
        return None
    waits = rec.counters.get("time/qpn.sync", 0.0)
    return (route - waits) / len(rec.latencies) * 1e3
