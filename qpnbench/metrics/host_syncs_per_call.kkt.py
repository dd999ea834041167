"""host_syncs_per_call.kkt (count, program counter): the KKT route's
blocking device-to-host reads (``METRICS`` ``host_syncs``, bumped by
``METRICS.sync``) over the calls of the window.  The window's counters
include its traced calls, as its calls do.  Nothing where the program
counts no syncs."""


def read(rec):
    syncs = rec.counters.get("host_syncs")
    if syncs is None or not rec.latencies:
        return None
    return syncs / len(rec.latencies)
