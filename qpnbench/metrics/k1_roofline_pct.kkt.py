"""k1_roofline_pct.kkt (%, device trace): the least time the card could
take for K1's work of a call, over K1's device time per call.  The work is
fixed by the configuration (``k1_pivots_per_lane``, counted once by the
benchmark's own plain pivoting, ``qpnbench/fixed_work.py``), never taken
from the program's pivot counts."""

from qpnbench import work


def read(rec):
    t = rec.trace
    if t is None:
        return None
    s = t.op_seconds("lemke_pivot") / t.calls
    if s <= 0:
        return None
    lanes = rec.mix["lanes"]
    least = work.least_s(
        work.k1_flops(rec.n, lanes, rec.config["k1_pivots_per_lane"]),
        work.k1_bytes(rec.n, lanes))
    return least / s * 100.0
