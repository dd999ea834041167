"""k2_roofline_pct.generic (%, device trace): the least time the card could
take for K2's work of a call, over K2's device time per call.  The work is
the mix's ``onchip_eg_steps`` on every lane: lanes · steps · 2 · (2n² + 5n)
operations, its inputs read and output written once."""

from qpnbench import work


def read(rec):
    t = rec.trace
    if t is None:
        return None
    s = t.op_seconds("eg_") / t.calls
    if s <= 0:
        return None
    lanes = rec.mix["lanes"]
    least = work.least_s(
        work.k2_flops(rec.n, lanes, rec.mix["onchip_eg_steps"]),
        work.k2_bytes(rec.n, lanes))
    return least / s * 100.0
