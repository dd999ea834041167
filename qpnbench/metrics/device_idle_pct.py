"""device_idle_pct (%, device trace): the traced window less the union of
the card's activity intervals (kernels, copies, sets), as a share of the
window."""


def read(rec):
    t = rec.trace
    if t is None or not t.ops:
        return None
    return (t.window_s - t.busy_s) / t.window_s * 100.0
