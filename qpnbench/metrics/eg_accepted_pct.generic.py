"""eg_accepted_pct.generic (%, program counter): lanes of the generic route
whose residual the extragradient pre-pass lowered (``METRICS``
``eg_accepted_lanes``) over the lanes attempted in the window."""


def read(rec):
    if not rec.attempted:
        return None
    return rec.counters.get("eg_accepted_lanes", 0.0) / rec.attempted * 100.0
