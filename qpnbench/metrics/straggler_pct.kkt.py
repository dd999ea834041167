"""straggler_pct.kkt (%, program counter): lanes of the KKT route that the
f32 pivot path and the f64 refactorization left above the tolerance
(``METRICS`` ``kkt_polish_lanes``) over the lanes attempted in the
window."""


def read(rec):
    if not rec.attempted:
        return None
    return rec.counters.get("kkt_polish_lanes", 0.0) / rec.attempted * 100.0
