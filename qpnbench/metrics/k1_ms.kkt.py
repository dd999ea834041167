"""k1_ms.kkt (ms, device trace): device time of the pivot kernel K1 (every
kernel whose name starts with ``lemke_pivot``: its shared, cluster and
global instances, f32 and f64) per traced call."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    s = t.op_seconds("lemke_pivot")
    return s / t.calls * 1e3 if s > 0 else None
