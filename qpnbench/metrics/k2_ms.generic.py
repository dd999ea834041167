"""k2_ms.generic (ms, device trace): device time of the extragradient
kernel K2 (every kernel whose name starts with ``eg_``: its register,
cluster and global instances) per traced call."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    s = t.op_seconds("eg_")
    return s / t.calls * 1e3 if s > 0 else None
