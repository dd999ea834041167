"""hop_fused_pct.generic (%, program counter): lanes of the hybrid
solver's extragradient hops that the hand-written hop kernel ran (``METRICS``
``hop_fused_lanes``) over the lanes of every hop of the window
(``hop_lanes``).  Nothing where the program counts no hop lanes."""


def read(rec):
    lanes = rec.counters.get("hop_lanes", 0.0)
    if not lanes:
        return None
    return rec.counters.get("hop_fused_lanes", 0.0) / lanes * 100.0
