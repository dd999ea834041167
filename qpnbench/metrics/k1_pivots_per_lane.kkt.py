"""k1_pivots_per_lane.kkt (pivots, program counter): the pivots K1 took a
lane in the window, the covering one included, as the program counts them
where its pivot engine returns (``METRICS`` ``k1_pivots`` over
``k1_lanes``): the f32 path's lanes and any f64 re-pivot's.  The window's
counters include its traced calls.  Set beside the configuration's fixed
``k1_pivots_per_lane``, which the roofline reads.  Nothing where the
program counts no pivots."""


def read(rec):
    lanes = rec.counters.get("k1_lanes")
    if not lanes:
        return None
    return rec.counters.get("k1_pivots", 0.0) / lanes
