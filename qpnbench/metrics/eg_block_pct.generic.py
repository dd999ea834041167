"""eg_block_pct.generic (%, program counter): lanes of the extragradient
pre-pass that K2's block instance ran (``METRICS`` ``eg_block_lanes``: one
block a lane, n = 129-238 on an H100) over the lanes of every K2 launch of
the window (``eg_lanes``).  Nothing where the program counts no K2
lanes."""


def read(rec):
    lanes = rec.counters.get("eg_lanes", 0.0)
    if not lanes:
        return None
    return rec.counters.get("eg_block_lanes", 0.0) / lanes * 100.0
