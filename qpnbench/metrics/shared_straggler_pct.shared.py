"""shared_straggler_pct.shared (%, program counter): lanes of the
shared-matrix route that its first policy round left uncertified
(``METRICS`` ``shared_round0_left``), which go on to the ladder and the
rungs, over the lanes attempted in the window.  Nothing where the program
counts no such lanes."""


def read(rec):
    left = rec.counters.get("shared_round0_left")
    if left is None or not rec.attempted:
        return None
    return left / rec.attempted * 100.0
