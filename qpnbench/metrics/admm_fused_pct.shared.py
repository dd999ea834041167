"""admm_fused_pct.shared (%, program counter): blocks of the batched ADMM
(``check_every`` iterations between two status checks) that the
hand-written block kernel ran (``METRICS`` ``admm_fused_blocks``) over every
block of the window (``admm_blocks``).  Nothing where no block ran, or where
the program does not count fused blocks."""


def read(rec):
    blocks = rec.counters.get("admm_blocks", 0.0)
    fused = rec.counters.get("admm_fused_blocks")
    if not blocks or fused is None:
        return None
    return fused / blocks * 100.0
