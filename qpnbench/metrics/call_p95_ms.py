"""call_p95_ms (ms, host clock): the 95th percentile of every call of the
measured window, from the call to z and the certified flags on the host
(linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec.latencies), 95)) * 1e3
