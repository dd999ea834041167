"""The comparison that decides ``correct``: each answer's natural residual
on the reference's own statement of its lane,

    Φ(z) = z − clip(z − (M z + q), l, u),   resid = max |Φ(z)|,

in float64.  A lane is solved to the configuration's tolerance when its
residual is at most that tolerance; a non-finite z reads as infinite.
"""

from __future__ import annotations

import numpy as np


def residuals(M: np.ndarray, q: np.ndarray, l: np.ndarray, u: np.ndarray,
              z: np.ndarray) -> np.ndarray:
    """Per-lane max |Φ(z)|: M (n, n) shared by the lanes, q, l, u, z
    (lanes, n)."""
    z = np.asarray(z, dtype=np.float64)
    F = z @ M.T + q
    phi = np.abs(z - np.clip(z - F, l, u)).max(axis=1)
    return np.where(np.isfinite(z).all(axis=1) & np.isfinite(phi), phi,
                    np.inf)
