"""Content-addressed cache for pure polyhedral queries (copy of
``qpn_tpu/geometry/query_cache.py``).

Emptiness, exemplar and support-function values are pure functions of a
poly's (A, l, u, strictness) content — and the equilibrium loop re-asks the
same questions constantly: pieces recur across outer iterations, the
intersection tree re-tests the same partial intersections, and remove_subsets
re-probes the same facets.  The reference pays one OSQP call per ask every
time; here repeat asks are host dictionary hits.

Keys quantize to 9 digits (far below every solver tolerance in play, far
above float noise).  The cache is bounded FIFO and process-wide: queries are
pure, so entries stay valid across solves and ensembles.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np


class QueryCache:
    def __init__(self, max_entries: int = 500_000):
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        v = self._d.get(key, _MISS)
        if v is _MISS:
            self.misses += 1
            return None
        self.hits += 1
        return v

    def put(self, key, value):
        d = self._d
        if key in d:
            return
        d[key] = value
        if len(d) > self.max_entries:
            d.popitem(last=False)

    def clear(self):
        self._d.clear()


class _Miss:
    pass


_MISS = _Miss()

#: process-wide cache; pure queries only — no invalidation needed
CACHE = QueryCache()


def poly_key(p) -> bytes:
    """Content hash of a poly, memoized on the instance (``_qkey`` slot).

    Rows are normalized by the Poly constructor but NOT sorted, so the hash
    runs over a row-sorted view — recurring pieces that differ only by row
    order (e.g. the same piece re-derived through a different intersection
    order) must produce equal keys or they always miss the cache."""
    k = getattr(p, "_qkey", None)
    if k is None:
        import hashlib
        rows = np.column_stack([
            np.round(p.A, 9),
            np.round(np.nan_to_num(p.l, neginf=-1e30), 9),
            np.round(np.nan_to_num(p.u, posinf=1e30), 9),
            p.strict_l.astype(np.float64), p.strict_u.astype(np.float64)])
        order = np.lexsort(rows.T[::-1]) if rows.shape[0] else ()
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(rows[order]).tobytes())
        k = h.digest()
        try:
            p._qkey = k
        except Exception:          # pragma: no cover - frozen instances
            pass
    return k


def dir_key(d) -> bytes:
    return np.round(np.asarray(d, dtype=np.float64), 9).tobytes()
