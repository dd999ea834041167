"""Checkpoint / resume for long equilibrium runs (the port's copy of
``qpn_tpu/utils/checkpoint.py``; numpy and ``.npz`` only, so a checkpoint
written by either package loads in the other).

The reference has none (SURVEY.md §5: warm starts only).  Long enumerations
(deep nets, wide piece frontiers) need restartability: this module serializes
the solver state — iterate x, per-level cycling fingerprints, and full
solution-graph unions (every polyhedral piece as dense H-rep tensors) — into
one ``.npz`` with a JSON manifest, loadable into a warm resume.

``solve(qpn, ..., checkpoint_path=...)`` saves after every level-1 outer
iteration; ``resume(qpn, path)`` continues from the stored iterate.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..geometry.poly import Poly, PolyUnion


def _poly_to_entry(store: dict, prefix: str, p: Poly) -> dict:
    store[f"{prefix}_A"] = p.A
    store[f"{prefix}_l"] = p.l
    store[f"{prefix}_u"] = p.u
    store[f"{prefix}_sl"] = p.strict_l
    store[f"{prefix}_su"] = p.strict_u
    return {"prefix": prefix, "m": int(p.m), "dim": int(p.dim)}


def _poly_from_entry(data, entry) -> Poly:
    pre = entry["prefix"]
    # dedupe=False too: a loaded poly must reproduce the saved rows EXACTLY —
    # re-running the 5-digit quantized dedup could drop rows the saved poly
    # deliberately kept (intersect() builds with dedupe=False), making the
    # resumed run operate on different geometry than was checkpointed
    return Poly(data[f"{pre}_A"], data[f"{pre}_l"], data[f"{pre}_u"],
                data[f"{pre}_sl"], data[f"{pre}_su"], normalize=False,
                dedupe=False)


def save_state(path: str, x, Sol: Optional[Dict[int, PolyUnion]] = None,
               iterate_cache: Optional[Dict] = None, meta: Optional[dict] = None):
    store: dict = {"x": np.asarray(x, dtype=np.float64)}
    manifest: dict = {"meta": meta or {}, "sol": {}, "cache_levels": []}
    if Sol:
        for node, pu in Sol.items():
            if pu is None:
                continue
            entries = []
            for i, p in enumerate(pu):
                entries.append(_poly_to_entry(store, f"sol_{node}_{i}", p))
            manifest["sol"][str(node)] = entries
    if iterate_cache:
        for level, vals in iterate_cache.items():
            manifest["cache_levels"].append(int(level))
            store[f"cache_{level}"] = (np.stack(vals) if vals
                                       else np.zeros((0, 0)))
    store["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    # atomic replace: save_state runs every outer iteration OVER the
    # previous checkpoint — a kill mid-write would otherwise corrupt the
    # only copy, exactly the failure checkpointing exists to survive
    final = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    tmp = final + f".tmp{os.getpid()}.npz"   # savez appends .npz otherwise
    np.savez_compressed(tmp, **store)
    os.replace(tmp, final)


def load_state(path: str):
    data = np.load(path if str(path).endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    manifest = json.loads(bytes(data["manifest"]).decode())
    x = data["x"]
    Sol: Dict[int, PolyUnion] = {}
    for node, entries in manifest["sol"].items():
        Sol[int(node)] = PolyUnion([_poly_from_entry(data, e)
                                    for e in entries])
    cache: Dict[int, list] = {}
    for level in manifest["cache_levels"]:
        arr = data[f"cache_{level}"]
        cache[level] = [arr[i] for i in range(arr.shape[0])] \
            if arr.size else []
    return dict(x=x, Sol=Sol, iterate_cache=cache, meta=manifest["meta"])


def resume(qpn, path: str, **solve_kwargs):
    """Warm-resume a solve from a checkpoint."""
    from ..algorithm import solve
    state = load_state(path)
    qpn.iterate_cache.update(state["iterate_cache"])
    return solve(qpn, state["x"], checkpoint_path=path, **solve_kwargs)


class FrontierStore:
    """Per-enumerator frontier persistence (SURVEY §5 checkpoint target).

    Each ``LocalGAVISolutions`` enumerator is keyed by a content hash of its
    GAVI and seed point; every generation of its frontier expansion is
    persisted as one ``.npz`` under ``dir``.  A resumed solve re-creates the
    same enumerators (same GAVIs, same iterates), finds their keys here, and
    continues piece discovery from the stored frontier instead of from
    scratch."""

    def __init__(self, directory: str):
        import os
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        import os
        return os.path.join(self.dir, f"frontier_{key}.npz")

    def save(self, key: str, state: dict):
        store = {
            "unexplored_Ks": state["unexplored_Ks"],
            "explored_Ks": state["explored_Ks"],
            "unexplored_vertices": state["unexplored_vertices"],
            "explored_vertices": state["explored_vertices"],
            "n_polys": np.asarray(len(state["polys"])),
        }
        for i, p in enumerate(state["polys"]):
            for f in ("A", "l", "u", "sl", "su"):
                store[f"poly_{i}_{f}"] = p[f]
        tmp = self._path(key) + ".tmp.npz"
        np.savez_compressed(tmp, **store)
        import os
        os.replace(tmp, self._path(key))       # atomic vs mid-write kills

    def load(self, key: str):
        import os
        path = self._path(key)
        if not os.path.exists(path):
            return None
        data = np.load(path, allow_pickle=False)
        polys = []
        for i in range(int(data["n_polys"])):
            polys.append({f: data[f"poly_{i}_{f}"]
                          for f in ("A", "l", "u", "sl", "su")})
        return dict(unexplored_Ks=data["unexplored_Ks"],
                    explored_Ks=data["explored_Ks"],
                    unexplored_vertices=data["unexplored_vertices"],
                    explored_vertices=data["explored_vertices"],
                    polys=polys)
