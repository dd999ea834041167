"""A copy of the benchmark's files at a size the CPU runs in seconds: a
temporary checkout root whose mixes take 8 lanes a call from a pool of 2,
check one ensemble drawn from the seed, and whose cells trace 2 calls."""

from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the pool of the small mixes
SMALL_POOL = 2


def small_root(tmp: Path, steps: int = 300) -> Path:
    """The copy under ``tmp``; returns its root."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "qpnbench", tmp / "qpnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for mix in (tmp / "qpnbench" / "mixes").glob("*.json"):
        d = json.loads(mix.read_text())
        d.update(lanes=8, pool=SMALL_POOL, check_ensembles=1)
        if "onchip_eg_steps" in d:
            d["onchip_eg_steps"] = steps
        mix.write_text(json.dumps(d))
    for cell in (tmp / "qpnbench" / "cells").glob("*.json"):
        d = json.loads(cell.read_text())
        d["trace_calls"] = 2
        cell.write_text(json.dumps(d))
    return tmp


@contextlib.contextmanager
def one_thread():
    """One PyTorch thread while the program runs on the CPU: test workers
    side by side would otherwise oversubscribe the cores many times."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
