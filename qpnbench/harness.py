"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

Every piece is found by name from ``BENCHMARK.json``: the cell's entry names
its configuration and traffic mix; ``qpnbench/cells/<cell>.json`` holds what
belongs to the cell alone, ``qpnbench/mixes/<traffic>.json`` the mix (route,
its arguments, lanes a call, pool, tolerance, draw), the configuration's
file its model and sizes; ``qpnbench/models/<model>.py`` assembles the model
through the program, ``qpnbench/reference/<model>.py`` states it plainly,
``qpnbench/routes/<route>.py`` drives the program's entry, and each metric
is read by ``qpnbench/metrics/<metric>.py``.  Adding a configuration, cell,
mix or metric adds files and edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import traffic as traffic_gen
from . import trace as tracing
from .reference import check

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that must not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "qpn_tpu")


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Record:
    """What a metric reader reads: the run's host-clock record, the
    program's counters over the window, and the traced window."""
    cell: dict
    config: dict
    mix: dict
    n: int
    setup_s: float
    latencies: list          # seconds of each call of the window
    window_s: float          # host clock, the whole measured window
    attempted: int           # lanes
    certified: int           # lanes the program certified
    counters: dict           # METRICS counters, window end less start
    trace: tracing.Trace | None


class Bench:
    """The benchmark's files under ``root`` (a checkout)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "qpnbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, path: Path) -> dict:
        return json.loads(path.read_text())

    def cell(self, workload: str) -> tuple[dict, dict, dict, dict]:
        """(the workloads entry, the cell's file, its mix, its
        configuration) of the cell named ``workload``."""
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == workload), None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        cfg_entry = next(c for c in self.spec["configs"]
                         if c["name"] == entry["config"])
        cell = self._json(self.dir / "cells" / f"{workload}.json")
        if (cell["config"], cell["traffic"]) != (entry["config"],
                                                 entry["traffic"]):
            raise ValueError(f"cells/{workload}.json names another "
                             "configuration or mix than BENCHMARK.json")
        mix = self._json(self.dir / "mixes" / f"{entry['traffic']}.json")
        config = self._json(self.root / cfg_entry["file"])
        return entry, cell, mix, config

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones,
        or with the trace its per-layer ones."""
        def listed(m):
            return "workloads" not in m or workload in m["workloads"]
        e2e = [m for m in self.spec["end_to_end"] if listed(m)]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def module(self, kind: str, name: str):
        """``qpnbench/<kind>/<name>.py``, loaded from its file."""
        path = self.dir / kind / f"{name}.py"
        tag = re.sub(r"\W", "_", f"qpnbench_{kind}_{name}")
        if tag in sys.modules and sys.modules[tag].__file__ == str(path):
            return sys.modules[tag]
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[tag] = mod
        spec.loader.exec_module(mod)
        return mod


def on_device(qlu, dev) -> dict:
    """The lanes' (q, l, u) as the call takes them: q and l by ensemble,
    u one for all (the draw leaves it alone)."""
    import torch
    q, l, u = qlu
    f64 = torch.float64
    return {"q": torch.as_tensor(q, dtype=f64, device=dev),
            "l": torch.as_tensor(l, dtype=f64, device=dev),
            "u": torch.as_tensor(np.ascontiguousarray(u[0]), dtype=f64,
                                 device=dev)}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi: {out.stderr.strip()}"


def run(bench: Bench, workload: str, seed: int, seconds: float,
        traced: bool, t_start: float, device: str | None = None,
        log=print) -> tuple[dict, list[str]]:
    """One run of ``workload``.  ``device`` None asks for the card (and
    raises :class:`NoCard` without it); ``"cpu"`` runs the same path on
    the CPU, for tests.  Returns the result line and the check lines."""
    import torch
    entry, cell, mix, config = bench.cell(workload)
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < entry["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell asks "
                         f"for {entry['chips']}")
        dev = torch.device("cuda", 0)
        log(card_line())
    else:
        dev = torch.device(device)
    from qpn_tpu_torch.utils.metrics import METRICS
    model = bench.module("models", config["model"])
    route = bench.module("routes", mix["route"])

    # set-up: the kernels built (once per checkout) or loaded, the model
    if dev.type == "cuda":
        route.build()
    sys_ = model.assemble(config)
    n = sys_.M.shape[0]
    S = mix["lanes"]
    draws = traffic_gen.draw_pool(mix, sys_.shifted, n)
    f64 = torch.float64
    data = {
        "M": torch.as_tensor(sys_.M, dtype=f64, device=dev).expand(
            S, n, n).contiguous(),
        "z0": torch.zeros(S, n, dtype=f64, device=dev),
        "mask": torch.ones(S, n, dtype=torch.bool, device=dev),
        "structure": dict(sys_.structure),
        **on_device(model.lanes(sys_, draws.shift, draws.jitter), dev),
    }
    call = route.prepare(data, mix)
    P = mix["pool"]
    for e in range(P):                  # every ensemble once: every shape
        call(e)
    if traced:                          # the profiler's own start-up
        tracing.profile(lambda: call(0), 1)
    counters0 = dict(METRICS.counters)
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # the measured window: closed loop over the pool, in the seed's order
    latencies, answers = [], []
    order = traffic_gen.Order(seed, P)

    def one(c):
        e = order(c)
        t0 = time.perf_counter()
        z, ok = call(e)
        latencies.append(time.perf_counter() - t0)
        answers.append((e, z, ok))

    w0 = time.perf_counter()
    trace = None
    if traced:
        from torch.profiler import record_function
        K = cell["trace_calls"]

        def traced_calls():
            for c in range(K):
                with record_function(tracing.CALL):
                    one(c)
        _, trace = tracing.profile(traced_calls, K)
    while time.perf_counter() - w0 < seconds:
        one(len(answers))
    window_s = time.perf_counter() - w0
    gc.unfreeze()
    counters = {k: v - counters0.get(k, 0.0)
                for k, v in METRICS.counters.items()}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # the check ensembles, drawn from the seed: the same call on scenarios
    # that neither the pool nor the warm-up holds
    fresh = traffic_gen.draw_check(mix, sys_.shifted, n, seed)
    check_call = route.prepare(
        dict(data, **on_device(model.lanes(sys_, fresh.shift, fresh.jitter),
                               dev)), mix)
    checked = [(e, *check_call(e)) for e in range(len(fresh.shift))]
    del call, check_call, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison: every answer on the reference's own statement
    ref = bench.module("reference", config["model"])
    prob = ref.problem(config)
    if prob.M.shape != sys_.M.shape:
        raise ValueError(f"the reference's n {prob.M.shape[0]} is not the "
                         f"program's {n}")
    worst = 0.0
    for pool, got in ((draws, answers), (fresh, checked)):
        rq, rl, ru = ref.lanes(prob, pool.shift, pool.jitter)
        for e, z, _ in got:
            worst = max(worst, float(check.residuals(prob.M, rq[e], rl[e],
                                                     ru[e], z).max()))
    tol = mix["tol"]
    checks = {"resid_max": {"value": worst, "limit": tol}}
    attempted = len(answers) * S
    certified = int(sum(int(ok.sum()) for _, _, ok in answers))
    correct = bool(answers) and bool(checked) and all(
        c["value"] <= c["limit"] for c in checks.values())

    rec = Record(cell=cell, config=config, mix=mix, n=n, setup_s=setup_s,
                 latencies=latencies, window_s=window_s, attempted=attempted,
                 certified=certified, counters=counters, trace=trace)
    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted,
              "failed": attempted - certified, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": entry["chips"],
                         "memory_peak_bytes": int(peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s,
                                window_s=trace.window_s)
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in trace.device_ops[:10]],
            "idle_gaps": [list(kv) for kv in trace.idle_gaps[:10]]}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    lines.insert(0, f"check answers: {len(answers)} calls of the window "
                    f"({attempted} lanes, {certified} certified by the "
                    f"program) and {len(checked)} on ensembles drawn from "
                    "the seed after it")
    return result, lines
