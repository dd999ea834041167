"""The traced window: ``torch.profiler`` over some calls, and its reduction
to device intervals, busy time, the largest device operations and the
idle gaps with what the host was doing in each.

The window is a ``record_function`` span around the traced calls; every
device activity (kernel, copy, set) inside it counts.  Busy time is the
union of those intervals, so overlapping work counts once and the rest of
the window is idle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

WINDOW = "qpnbench.window"
CALL = "qpnbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    ops: list            # (short name, start s, seconds), device, in window
    idle_gaps: list      # (host label, seconds), summed, largest first
    device_ops: list     # (short name, seconds), summed, largest first

    def op_seconds(self, prefix: str) -> float:
        """Seconds of the device operations whose function name (the last
        component of the short name) starts with ``prefix``."""
        return sum(d for name, _, d in self.ops if is_kernel(name, prefix))


def short_name(name: str) -> str:
    """A kernel's qualified function name without its return type, template
    arguments and parameters, and without ``(anonymous namespace)::``:
    ``void (anonymous namespace)::f<float, 0>(Batch)`` → ``f``,
    ``std::enable_if<...>::type ns::g<2>(...)`` → ``ns::g``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    depth, head = 0, name
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            head = name[:i]
            break
    # drop template arguments at the top level, then the return type
    out, depth = [], 0
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    return words[-1] if words else (name or "?")


def is_kernel(name: str, prefix: str) -> bool:
    """Whether a short name's last component starts with ``prefix``."""
    return name.split("::")[-1].startswith(prefix)


def profile(run_calls, calls: int):
    """Run ``run_calls()`` (which makes ``calls`` calls, each inside a
    ``CALL`` span) under the profiler, inside a ``WINDOW`` span; returns
    its result and the reduced :class:`Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                           else [])
    with tprofile(activities=activities) as prof:
        with record_function(WINDOW):
            out = run_calls()
        if card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, reduce(events, calls)


def _union(intervals):
    """Merged (start, end) of sorted intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point, the name of the innermost host span that holds it
    (spans of one thread nest), or None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out = [None] * len(points)
    stack = []
    i = 0
    for k in order:
        p = points[k]
        while i < len(host) and host[i][0] <= p:
            s, e, name = host[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def reduce(events, calls: int) -> Trace:
    """The traced window's numbers from chrome-trace events (µs)."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tid = w.get("tid")
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t > s:
            name = e.get("name", "?")
            dev.append((s, t, short_name(name) if e["cat"] == "kernel"
                        else name.split(" (")[0]))
    dev.sort()
    merged = _union([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged)

    totals: dict = {}
    for s, t, name in dev:
        totals[name] = totals.get(name, 0.0) + (t - s)
    device_ops = sorted(((k, v / 1e6) for k, v in totals.items()),
                        key=lambda kv: -kv[1])

    gaps = []
    edge = w0
    for s, t in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e.get("name", "?")) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and e.get("name") != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    labels = _innermost(host, [(s + t) / 2 for s, t in gaps])
    by_label: dict = {}
    for (s, t), label in zip(gaps, labels):
        key = "host: " + (label if label not in (None, CALL)
                          else "Python between operations")
        by_label[key] = by_label.get(key, 0.0) + (t - s)
    idle = sorted(((k, v / 1e6) for k, v in by_label.items()),
                  key=lambda kv: -kv[1])
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, calls=calls,
                 ops=[(name, s / 1e6, (t - s) / 1e6) for s, t, name in dev],
                 idle_gaps=idle, device_ops=device_ops)

