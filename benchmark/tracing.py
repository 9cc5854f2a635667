"""The device's side of a traced window, from torch.profiler's trace:
the seconds in which a kernel, copy or fill ran (busy), the window's
length, the device operations that took the most time, and the idle time
by what the host was doing (each piece of an idle gap goes to the
innermost of the engine's timed sections open over it, as profiler
ranges)."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BATCH_RANGE = "benchmark:batch"
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(path: str) -> Optional[Dict]:
    """{busy_s, window_s, device_ops, idle_gaps} of the exported chrome
    trace at `path`, over the span of its BATCH_RANGE ranges; None where
    the trace holds no device event in that span (the tracer came back
    empty)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    batches = [e for e in xs if e.get("name") == BATCH_RANGE]
    if not batches:
        return None
    w0 = min(float(e["ts"]) for e in batches)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in batches)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    if not dev:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    spans = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        by_name[str(e.get("name", "?"))[:200]] += (b - a) / 1e6
        spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
                     for e in xs if e.get("cat") == "user_annotation"
                     and e.get("name") != BATCH_RANGE), key=lambda r: r[0])
    edges = sorted({x for a, b, _ in ranges for x in (a, b)})
    gaps: Dict[str, float] = defaultdict(float)
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            # each piece of the gap goes to the section open over it
            cuts = [prev] + [x for x in edges if prev < x < a] + [a]
            for x, y in zip(cuts[:-1], cuts[1:]):
                gaps[_open_range(ranges, (x + y) / 2)] += (y - x) / 1e6
        prev = max(prev, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _open_range(ranges, t: float) -> str:
    """The innermost (latest-starting) range open at time t, or a name
    saying none was."""
    best = None
    for a, b, name in ranges:
        if a > t:
            break
        if b > t:
            best = name
    return best or "outside the engine's timed sections"
