"""Timestamped logging, equivalent of the reference's print_message
(reference: QUILT/R/copied_from_stitch.R:1-22)."""
from __future__ import annotations

import contextlib
import datetime
import os
import sys
import time
from typing import Optional

import torch

_VERBOSE = True


def set_verbosity(verbose: bool) -> None:
    global _VERBOSE
    _VERBOSE = verbose


def print_message(msg: str, include_mem: bool = False) -> None:
    if not _VERBOSE:
        return
    ts = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
    if include_mem:
        try:
            with open(f"/proc/{os.getpid()}/statm") as fh:
                rss_pages = int(fh.read().split()[1])
            msg = f"{msg} (RSS {rss_pages * 4096 / 1e9:.2f} GB)"
        except OSError:
            pass
    print(f"{ts} {msg}", file=sys.stderr, flush=True)


class SectionTimers:
    """The engine's named spans, the program's one tracer: the equivalent
    of the reference's prev_section/next_section instrumentation threaded
    through its C++ kernels (reference: QUILT/src/copied-from-stitch.cpp:31-49,
    enabled by print_extra_timing_information, quilt.R:166).

    `with timers.section("name"):` around a stretch of work. An enabled
    section reads the host clock at its edges, opens a torch.profiler range
    of its name while a profiler runs (so the span lands in any profiler
    trace, and in Nsight Systems under emit_nvtx) and, on a CUDA `device`,
    records a CUDA event at each edge on the stream current when the
    outermost open section began (the port runs on one stream: a stream
    lookup costs as much as an event); the device seconds are resolved
    once, after one synchronize, by `as_dict()` / `report()`. A section
    drains nothing: a caller that wants its work inside it synchronizes
    before it ends (engine/batch.py:timed_sections). Sections nest; each
    entry keeps its self time, the host time under none of its children,
    and a root section (`root=True`) adds its self time as an entry of its
    own, `<name>.self`. A disabled instance creates nothing: `section`
    returns one shared no-op context.
    """

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.totals: dict = {}
        self.counts: dict = {}
        self.self_totals: dict = {}
        self.device_totals: dict = {}
        self.device = torch.device(device) if device is not None else None
        self.cuda = enabled and self.device is not None and self.device.type == "cuda"
        self._open: list = []      # child seconds of each open section, innermost last
        self._pending: list = []   # (name, start event, end event), not yet resolved
        self._stream = None

    def section(self, name: str, root: bool = False):
        return _Section(self, name, root) if self.enabled else _NO_SECTION

    def add(self, name: str, dt: float, self_dt: Optional[float] = None) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.self_totals[name] = self.self_totals.get(name, 0.0) + (
            dt if self_dt is None else self_dt)

    def _event(self):
        """A timing CUDA event recorded now on the sections' stream."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _resolve(self) -> None:
        if not self._pending:
            return
        torch.cuda.synchronize(self.device)
        for name, e0, e1 in self._pending:
            self.device_totals[name] = (self.device_totals.get(name, 0.0)
                                        + e0.elapsed_time(e1) / 1e3)
        self._pending = []

    def as_dict(self) -> dict:
        """{section: {"seconds": host total, "calls": n, "self_seconds":
        host time under no child section, and on a card "device_seconds":
        start event to end event, summed}}, largest host total first."""
        self._resolve()
        out = {}
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            out[name] = {"seconds": tot, "calls": self.counts[name],
                         "self_seconds": self.self_totals[name]}
            if name in self.device_totals:
                out[name]["device_seconds"] = self.device_totals[name]
        return out

    def report(self) -> None:
        if not self.enabled or not self.totals:
            return
        rows = self.as_dict()
        print_message("Section timings (ms: host, device, self under no child section):")
        width = max(len(k) for k in rows)
        for name, v in rows.items():
            dev = v.get("device_seconds")
            dev = f"{dev * 1000:10.1f}" if dev is not None else f"{'-':>10}"
            print_message(
                f"  {name:<{width}}  {v['seconds'] * 1000:10.1f} {dev}"
                f" {v['self_seconds'] * 1000:10.1f}  ({v['calls']} calls)"
            )


class _Section:
    """One span of an enabled SectionTimers (see there)."""

    def __init__(self, timers: SectionTimers, name: str, root: bool = False):
        self.timers = timers
        self.name = name
        self.root = root

    def __enter__(self):
        t = self.timers
        if t.enabled:
            self.t0 = time.perf_counter()
            if t.cuda and not t._open:
                t._stream = torch.cuda.current_stream(t.device)
            t._open.append(0.0)
            self._range = None
            if torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            self._e0 = t._event() if t.cuda else None
        return self

    def __exit__(self, *exc):
        t = self.timers
        if t.enabled:
            if self._e0 is not None:
                t._pending.append((self.name, self._e0, t._event()))
            if self._range is not None:
                self._range.__exit__(None, None, None)
            dt = time.perf_counter() - self.t0
            self_dt = dt - t._open.pop()
            if t._open:
                t._open[-1] += dt
            t.add(self.name, dt, self_dt)
            if self.root:
                t.add(self.name + ".self", self_dt)
        return False


_NO_SECTION = contextlib.nullcontext()
