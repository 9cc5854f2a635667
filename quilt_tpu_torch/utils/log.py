"""Timestamped logging, equivalent of the reference's print_message
(reference: QUILT/R/copied_from_stitch.R:1-22)."""
from __future__ import annotations

import datetime
import os
import sys

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
    """Per-section wall-clock timers, the equivalent of the reference's
    prev_section/next_section instrumentation threaded through its C++
    kernels (reference: QUILT/src/copied-from-stitch.cpp:31-49, enabled by
    print_extra_timing_information, quilt.R:166).

    Use `with timers.section("name"):` around engine phases; totals print
    via `report()`. A disabled instance is free (no-ops).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: dict = {}
        self.counts: dict = {}

    def section(self, name: str):
        return _Section(self, name)

    def add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> dict:
        """{section: {"seconds": total, "calls": n}} for bench reporting."""
        return {
            name: {"seconds": tot, "calls": self.counts[name]}
            for name, tot in sorted(
                self.totals.items(), key=lambda kv: -kv[1]
            )
        }

    def report(self) -> None:
        if not self.enabled or not self.totals:
            return
        print_message("Section timings:")
        width = max(len(k) for k in self.totals)
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print_message(
                f"  {name:<{width}}  {tot * 1000:10.1f} ms"
                f"  ({self.counts[name]} calls)"
            )


class _Section:
    def __init__(self, timers: SectionTimers, name: str):
        self.timers = timers
        self.name = name

    def __enter__(self):
        if self.timers.enabled:
            import time
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timers.enabled:
            import time
            self.timers.add(self.name, time.perf_counter() - self.t0)
        return False
