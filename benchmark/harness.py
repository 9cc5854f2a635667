"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides `correct`. `run.py` is the command; `run_cell`
takes the device, so the tests drive it on the CPU at a small size.

A run:
1. builds the port's kernels where the checkout has none yet (timed on
   its own and logged, and counted in set-up), makes the world of the
   cell's configuration and traffic mix from the seed (the configuration's
   method module, methods/<method>.py), and the program's region set-up
   of it (program.py);
2. imputes one batch of the pool to warm up; set-up ends here, and its
   stages are logged;
3. runs the pool's batches back to back, in order and again from the
   first, in one closed loop, until a batch ends at or after `seconds`;
4. reads the peak memory, frees the program's state, and compares the
   last batch with the reference (the method's `compare`).
With `trace`, the engine's section timers are on (they drain the device at
each section's end), CUDA events mark each section, the profiler traces
the first TRACE_BATCHES batches of the window, and the line carries the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, rates, tracing, work
from .manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "quilt_tpu")
TRACE_BATCHES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (quilt_tpu_torch is not quilt_tpu)."""
    tops = {m.split(".")[0] for m in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             manifest: Optional[Manifest] = None, keep: Optional[Dict] = None
             ) -> Optional[Dict]:
    """The result line's object of one run, or None when the run may
    print none (a forbidden module was loaded). t_start: the process's
    start on time.monotonic's clock (default: now). `keep`, a dict, gets
    what the comparison read (control.py reads it again in bfloat16)."""
    t_start = time.monotonic() if t_start is None else t_start
    from . import program                  # the system under test

    man = manifest or Manifest(root)
    cell = man.cell(name)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    meth = man.method(config)
    cfg = program.impute_config(config, traffic, seed, timing=trace)
    stages = {"start": time.monotonic() - t_start}
    stages["build"] = program.build_kernels(device)
    stages["world"] = -time.monotonic()
    world = meth.make_world(seed, config, traffic)
    stages["world"] += time.monotonic()
    stages["prepare"] = -time.monotonic()
    prep = program.prepare(world, config, cfg, device)
    reads = program.sample_reads(world, prep)
    stages["prepare"] += time.monotonic()
    batches = world.batches
    chosen = meth.plan(seed, config, world)
    rec = meth.recorder(program, chosen, config).install()
    events = program.SectionEvents().install() if trace else None
    tmp = Path(tempfile.mkdtemp(prefix="benchmark-"))
    vcf = str(tmp / "impute.vcf.gz")
    names = [f"sample{i}" for i in range(len(reads))]

    def one_batch(idx):
        return program.impute(prep, [reads[i] for i in idx], [names[i] for i in idx], cfg,
                              device, vcf)

    try:
        stages["warm-up"] = -time.monotonic()
        one_batch(batches[0])                                     # warm-up
        _sync(device)
        stages["warm-up"] += time.monotonic()
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        prof, profiling = None, False
        if trace:
            events.clear()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            profiling = True
        t0 = time.monotonic()
        setup_s = t0 - t_start
        log("set-up, s: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; setup_s {setup_s:.2f} (build: the kernels' nvcc build, 0 where built)")
        done, host_s, durations = [], {}, []
        i, t_prev = 1, t0
        while True:
            idx = batches[i % len(batches)]
            rec.begin()
            with torch.profiler.record_function(tracing.BATCH_RANGE):
                dos, timing = one_batch(idx)
            t_end = time.monotonic()
            durations.append(t_end - t_prev)
            t_prev, elapsed = t_end, t_end - t0
            done.append((idx, dos))
            for k, v in (timing or {}).items():
                host_s[k] = host_s.get(k, 0.0) + v["seconds"]
            if profiling and len(done) == TRACE_BATCHES:
                prof.__exit__(None, None, None)
                profiling = False
            if rates.window_closed(elapsed, seconds):
                break
            i += 1
        window_s = elapsed
        _sync(device)
        if profiling:
            prof.__exit__(None, None, None)
        peak = (int(torch.cuda.max_memory_allocated(device))
                if torch.device(device).type == "cuda" else 0)
        device_s = events.device_s() if trace else {}
        state = meth.state(rec, config)
    finally:
        rec.uninstall()
        if events is not None:
            events.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)

    n_samples = sum(len(idx) for idx, _ in done)
    failed = sum(1 for _, dos in done for d in dos if d is None or not np.all(np.isfinite(d)))
    r2 = [rates.r2_simple(world.truths[i].sum(0).astype(float), d)
          for idx, dos in done for i, d in zip(idx, dos) if d is not None]
    metrics: Dict[str, Dict] = {}
    breakdown = None
    dev_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                         else "cpu"),
                "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if not trace:
        sps = rates.samples_per_s([len(idx) for idx, _ in done], durations, seconds)
        values = {"samples_per_s": sps, "r2_mean": float(np.nanmean(r2)),
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in man.end_to_end(name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = None
        if prof is not None:
            path = str(Path(tempfile.mkdtemp(prefix="benchmark-trace-")) / "trace.json")
            try:
                prof.export_chrome_trace(path)
                tr = tracing.read_trace(path)
            finally:
                shutil.rmtree(Path(path).parent, ignore_errors=True)
        if tr is None:
            log("trace: the profiler recorded no device event in the traced batches; "
                "device_idle_pct is left out and busy_s is the sections' CUDA-event time")
            traced = min(TRACE_BATCHES, len(done))
            busy = sum(device_s.values()) * traced / len(done)
            tr = {"busy_s": busy, "window_s": window_s * traced / len(done), "empty": True}
        else:
            breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        reads_per_batch = np.mean([sum(world.reads[i].n_reads for i in idx) for idx, _ in done])
        records = {"platform": dev_info["platform"], "batches": len(done), "samples": n_samples,
                   "window_s": window_s, "host_s": host_s, "device_s": device_s,
                   "work": meth.batch_work(config, traffic, reads_per_batch),
                   "peak": {"bytes_per_s": work.HBM_BYTES_PER_S,
                            "flop_per_s": work.F32_FLOP_PER_S},
                   "trace": None if tr.get("empty") else tr}
        per = lambda d, k: f"{1e3 * d[k] / len(done):.1f}" if k in d else "-"
        log("sections, ms a batch (host clock / device by CUDA events): " + "; ".join(
            f"{k} {per(host_s, k)} / {per(device_s, k)}"
            for k in sorted(set(host_s) | set(device_s), key=lambda k: -host_s.get(k, 0.0))))
        for m in man.per_layer(name):
            v = man.metric_module(m["name"]).read(records)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison, on the last batch, with the program's state freed
    last_idx, last_dos = done[-1]
    program.free(prep)
    del reads
    t_check = time.monotonic()
    cmp = meth.compare(state, world, last_idx, last_dos, config, device)
    checks = check.judge(cmp["numbers"], config["limits"])
    log(f"check: {meth.summary(cmp, state)}; {time.monotonic() - t_check:.1f} s")
    if keep is not None:
        keep.update(state=state, world=world, last_idx=last_idx, last_dos=last_dos,
                    config=config, method=meth, compare=cmp)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    result = {"correct": check.all_within(checks), "attempted": n_samples, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    return result
