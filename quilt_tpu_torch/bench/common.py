"""What the port's benchmark programs share: the synthetic packed panel of
the JAX side's benchmarks (a copy of bench.py:fast_packed_panel), the
measured single-core C++ denominators (BASELINE_MEASURED.json, read as a
data file; copies of bench.py:reference_cells_per_s and
bench_full.py:_baseline), the card's report, and a host timer that drains
the device before each clock read. A measurement never runs on the CPU:
require_cuda raises first."""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

BASELINE_FILE = Path(__file__).resolve().parents[2] / "BASELINE_MEASURED.json"


def baseline(key: str) -> float:
    """A measured single-core C++ figure from BASELINE_MEASURED.json; a
    missing file or key raises."""
    with open(BASELINE_FILE) as fh:
        return float(json.load(fh)[key])


def reference_cells_per_s() -> float:
    """The measured single-core FB cells/s of the C++ re-implementation of
    the reference (bench_ref/fb_ref_bench.cpp)."""
    return baseline("reference_cells_per_s")


def fast_packed_panel(rng: np.random.Generator, K: int, nGrids: int, n_founders: int = 32,
                      switch: float = 0.02, mutation_per_bit: float = 0.008) -> np.ndarray:
    """Founder-mosaic panel [K, nGrids] uint32 made directly in the 32-SNP
    packed form: each haplotype copies one of n_founders random words a
    grid, switching founder with probability `switch` a grid, then a
    share mutation_per_bit of its bits flip. Built from [K, nGrids] arrays
    only (no per-SNP temporaries), so a 98,304-haplotype panel takes
    seconds. The same draws as the JAX side's bench.py:fast_packed_panel,
    so one seed gives the same panel."""
    founders = rng.integers(0, 1 << 32, size=(n_founders, nGrids), dtype=np.uint32)
    jumps = rng.integers(0, 1 << 16, size=(K, nGrids), dtype=np.uint16) \
        < int(switch * (1 << 16))
    jumps[:, 0] = True
    choice = rng.integers(0, n_founders, size=(K, nGrids), dtype=np.int8)
    idx = np.where(jumps, np.arange(nGrids, dtype=np.int32)[None, :], 0)
    np.maximum.accumulate(idx, axis=1, out=idx)
    founder_of = choice[np.arange(K)[:, None], idx]
    rhb_t = founders[founder_of, np.arange(nGrids)[None, :]]
    n_mut = int(K * nGrids * 32 * mutation_per_bit)
    mk = rng.integers(0, K, n_mut)
    mg = rng.integers(0, nGrids, n_mut)
    mb = rng.integers(0, 32, n_mut).astype(np.uint32)
    np.bitwise_xor.at(rhb_t, (mk, mg), np.uint32(1) << mb)
    return rhb_t


def packed_truth_mosaic(rng: np.random.Generator, rhb: np.ndarray, nSNPs: int,
                        n_latent: int = 2, switch_rate: float = 0.002) -> np.ndarray:
    """Truth haplotypes [n_latent, nSNPs] uint8 as mosaics of the packed
    panel rhb [K, nGrids]'s haplotypes, read from the words (a 98,304-
    haplotype panel is never unpacked): the draws of
    io.simulate.simulate_truth_mosaic, so the same seed gives the same
    truth as that function on the unpacked panel."""
    K = rhb.shape[0]
    s = np.arange(nSNPs)
    out = np.zeros((n_latent, nSNPs), dtype=np.uint8)
    for i in range(n_latent):
        jumps = rng.random(nSNPs) < switch_rate
        jumps[0] = True
        choice = rng.choice(np.arange(K), size=nSNPs)
        src = choice[np.maximum.accumulate(np.where(jumps, s, 0))]
        out[i] = (rhb[src, s >> 5] >> (s & 31).astype(np.uint32)) & np.uint32(1)
    return out


def require_cuda(device="cuda") -> torch.device:
    """The CUDA device a measurement runs on; raises RuntimeError without
    one, or when `device` is not a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a measurement needs a CUDA device; got {device!r} "
                           f"(torch.cuda.is_available() is {torch.cuda.is_available()})")
    return dev


def device_report(device="cuda") -> dict:
    """The card every number of a report is taken on: its name, the
    device count, and the name and power limit nvidia-smi reads
    (power_limit_w None where it reads none)."""
    dev = require_cuda(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = lines[index if index < len(lines) else 0].strip()
    power = line.rsplit(",", 1)[-1].split()
    try:
        watts = float(power[0])
    except (IndexError, ValueError):
        watts = None
    return {"device": torch.cuda.get_device_name(dev), "device_count": torch.cuda.device_count(),
            "nvidia_smi": line, "power_limit_w": watts}


def timed(fn: Callable, device, reps: int = 1, warmup: bool = True) -> Tuple[object, float]:
    """(fn()'s last result, mean seconds a call) over `reps` calls on the
    host clock, after a warm-up call (kernel builds, first-use uploads);
    the device is drained before each clock read and after each call, as
    the engine consumes each result before it issues the next."""
    dev = require_cuda(device)
    out = None
    if warmup:
        out = fn()
    torch.cuda.synchronize(dev)
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        total += time.perf_counter() - t0
    return out, total / reps


def peak_device_bytes(fn: Callable, device) -> Tuple[object, int]:
    """(fn(), the peak of allocated device memory during the call)."""
    dev = require_cuda(device)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, int(torch.cuda.max_memory_allocated(dev))
