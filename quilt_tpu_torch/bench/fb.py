"""Cell updates a second of the full-panel FB on one card: the port of the
JAX side's bench.py.

The FB at QUILT quick-start scale (K = 5,120 panel haplotypes x 2,048
grids of 32 SNPs, 28 rows = 7 chains x 2 latent haplotypes x 2 samples,
top-K lists of 8 at every 10th grid) through kernels/fb.py:fb_full_batched,
which takes the family fb_plan chooses (at this shape the K-split kernels
of csrc/fb_tiled.cu, 4 blocks a row). One cell update is one K-state alpha or beta update at one
grid, forward and backward counted. The GLs and the prepared panel stay on
the device, as they do across the engine's seek loop; each timed call is
drained before the next, as the engine consumes each result on the host.
vs_baseline divides by the measured single-core cells/s of the C++
re-implementation of the reference's FB (BASELINE_MEASURED.json)."""
from __future__ import annotations

import json

import numpy as np
import torch

from ..inputs import FBInputs
from ..kernels.fb import fb_full_batched, fb_plan
from ..panel.prepare import compress_panel, trans_rates
from .common import device_report, fast_packed_panel, reference_cells_per_s, require_cuda, timed

K, NSNPS, ROWS, K_TOP, THIN_EVERY, REPS = 5120, 65536, 28, 8, 10, 6
# the port's FB is exact float32: a dosage may leave [0, 1] by rounding only
DOSAGE_SLACK = 1e-4


def fb_world(rng: np.random.Generator, K: int = K, nSNPs: int = NSNPS, rows: int = ROWS) -> dict:
    """The FB benchmark's inputs: a fast_packed_panel of K haplotypes over
    nSNPs SNPs, its FBInputs (every THIN_EVERY-th grid thinned, a 0.99
    stay rate between grids) and GLs [rows, 2, nSNPs] uniform in
    [0.05, 1), host arrays. "rhb" is the packed panel [K, nSNPs / 32]."""
    nGrids = nSNPs // 32
    rhb = fast_packed_panel(rng, K, nGrids)
    panel = compress_panel(rhb, nSNPs, nMaxDH=255)
    trans = trans_rates(np.full(nGrids - 1, 0.99))
    fb = FBInputs.build(panel, trans, thinned_grids=np.arange(0, nGrids, THIN_EVERY))
    gl = rng.uniform(0.05, 1.0, (rows, 2, nSNPs)).astype(np.float32)
    return dict(rhb=rhb, fb=fb, gl=gl, K=K, nSNPs=nSNPs, nGrids=nGrids, rows=rows)


def run_fb(world: dict, gl: torch.Tensor, **plan):
    """One FB call on gl's device: (dosage [rows, S], log_like, top_vals,
    top_idx); plan (family, splits) forces fb_plan's choice."""
    return fb_full_batched(gl, world["fb"], K_TOP, **plan)


def plan_of(world: dict, rows: int) -> dict:
    family, per_call, splits = fb_plan(rows, world["fb"])
    return {"family": family, "rows_per_call": per_call, "splits": splits}


def check_dosage(dosage: np.ndarray) -> None:
    """The benchmark's sanity check of its last call: finite dosages
    within [0, 1] up to DOSAGE_SLACK."""
    if not np.isfinite(dosage).all():
        raise AssertionError("the FB returned non-finite dosages")
    if dosage.min() < -DOSAGE_SLACK or dosage.max() > 1 + DOSAGE_SLACK:
        raise AssertionError(f"FB dosages outside [0, 1]: {dosage.min()} .. {dosage.max()}")


def time_fb(world: dict, device="cuda", reps: int = REPS) -> dict:
    """Seconds a call (mean of `reps` after a warm-up) and cells/s of the
    FB on `world` on the card, with the plan fb_plan took; checks the last
    call's dosages."""
    dev = require_cuda(device)
    gl = torch.as_tensor(world["gl"], device=dev)
    out, dt = timed(lambda: run_fb(world, gl), dev, reps)
    check_dosage(out[0][:, :world["nSNPs"]].cpu().numpy())
    rows, K_ = world["rows"], world["K"]
    cells = 2.0 * rows * K_ * world["fb"].nGrids
    return {"cells_per_s": cells / dt, "K": K_, "nGrids": world["fb"].nGrids, "B": rows,
            "seconds": dt, "vs_measured_ref_core": cells / dt / reference_cells_per_s(),
            "plan": plan_of(world, rows)}


def fb_report(world: dict, device="cuda", reps: int = REPS) -> dict:
    """bench.py's JSON line: {"metric", "value", "unit", "vs_baseline"},
    and the card's name and power limit."""
    r = time_fb(world, device, reps)
    card = device_report(device)
    return {"metric": "hmm_cell_updates_per_s_per_chip", "value": round(r["cells_per_s"], 1),
            "unit": "cells/s", "vs_baseline": round(r["vs_measured_ref_core"], 3),
            "device": card["device"], "power_limit_w": card["power_limit_w"]}


def main(device="cuda") -> dict:
    require_cuda(device)
    report = fb_report(fb_world(np.random.default_rng(0)), device)
    print(json.dumps(report), flush=True)
    return report
