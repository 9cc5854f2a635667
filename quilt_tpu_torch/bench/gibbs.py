"""The Gibbs call on one card at 7 to 256 chains, and its fixed / per-sweep
split: the port of the JAX side's tools/bench_gibbs.py.

The world is bench_full's end-to-end shape: one sample's reads (600 bp at
1x, phred 25) over 16,384 SNPs of a 5,120-haplotype fast_packed_panel, a
subset of 600 haplotypes (640 with the pad), 21 sweeps a call. The
emissions take the engine's route (engine/batch.py): the read-window cache,
the whole-panel log eMatRead built once, then per call the subset's rows
(lem_subset) and kernels/gibbs.py:run_gibbs_chains. The chains share the
sample's reads; each has its own uniforms, initial labels and first read.
A call's "backend" is the form the forward sweep's wrapper takes at this K
(kernels/gibbs_sweep.py:fwd_form)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..inputs import GibbsInputs, PaddedReads, pad_to_multiple
from ..io import simulate_sample_reads
from ..io.simulate import simulate_truth_mosaic
from ..kernels.emissions import ReadWindowCache, expand_panel, lem_full_from_cache, lem_subset
from ..kernels.gibbs import SlotLayout, run_gibbs_chains
from ..kernels.gibbs_sweep import CLUSTER, GENERAL, fwd_form
from ..panel.prepare import assign_positions_to_grid, trans_rates
from ..utils import unpack_bits_32
from .common import device_report, fast_packed_panel, require_cuda, timed

K_PANEL, NSNPS, KSUB, N_ITS, REPS = 5120, 16384, 600, 21, 3
CHAINS = (7, 28, 56, 112, 224, 256)
MAX_DIFF = 1e10     # the engine's maxDifferenceBetweenReads


def gibbs_world(rng: np.random.Generator, device, K: int = K_PANEL, nSNPs: int = NSNPS,
                Ksub: int = KSUB, read_length_bp: int = 600, phred: int = 25) -> dict:
    """One sample's reads from a truth mosaic of a fast_packed_panel (SNPs
    60 bp apart), its Gibbs inputs, a sorted subset of Ksub haplotypes
    (padded to a multiple of 128 by repeating the first), and the
    whole-panel log eMatRead of its reads on `device`."""
    dev = torch.device(device)
    rhb = fast_packed_panel(rng, K, nSNPs // 32)
    haps = unpack_bits_32(rhb, nSNPs)
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * 60
    grid, _, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=1.0,
                                     read_length_bp=read_length_bp, phred=phred)
    reads = reads.sorted_by_grid()
    ginputs = GibbsInputs.build_batched([reads], trans_rates(np.full(nGrids - 1, 0.99)), nGrids)
    preads = PaddedReads.build_batched([reads], ref_error=0.001)
    Kp = pad_to_multiple(Ksub, 128)
    which = np.sort(rng.choice(K, Ksub, replace=False))
    which_p = np.concatenate([which, np.repeat(which[:1], Kp - Ksub)]).astype(np.int64)
    cache = ReadWindowCache(preads.u_pad, preads.lpr, preads.lpa, preads.mask, nGrids, dev,
                            lr=preads.lr, la=preads.la)
    lem_full = lem_full_from_cache(
        expand_panel(torch.as_tensor(rhb.view(np.int32), device=dev)), cache)
    return dict(reads=reads, ginputs=ginputs, nGrids=nGrids, Ksub=Ksub, Kp=Kp, device=dev,
                trans=torch.as_tensor(np.ascontiguousarray(ginputs.trans.T), device=dev),
                which_p=torch.as_tensor(which_p, device=dev), lem_full=lem_full)


def gibbs_state(world: dict, C: int, n_its: int, rng: np.random.Generator) -> dict:
    """A C-chain call's own inputs: the slot layout of the sample's reads
    for C chains (built once a batch in the engine, so outside the timed
    call), uniforms [n_its, C, R], initial labels [C, R] and first reads [C]."""
    dev, R = world["device"], world["ginputs"].R
    return dict(
        layout=SlotLayout.build(world["ginputs"], C, dev),
        uniforms=torch.as_tensor(rng.random((n_its, C, R)).astype(np.float32), device=dev),
        H0=torch.as_tensor(rng.choice(2, size=(C, R)).astype(np.int32), device=dev),
        first=torch.as_tensor(rng.integers(0, world["reads"].nReads, C).astype(np.int32),
                              device=dev))


def first_chains(world: dict, state: dict, n: int) -> dict:
    """The state of chains 0 .. n-1 of `state`: the same inputs for a call of
    n chains (chain independence: its labels and logc equal those chains')."""
    return dict(layout=SlotLayout.build(world["ginputs"], n, world["device"]),
                uniforms=state["uniforms"][:, :n].contiguous(), H0=state["H0"][:n].contiguous(),
                first=state["first"][:n].contiguous())


def run_gibbs(world: dict, state: dict):
    """One Gibbs call (kernels.gibbs.GibbsCall): the subset's rows of the
    whole-panel eMatRead, rescaled (lem_subset), then run_gibbs_chains with
    iterative initialisation and no block move."""
    C = state["H0"].shape[0]
    lem, skip = lem_subset(world["lem_full"], world["which_p"][None].expand(C, -1), MAX_DIFF,
                           world["ginputs"].R)
    return run_gibbs_chains(state["layout"], world["trans"], lem, skip, state["uniforms"],
                            state["H0"], state["first"], True, world["Ksub"])


def form_name(Kp: int, nl: int = 2) -> str:
    """The forward sweep's form at Kp haplotypes (kernels/gibbs_sweep.py:fwd_form)."""
    form = fwd_form(Kp, nl)
    if form > 0:
        return f"register, {form} chain threads"
    return {GENERAL: "general", CLUSTER: "cluster"}.get(form, "global")


def time_call(world: dict, C: int, n_its: int, rng: np.random.Generator, device,
              reps: int = REPS) -> float:
    """Mean seconds of a C-chain, n_its-sweep call on the card (after a warm-up)."""
    dev = require_cuda(device)
    state = gibbs_state(world, C, n_its, rng)
    return timed(lambda: run_gibbs(world, state), dev, reps)[1]


def gibbs_report(world: dict, rng: np.random.Generator, device="cuda", chains=CHAINS,
                 reps: int = REPS) -> Dict:
    """tools/bench_gibbs.py's report: batch_scaling_21_sweeps at each chain
    count and c7_split (2 against 21 sweeps at 7 chains), beside the card."""
    dev = require_cuda(device)
    nReads = world["reads"].nReads
    results = dict(device_report(dev), nReads=nReads, Ksubset=world["Ksub"],
                   nGrids=world["nGrids"])
    table = {}
    for C in chains:
        dt = time_call(world, C, N_ITS, rng, dev, reps)
        table[str(C)] = {"seconds_per_call": dt,
                         "read_resamples_per_s": N_ITS * C * nReads / dt,
                         "chain_sweeps_per_s": N_ITS * C / dt,
                         "backend": form_name(world["Kp"])}
        print(f"C={C}: {dt:.4f} s -> {N_ITS * C * nReads / dt:,.0f} resamples/s", flush=True)
    results["batch_scaling_21_sweeps"] = table
    d2 = time_call(world, 7, 2, rng, dev, reps)
    d21 = table["7"]["seconds_per_call"] if "7" in table else time_call(world, 7, N_ITS, rng, dev,
                                                                        reps)
    results["c7_split"] = {"seconds_2_sweeps": d2, "seconds_21_sweeps": d21,
                           "marginal_seconds_per_sweep": (d21 - d2) / (N_ITS - 2)}
    return results


def main(device="cuda") -> dict:
    dev = require_cuda(device)
    rng = np.random.default_rng(0)
    return gibbs_report(gibbs_world(rng, dev), rng, dev)
