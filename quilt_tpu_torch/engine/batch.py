"""Multi-sample batched QUILT1 diploid imputation on one device.

The diploid, non-msPBWT branch of quilt_tpu/engine/batch.py:
impute_samples_batched (:67-709). Batch rows are {sample x chain}; per
seek iteration a 21-sweep Gibbs call labels every read, the labels give
haploid GLs, the full-panel FB gives dosages and top-K matches, and the
haplotype subsets are re-selected on the device. Dosages and genotype
posteriors accumulate past the seek burn-in; a read-label consensus
across chains seeds a final phasing pass.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from quilt_tpu.config import ImputeConfig
from quilt_tpu.io.reads import SampleReads
from quilt_tpu.utils import print_message

from ..inputs import GibbsInputs, PaddedReads, pad_to_multiple
from ..kernels.emissions import (
    ReadWindowCache, emat_read_from_bits, gather_words, gls_from_labels_windowed,
    lem_full_from_cache, lem_subset,
)
from ..kernels.fb import fb_full_batched
from ..kernels.gibbs import SlotLayout, run_gibbs_chains
from .context import RegionContext, sample_allele_count
from .selection import (
    consensus_read_labels, read_confidence_device, recast_haps,
    select_new_haps_device,
)

# host-memory budget of the whole-panel eMatRead cache when the device is
# the CPU (the JAX package's 2.5 GB); on a GPU the budget is a quarter of
# the card's memory (20 GB on an 80 GB H100)
_CPU_LEM_BUDGET = int(2.5e9)


@dataclass
class SampleResult:
    imputed: bool
    dosage: Optional[np.ndarray] = None        # [nSNPs] diploid dosage
    gp: Optional[np.ndarray] = None            # [3, nSNPs]
    phased_haps: Optional[np.ndarray] = None   # [2, nSNPs] 0/1
    read_labels: Optional[np.ndarray] = None   # [R]
    allele_count: Optional[np.ndarray] = None  # [nSNPs, 2] (alt, total)


def lem_full_budget(device: torch.device) -> int:
    """Bytes the whole-panel log eMatRead cache and the expanded panel may
    take together (the gate of the per-batch cache)."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return _CPU_LEM_BUDGET


def impute_samples_batched(ctx: RegionContext, reads_list: Sequence[SampleReads],
                           cfg: ImputeConfig, seed: int) -> List[SampleResult]:
    """Whole-batch underflow retry (reference: the per-call /10 retry of
    functions.R:2704-2714): the underflow flag is checked once at the end
    of a batch, and on underflow the whole batch reruns with seed+attempt
    and a tenth of maxDifferenceBetweenReads."""
    max_diff = cfg.maxDifferenceBetweenReads
    for attempt in range(11):
        results, uf_seen = _impute_once(ctx, reads_list, cfg, seed + attempt, max_diff)
        if not uf_seen:
            return results
        max_diff = max(1.0, max_diff / 10.0)
        print_message(f"Underflow; rerunning batch with maxDifferenceBetweenReads={max_diff}")
    return results


def _impute_once(ctx: RegionContext, reads_list, cfg: ImputeConfig, seed: int,
                 max_diff: float):
    prep = ctx.prep
    dev = ctx.device
    nSNPs, nGrids, K, nl = prep.nSNPs, prep.nGrids, prep.K, 2
    rng = np.random.default_rng(seed)
    timers = ctx.timers

    @contextlib.contextmanager
    def sec(name):
        # a timed section drains the device queue before its clock stops,
        # so asynchronous work lands on the section that issued it
        if not timers.enabled:
            yield
            return
        with timers.section(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    S = len(reads_list)
    C = cfg.nGibbsSamples
    B = S * C
    ok = [r.nReads >= cfg.minimum_number_of_sample_reads for r in reads_list]
    reads_sorted = [r.sorted_by_grid() for r in reads_list]
    with sec("inputs_build"):
        ginputs = GibbsInputs.build_batched(reads_sorted, ctx.trans, nGrids).repeat_rows(C)
        R = ginputs.R
        preads1 = PaddedReads.build_batched(reads_sorted, ref_error=prep.ref_error)
        layout = SlotLayout.build(ginputs, B, dev)
    n_its = cfg.small_ref_panel_gibbs_iterations + 1

    which_haps = np.stack([np.sort(rng.choice(K, size=ctx.Ksub, replace=False))
                           for _ in range(B)])
    H = np.zeros((B, R), dtype=np.int32)
    for s in range(S):
        nr = reads_sorted[s].nReads
        for c in range(C):
            H[s * C + c, :nr] = rng.choice(nl, size=nr, p=[0.5, 0.5])
    first_read = np.array([rng.integers(0, max(reads_sorted[b // C].nReads, 1))
                           for b in range(B)], dtype=np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**31)))

    do_block = np.zeros(n_its, dtype=bool)
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if 1 <= bit <= n_its:
            do_block[bit - 1] = True
    nb_slots = ctx.block_nb_cap if ctx.smooth_w is not None else 0
    Kp_sub = pad_to_multiple(ctx.Ksub, 128)

    # per-sample read tensors, replicated to chain rows on the device
    as_t = lambda x: torch.as_tensor(x, device=dev)
    rows = {k: torch.repeat_interleave(as_t(getattr(preads1, a)), C, dim=0)
            for k, a in (("u", "u_pad"), ("pr", "lpr"), ("pa", "lpa"), ("lr", "lr"), ("la", "la"))}
    gl_cache = ReadWindowCache(preads1.u_pad, preads1.lpr, preads1.lpa, preads1.mask,
                               nGrids, dev, lr=preads1.lr, la=preads1.la)
    lem_full = None
    if (S * K * gl_cache.Rpad + K * nGrids * 32) * 4 <= lem_full_budget(dev):
        with sec("emat:full_build"):
            lem_full = lem_full_from_cache(ctx.e_full_dev(), gl_cache)
    sp_of_row = torch.repeat_interleave(torch.arange(S, device=dev), C)
    uf_any = torch.zeros((), dtype=torch.bool, device=dev)

    def run_chains(which_b, H0_b, iterative, first_b):
        """One n_its-sweep Gibbs call; the underflow flag accumulates on the
        device and is read once at the end of the batch."""
        nonlocal uf_any
        Ksub_b = which_b.shape[1]
        with sec("gibbs:bits_gather"):
            # pad the subsets by repeating their first haplotype: pad rows
            # carry zero weight in every kernel sum
            which_p = torch.cat([which_b, which_b[:, :1].expand(-1, Kp_sub - Ksub_b)], 1)
        with sec("gibbs:rng"):
            uniforms = torch.rand((n_its, B, R), generator=gen, device=dev)
            block_u = torch.rand((n_its, max(nb_slots, 1), 3, B), generator=gen,
                                 device=dev)[:, :nb_slots]
        if lem_full is not None:
            with sec("gibbs:lem_subset"):
                lem, skip = lem_subset(lem_full, sp_of_row[:, None] * K + which_p, max_diff, R)
        with sec("gibbs:sweep_kernel"):
            if lem_full is None:
                em = emat_read_from_bits(gather_words(ctx.rhb_dev(), which_p), rows["u"],
                                         rows["lr"], rows["la"], max_diff, R_out=R)
                lem, skip = torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9
            Hn, _, uf = run_gibbs_chains(
                layout, ctx.tensors["gibbs_trans"], lem, skip, uniforms, H0_b,
                first_b, iterative, Ksub_b,
                block_u=block_u if nb_slots else None, do_block=do_block,
                smooth_w=ctx.smooth_w, quantile_prob=ctx.block_quantile,
            )
        uf_any = uf_any | uf.any()
        return Hn

    S_pad = ctx.fb_inputs.S
    thin = torch.as_tensor(ctx.thinned_grids, device=dev)

    def run_fb_and_select(H_b, which_b):
        with sec("fb:gl_build"):
            gls = gls_from_labels_windowed(gl_cache, H_b, nl, C, S_pad,
                                           minGLValue=cfg.minGLValue)
        with sec("fb:kernel"):
            dosage, _, tv, ti = fb_full_batched(
                gls, ctx.fb_inputs, K_top=max(8, cfg.K_top_matches),
                ref_error=prep.ref_error,
            )
        with sec("fb:select"):
            new_sets = select_new_haps_device(
                tv[thin], ti[thin], which_b, gen, ctx.Ksub - ctx.Knew, ctx.Knew,
                K, nl, cfg.K_top_matches,
            )
        return dosage[:, :nSNPs].reshape(B, nl, nSNPs), new_sets

    dosage_acc = torch.zeros((S, nSNPs), dtype=torch.float32, device=dev)
    gp_acc = torch.zeros((S, 3, nSNPs), dtype=torch.float32, device=dev)
    n_acc = 0
    which = as_t(which_haps.astype(np.int64))
    H_dev = as_t(H)
    first = as_t(first_read)
    hap_dos = None
    for i_it in range(1, ctx.n_seek_its + 1):
        H_dev = run_chains(which, H_dev, i_it == 1, first)
        hap_dos, which = run_fb_and_select(H_dev, which)
        if i_it > ctx.n_burn_in_seek_its:
            with sec("accumulate"):
                h1 = hap_dos[:, 0].reshape(S, C, nSNPs)
                h2 = hap_dos[:, 1].reshape(S, C, nSNPs)
                # in place: the accumulators stay device-resident
                dosage_acc += (h1 + h2).sum(1)
                gp_acc[:, 0] += ((1 - h1) * (1 - h2)).sum(1)
                gp_acc[:, 1] += (h1 * (1 - h2) + (1 - h1) * h2).sum(1)
                gp_acc[:, 2] += (h1 * h2).sum(1)
            n_acc += C
    with sec("final_fetch"):
        dosage_np = dosage_acc.double().cpu().numpy()
        gp_np = gp_acc.double().cpu().numpy()

    # per-sample consensus: read confidence on the device from the final
    # per-chain dosages; the flip-detection walk is sequential, on the host
    with sec("consensus"):
        conf = read_confidence_device(hap_dos, rows["u"], rows["pr"], rows["pa"], nl).cpu().numpy()
        H_np = H_dev.cpu().numpy()
        cons_list = []
        for s in range(S):
            nr = reads_sorted[s].nReads
            cons_list.append(consensus_read_labels(
                H_np[s * C:(s + 1) * C, :nr].T.astype(np.int64),
                conf[s * C:(s + 1) * C, :nr].T,
            ))

    # phasing pass: one chain per sample, replicated over the C rows
    H_p = np.zeros((B, R), dtype=np.int32)
    for s in range(S):
        H_p[s * C:(s + 1) * C, :reads_sorted[s].nReads] = cons_list[s]
    rows_last = torch.as_tensor(np.arange(S) * C + (C - 1), device=dev)
    wh_p = torch.repeat_interleave(which[rows_last], C, dim=0)
    H_p = as_t(H_p)
    first_zero = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(ctx.n_seek_its):
        H_p = run_chains(wh_p, H_p, False, first_zero)
        hap_dos_ph, wh_p = run_fb_and_select(H_p, wh_p)
    hap_dos_ph = hap_dos_ph[torch.as_tensor(np.arange(S) * C, device=dev)].double().cpu().numpy()

    results: List[SampleResult] = []
    for s in range(S):
        if not ok[s]:
            results.append(SampleResult(imputed=False))
            continue
        gp = gp_np[s] / max(n_acc, 1)
        hd1, hd2 = recast_haps(hap_dos_ph[s, 0], hap_dos_ph[s, 1], gp)
        results.append(SampleResult(
            imputed=True, dosage=dosage_np[s] / max(n_acc, 1), gp=gp,
            phased_haps=np.stack([np.round(hd1), np.round(hd2)]),
            read_labels=cons_list[s],
            allele_count=sample_allele_count(reads_sorted[s], nSNPs),
        ))
    return results, bool(uf_any.item())
