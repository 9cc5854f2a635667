"""Multi-sample batched imputation, diploid and NIPT, QUILT1 and QUILT2, on
one device or a mesh of them (the Gibbs chains split over its devices, the
full-panel FB over its panel axis).

The port of quilt_tpu/engine/batch.py:impute_samples_batched (:67-709).
Batch rows are {sample x chain}, each with nl = 2 latent haplotypes (diploid)
or 3 (NIPT: mother + fetus, one fetal fraction per batch); per seek iteration
a 21-sweep Gibbs call labels every read. QUILT1: the labels give haploid GLs, the
full-panel FB gives dosages and top-K matches, and the haplotype subsets
are re-selected on the device (on the host from the panel-sharded FB's
merged lists, when the context holds one). msPBWT (QUILT2): the Gibbs
call's own haplotype dosages are the dosages, and their distinct-haplotype
symbols drive the host msPBWT match search that re-selects the subsets. Dosages
and genotype posteriors accumulate past the seek burn-in; a read-label
consensus across chains seeds a final phasing pass. Rare/common (QUILT2):
the seek loop runs on common SNPs, then one all-SNP Gibbs call after the
seek loop and one after the phasing pass give the all-SNP outputs. NIPT
keeps, beside the maternal dosages (haplotypes 1 + 2), the fetal ones
(1 + 3), and folds label 2 onto 1 for the consensus.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import ImputeConfig
from ..io.reads import SampleReads
from ..utils import print_message

from ..inputs import GibbsInputs, PaddedReads, pad_to_multiple
from ..kernels.emissions import (
    ReadWindowCache, emat_read_from_bits, gather_words, gls_from_labels_windowed,
    lem_full_from_cache, lem_subset,
)
from ..kernels.fb import fb_full_batched
from ..kernels.gibbs import SlotLayout
from ..panel.mspbwt import select_new_haps_mspbwt_batch, symbols_device
from .context import RegionContext, sample_allele_count
from .rare_common import initial_all_snp_labels
from .selection import (
    consensus_read_labels, read_confidence_device, recast_haps, recast_nipt_haps,
    select_new_haps_device, select_new_haps_host,
)

# host-memory budget of the whole-panel eMatRead cache when the device is
# the CPU (the JAX package's 2.5 GB); on a GPU the budget is a quarter of
# the card's memory (20 GB on an 80 GB H100)
_CPU_LEM_BUDGET = int(2.5e9)


@dataclass
class SampleResult:
    imputed: bool
    dosage: Optional[np.ndarray] = None        # [nSNPs] diploid dosage (NIPT: maternal)
    gp: Optional[np.ndarray] = None            # [3, nSNPs]
    phased_haps: Optional[np.ndarray] = None   # [2 or 3, nSNPs] 0/1
    read_labels: Optional[np.ndarray] = None   # [R]
    allele_count: Optional[np.ndarray] = None  # [nSNPs, 2] (alt, total)
    # NIPT: maternal (haplotypes 1 + 2) and fetal (1 + 3) posteriors and dosages
    mat_gp: Optional[np.ndarray] = None
    fet_gp: Optional[np.ndarray] = None
    mat_dosage: Optional[np.ndarray] = None
    fet_dosage: Optional[np.ndarray] = None
    # HLA run (the per-sample engine): the full-panel gamma of every chain
    # and latent haplotype at the capture grid, and its sum
    hla_gammas: Optional[np.ndarray] = None       # [C, nl, K]
    hla_gamma_total: Optional[np.ndarray] = None  # [K]
    # per-sample engine, when a diagnostic option asks: the last Gibbs
    # call's per-iteration likelihoods (kernels.gibbs.PER_IT_COLS) and NIPT
    # read classes, the chain-mean dosage after each seek iteration, the
    # chains' read labels after each seek iteration
    per_it_likelihoods: Optional[np.ndarray] = None  # [n_its, C, 8]
    H_class: Optional[np.ndarray] = None             # [C, R] (NIPT)
    seek_dosages: Optional[np.ndarray] = None        # [n_seek_its, nSNPs]
    read_label_usage: Optional[np.ndarray] = None    # [n_seek_its, C, nReads]


def timed_sections(timers, dev):
    """sec(name): a context manager timing `name` on `timers` when timing
    is on; the section drains the device queue before its clock stops, so
    asynchronous work lands on the section that issued it."""

    @contextlib.contextmanager
    def sec(name):
        if not timers.enabled:
            yield
            return
        with timers.section(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    return sec


def lem_full_budget(device: torch.device) -> int:
    """Bytes the whole-panel log eMatRead cache and the expanded panel may
    take together (the gate of the per-batch cache)."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return _CPU_LEM_BUDGET


def impute_samples_batched(ctx: RegionContext, reads_list: Sequence[SampleReads],
                           cfg: ImputeConfig, seed: int, ff: float = 0.0,
                           reads_all_list: Optional[Sequence[SampleReads]] = None,
                           ) -> List[SampleResult]:
    """Whole-batch underflow retry (reference: the per-call /10 retry of
    functions.R:2704-2714): the underflow flag is checked once at the end
    of a batch, and on underflow the whole batch reruns with seed+attempt
    and a tenth of maxDifferenceBetweenReads. ff is the batch's fetal
    fraction (NIPT). Under rare/common, reads_list holds the common-SNP
    reads and reads_all_list the same samples' all-SNP reads."""
    max_diff = cfg.maxDifferenceBetweenReads
    for attempt in range(11):
        with ctx.timers.section("engine.group"):
            results, uf_seen = _impute_once(ctx, reads_list, cfg, seed + attempt, max_diff,
                                            ff, reads_all_list)
        if not uf_seen:
            return results
        max_diff = max(1.0, max_diff / 10.0)
        print_message(f"Underflow; rerunning batch with maxDifferenceBetweenReads={max_diff}")
    return results


def _impute_once(ctx: RegionContext, reads_list, cfg: ImputeConfig, seed: int,
                 max_diff: float, ff: float = 0.0, reads_all_list=None):
    prep = ctx.prep
    dev = ctx.device
    nSNPs, nGrids, K, nl = prep.nSNPs, prep.nGrids, prep.K, ctx.n_latent
    label_prior = [0.5, 0.5] if nl == 2 else [0.5, (1 - ff) / 2, ff / 2]
    use_ms = cfg.use_mspbwt
    rare_common = reads_all_list is not None
    rng = np.random.default_rng(seed)
    sec = timed_sections(ctx.timers, dev)
    span = ctx.timers.section          # drains nothing
    gibbs = ctx.gibbs_call()

    S = len(reads_list)
    C = cfg.nGibbsSamples
    B = S * C
    with span("engine.prologue"):
        ok = [r.nReads >= cfg.minimum_number_of_sample_reads for r in reads_list]
        with span("engine.sort_reads"):
            reads_sorted = [r.sorted_by_grid() for r in reads_list]
        with sec("inputs_build"):
            with span("inputs.gibbs_inputs"):
                ginputs = GibbsInputs.build_batched(reads_sorted, ctx.trans,
                                                    nGrids).repeat_rows(C)
            R = ginputs.R
            with span("inputs.padded_reads"):
                preads1 = PaddedReads.build_batched(reads_sorted, ref_error=prep.ref_error)
            with span("inputs.slot_layout"):
                layout = SlotLayout.build(ginputs, B, dev)
        n_its = cfg.small_ref_panel_gibbs_iterations + 1

        with span("engine.draws"):
            which_haps = np.stack([np.sort(rng.choice(K, size=ctx.Ksub, replace=False))
                                   for _ in range(B)])
            H = np.zeros((B, R), dtype=np.int32)
            for s in range(S):
                nr = reads_sorted[s].nReads
                for c in range(C):
                    H[s * C + c, :nr] = rng.choice(nl, size=nr, p=label_prior)
            first_read = np.array([rng.integers(0, max(reads_sorted[b // C].nReads, 1))
                                   for b in range(B)], dtype=np.int32)
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(rng.integers(0, 2**31)))

        do_block = np.zeros(n_its, dtype=bool)
        for bit in cfg.small_ref_panel_block_gibbs_iterations:
            if 1 <= bit <= n_its:
                do_block[bit - 1] = True
        nb_slots = ctx.block_slots()
        Kp_sub = pad_to_multiple(ctx.Ksub, 128)

        # per-sample read tensors, replicated to chain rows on the device
        as_t = lambda x: torch.as_tensor(x, device=dev)
        with span("engine.read_rows"):
            rows = {k: torch.repeat_interleave(as_t(getattr(preads1, a)), C, dim=0)
                    for k, a in (("u", "u_pad"), ("pr", "lpr"), ("pa", "lpa"), ("lr", "lr"),
                                 ("la", "la"))}
        with span("engine.read_cache"):
            gl_cache = ReadWindowCache(preads1.u_pad, preads1.lpr, preads1.lpa, preads1.mask,
                                       nGrids, dev, lr=preads1.lr, la=preads1.la)
        lem_full = None
        if (S * K * gl_cache.Rpad + K * nGrids * 32) * 4 <= lem_full_budget(dev):
            with sec("emat:full_build"):
                lem_full = lem_full_from_cache(ctx.e_full_dev(), gl_cache)
        sp_of_row = torch.repeat_interleave(torch.arange(S, device=dev), C)
        uf_any = torch.zeros((), dtype=torch.bool, device=dev)

    def read_lem(words, r, md, R_out):
        """Log read emissions [B, Kp, R_out] from the subset words, and the
        uninformative-read flags (max - min <= 1e-9)."""
        em = emat_read_from_bits(words, r["u"], r["lr"], r["la"], md, R_out=R_out)
        return torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9

    def pad_subsets(which_b):
        # pad the subsets by repeating their first haplotype: pad rows
        # carry zero weight in every kernel sum
        return torch.cat([which_b, which_b[:, :1].expand(-1, Kp_sub - which_b.shape[1])], 1)

    def run_chains(which_b, H0_b, iterative, first_b):
        """One n_its-sweep Gibbs call; the underflow flag accumulates on the
        device and is read once at the end of the batch. Returns the labels
        and, under msPBWT, the Gibbs haplotype dosages [B, nl, nSNPs]."""
        nonlocal uf_any
        Ksub_b = which_b.shape[1]
        words = None
        with sec("gibbs:bits_gather"):
            which_p = pad_subsets(which_b)
            if use_ms or lem_full is None:
                words = gather_words(ctx.rhb_dev(), which_p)
        with sec("gibbs:rng"):
            uniforms = torch.rand((n_its, B, R), generator=gen, device=dev)
            block_u = torch.rand((n_its, max(nb_slots, 1), 3, B), generator=gen,
                                 device=dev)[:, :nb_slots]
            # the NIPT block move resamples the labels from the read classes
            resample_u = (torch.rand((n_its, B, R), generator=gen, device=dev)
                          if nl == 3 and nb_slots else None)
        if lem_full is not None:
            with sec("gibbs:lem_subset"):
                lem, skip = lem_subset(lem_full, sp_of_row[:, None] * K + which_p, max_diff, R)
        with sec("gibbs:sweep_kernel"):
            if lem_full is None:
                with span("sweep.read_lem"):
                    lem, skip = read_lem(words, rows, max_diff, R)
            call = gibbs(
                layout, ctx.tensors["gibbs_trans"], lem, skip, uniforms, H0_b,
                first_b, iterative, Ksub_b,
                block_u=block_u if nb_slots else None, do_block=do_block,
                smooth_w=ctx.smooth_w, quantile_prob=ctx.block_quantile,
                words=words if use_ms else None, ref_error=prep.ref_error, timed=sec,
                nl=nl, ff=ff, resample_u=resample_u, boundaries=ctx.boundaries_dev(), span=span,
            )
        uf_any = uf_any | call.underflow.any()
        return call.H, None if call.hap_dos is None else call.hap_dos[:, :, :nSNPs]

    def run_fb_and_select(H_b, which_b):
        with sec("fb:gl_build"):
            gls = gls_from_labels_windowed(gl_cache, H_b, nl, C, ctx.fb_inputs.S,
                                           minGLValue=cfg.minGLValue)
        if ctx.sharded_fb is not None:
            # the panel-sharded FB's lists, K_top x n_panel wide and merged
            # by value, go to the host selection (quilt_tpu/engine/batch.py:
            # 319-360)
            with sec("fb:kernel"):
                dosage, _, tv, ti = ctx.sharded_fb(gls)
            with sec("fb:select_host"):
                new_sets = select_new_haps_host(
                    tv.cpu().numpy(), ti.cpu().numpy(), ctx.thinned_grids,
                    which_b.cpu().numpy(), rng, ctx.Ksub - ctx.Knew, ctx.Knew, K, nl,
                    cfg.K_top_matches)
            return dosage.reshape(B, nl, nSNPs), as_t(new_sets)
        with sec("fb:kernel"):
            dosage, _, tv, ti = fb_full_batched(
                gls, ctx.fb_inputs, K_top=max(8, cfg.K_top_matches),
                ref_error=prep.ref_error, **ctx.fb_plan_args,
            )
        with sec("fb:select"):
            thin = torch.as_tensor(ctx.thinned_grids, device=dev)
            new_sets = select_new_haps_device(
                tv[thin], ti[thin], which_b, gen, ctx.Ksub - ctx.Knew, ctx.Knew,
                K, nl, cfg.K_top_matches,
            )
        return dosage[:, :nSNPs].reshape(B, nl, nSNPs), new_sets

    def select_mspbwt(hap_dos, which_b):
        """msPBWT re-selection (reference: select_new_haps_mspbwt_v3,
        mspbwt.R:230-474): symbols of the rounded dosages on the device, then
        the host match scan, ranking and interleave for the whole batch."""
        with sec("select:mspbwt"):
            z_all = symbols_device(hap_dos, ctx.dh_bits(), nSNPs).cpu().numpy()
            which_np = which_b.cpu().numpy()
            n_keep = ctx.Ksub - ctx.Knew
            prev_list = [rng.choice(which_np[b], size=n_keep, replace=False)
                         for b in range(B)]
            news = select_new_haps_mspbwt_batch(
                prep.ms_indices, prep.panel, z_all, ctx.Knew, K, prev_list, rng,
                mspbwtL=cfg.mspbwtL, mspbwtM=cfg.mspbwtM,
                heuristic_approach=cfg.heuristic_approach,
            )
            new_sets = np.stack([np.sort(np.concatenate([p, n])) for p, n in zip(prev_list, news)])
        return as_t(new_sets.astype(np.int64))

    def seek_step(which_b, H0_b, iterative, first_b):
        """One seek iteration: (labels, hap dosages [B, nl, nSNPs], new subsets)."""
        Hn, hap_dos = run_chains(which_b, H0_b, iterative, first_b)
        if use_ms:
            return Hn, hap_dos, select_mspbwt(hap_dos, which_b)
        hap_dos, new_sets = run_fb_and_select(Hn, which_b)
        return Hn, hap_dos, new_sets

    if rare_common:
        reads_all_sorted = [r.sorted_by_grid() for r in reads_all_list]
        nSNPs_all = len(prep.snp_is_common)
        with sec("inputs_build"):
            gin_all = GibbsInputs.build_batched(
                reads_all_sorted, ctx.trans_all, ctx.nGrids_all).repeat_rows(C)
            R_all = gin_all.R
            pr_all = PaddedReads.build_batched(reads_all_sorted, ref_error=prep.ref_error)
            layout_all = SlotLayout.build(gin_all, B, dev)
        rows_all = {k: torch.repeat_interleave(as_t(getattr(pr_all, a)), C, dim=0)
                    for k, a in (("u", "u_pad"), ("lr", "lr"), ("la", "la"))}

    def run_all_snp_gibbs(which_b, hap_dos_common):
        """The final all-SNP Gibbs call of rare/common imputation for the
        whole batch (reference: rare_common.R:109-470, per sample there):
        labels start from the common-SNP dosages, the subset words come from
        the region's all-SNP panel, no block moves, and an underflow retries
        the call with a tenth of maxDifferenceBetweenReads (11 attempts).
        Returns the hap dosages [B, nl, nSNPs_all]."""
        Ksub_b = which_b.shape[1]
        with sec("rare:bits_build"):
            words = gather_words(ctx.tensors["rhb_all"], pad_subsets(which_b))
        hd_common = hap_dos_common.cpu().numpy()
        H0 = np.zeros((B, R_all), dtype=np.int32)
        for b in range(B):
            ra = reads_all_sorted[b // C]
            H0[b, :ra.nReads] = initial_all_snp_labels(ra, hd_common[b], prep.snp_is_common,
                                                       nl, ff, rng)
        uniforms = as_t(rng.random((n_its, B, R_all)).astype(np.float32))
        H0, zero = as_t(H0), torch.zeros(B, dtype=torch.int32, device=dev)
        md = max_diff
        for _ in range(11):
            with sec("rare:sweep_kernel"):
                with span("sweep.read_lem"):
                    lem, skip = read_lem(words, rows_all, md, R_all)
                call = gibbs(
                    layout_all, ctx.tensors["gibbs_trans_all"], lem, skip, uniforms, H0, zero,
                    False, Ksub_b, words=words, ref_error=prep.ref_error, timed=sec,
                    nl=nl, ff=ff, span=span,
                )
            if not bool(call.underflow.any()):
                break
            md = max(1.0, md / 10.0)
            print_message(f"Underflow in all-SNP Gibbs; retrying batch with "
                          f"maxDifferenceBetweenReads={md}")
        return call.hap_dos[:, :, :nSNPs_all]

    class Accumulator:
        """Per-sample sums over chains of the maternal (haplotypes 1 + 2; the
        diploid pair) and, for NIPT, fetal (1 + 3) dosages and genotype
        posteriors; they stay on the device until `means`."""

        def __init__(self, n_sites):
            self.n = 0
            self.sums = [(torch.zeros((S, n_sites), dtype=torch.float32, device=dev),
                          torch.zeros((S, 3, n_sites), dtype=torch.float32, device=dev))
                         for _ in range(nl - 1)]

        def add(self, hap_dos):
            for other, (dos, gp) in enumerate(self.sums, start=1):
                _accumulate(dos, gp, hap_dos, S, C, other)
            self.n += C

        def means(self):
            """[(dosage [S, n], gp [S, 3, n])] float64: maternal, then fetal."""
            return [tuple(x.double().cpu().numpy() / max(self.n, 1) for x in pair)
                    for pair in self.sums]

    acc = Accumulator(nSNPs)
    which = as_t(which_haps.astype(np.int64))
    H_dev = as_t(H)
    first = as_t(first_read)
    hap_dos = None
    for i_it in range(1, ctx.n_seek_its + 1):
        H_dev, hap_dos, which = seek_step(which, H_dev, i_it == 1, first)
        if i_it > ctx.n_burn_in_seek_its:
            with sec("accumulate"):
                acc.add(hap_dos)
    with sec("final_fetch"):
        means = acc.means()
    if rare_common:
        # all-SNP outputs: one final all-SNP call on the last seek state
        acc = Accumulator(nSNPs_all)
        acc.add(run_all_snp_gibbs(which, hap_dos))
        means = acc.means()

    # per-sample consensus: read confidence on the device from the final
    # per-chain dosages; the flip-detection walk is sequential, on the host
    with sec("consensus"):
        conf = read_confidence_device(hap_dos, rows["u"], rows["pr"], rows["pa"], nl).cpu().numpy()
        H_np = H_dev.cpu().numpy()
        cons_list = []
        for s in range(S):
            nr = reads_sorted[s].nReads
            labels_all = H_np[s * C:(s + 1) * C, :nr].T.astype(np.int64)
            conf_all = conf[s * C:(s + 1) * C, :nr].T
            if nl == 3:
                # the flip walk knows two labels: fetal reads count as the
                # mother's second haplotype and are never confident, then
                # take their label back from the canonical chain
                fetal = labels_all == 2
                cons = consensus_read_labels(np.where(fetal, 1, labels_all), conf_all & ~fetal)
                cons[fetal[:, C - 1]] = 2
            else:
                cons = consensus_read_labels(labels_all, conf_all)
            cons_list.append(cons)

    # phasing pass: one chain per sample, replicated over the C rows
    with span("engine.phasing"):
        H_p = np.zeros((B, R), dtype=np.int32)
        for s in range(S):
            H_p[s * C:(s + 1) * C, :reads_sorted[s].nReads] = cons_list[s]
        rows_last = torch.as_tensor(np.arange(S) * C + (C - 1), device=dev)
        wh_p = torch.repeat_interleave(which[rows_last], C, dim=0)
        H_p = as_t(H_p)
        first_zero = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(ctx.n_seek_its):
            H_p, hap_dos_ph, wh_p = seek_step(wh_p, H_p, False, first_zero)
        if rare_common:
            hap_dos_ph = run_all_snp_gibbs(wh_p, hap_dos_ph)
    with span("engine.results"):
        rows0 = torch.as_tensor(np.arange(S) * C, device=dev)
        hap_dos_ph = hap_dos_ph[rows0].double().cpu().numpy()

        results: List[SampleResult] = []
        for s in range(S):
            if not ok[s]:
                results.append(SampleResult(imputed=False))
                continue
            dosage, gp = means[0][0][s], means[0][1][s]
            common = dict(
                imputed=True, dosage=dosage, gp=gp, read_labels=cons_list[s],
                allele_count=(sample_allele_count(reads_all_sorted[s], nSNPs_all) if rare_common
                              else sample_allele_count(reads_sorted[s], nSNPs)),
            )
            if nl == 2:
                hd1, hd2 = recast_haps(hap_dos_ph[s, 0], hap_dos_ph[s, 1], gp)
                results.append(SampleResult(
                    phased_haps=np.stack([np.round(hd1), np.round(hd2)]), **common))
            else:
                fet_dosage, fet_gp = means[1][0][s], means[1][1][s]
                results.append(SampleResult(
                    phased_haps=np.stack(recast_nipt_haps(*hap_dos_ph[s], gp, fet_gp)),
                    mat_gp=gp, fet_gp=fet_gp, mat_dosage=dosage, fet_dosage=fet_dosage, **common))
        uf_seen = bool(uf_any.item())
    return results, uf_seen


def _accumulate(dosage_acc, gp_acc, hap_dos, S, C, other=1):
    """Add the chains' dosages and genotype posteriors of the haplotype pair
    (0, other) of hap_dos [S*C, nl, n] to the per-sample accumulators
    [S, n] / [S, 3, n], in place."""
    n = hap_dos.shape[2]
    h1 = hap_dos[:, 0].reshape(S, C, n)
    h2 = hap_dos[:, other].reshape(S, C, n)
    dosage_acc += (h1 + h2).sum(1)
    gp_acc[:, 0] += ((1 - h1) * (1 - h2)).sum(1)
    gp_acc[:, 1] += (h1 * (1 - h2) + (1 - h1) * h2).sum(1)
    gp_acc[:, 2] += (h1 * h2).sum(1)
