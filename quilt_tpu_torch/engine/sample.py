"""Per-sample imputation engine of the port: one sample's C Gibbs chains, a
read-label consensus and the phasing pass, diploid or NIPT, QUILT1 or
QUILT2; the engine of a lone sample and of every sample of an HLA run.

The port of quilt_tpu/engine/sample.py:impute_one_sample (:246-713) over the
port's device calls: the Gibbs call (kernels.gibbs.run_gibbs_chains on the
sample's slot layout, the read emissions from the whole-panel eMatRead
cache of kernels.emissions, or from the subset words when the cache is over
its budget) and the full-panel FB (kernels.fb.fb_full_batched, which in an
HLA run also returns the state posterior at the capture grid). As in the
JAX engine, the work between the device calls runs on the host from one
NumPy generator: the GLs from the read labels, the top-K re-selection
(QUILT1) or the msPBWT scan (QUILT2), the read confidence and the
cross-chain consensus; an underflow reruns that Gibbs call with a tenth of
maxDifferenceBetweenReads (reference: functions.R:2704-2714). When a
diagnostic option asks, the result also carries what the JAX engine
records for it (:404-406, 510-521, 571-583): the last Gibbs call's
per-iteration likelihoods and NIPT read classes, the dosage after each
seek iteration and the chains' labels after each seek iteration.
optimal_hap_dosages (:727-755) gives the OHD field of addOptimalHapsToVCF.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ImputeConfig
from ..inputs import GibbsInputs, PaddedReads, pad_to_multiple
from ..io.reads import SampleReads, bq_to_probs
from ..kernels.emissions import (
    ReadWindowCache, emat_read_from_bits, gather_words, lem_full_from_cache, lem_subset,
)
from ..kernels.fb import fb_full_batched
from ..kernels.gibbs import SlotLayout
from ..panel.mspbwt import select_new_haps_mspbwt
from ..utils import print_message
from .batch import SampleResult, lem_full_budget, timed_sections
from .context import RegionContext, sample_allele_count
from .rare_common import initial_all_snp_labels
from .selection import (
    consensus_read_labels, read_confidence, recast_haps, recast_nipt_haps, select_new_haps_host,
)


def wants_dump(cfg: ImputeConfig) -> bool:
    """The npz dump of per-sample objects is asked for
    (quilt_tpu/engine/driver.py:442-448)."""
    return bool(cfg.output_read_label_prob or cfg.RData_objects_to_save
                or cfg.output_RData_filename or cfg.record_read_label_usage
                or cfg.record_interim_dosages)


def needs_per_sample_diagnostics(cfg: ImputeConfig) -> bool:
    """A diagnostic option that only the per-sample engine serves is set
    (quilt_tpu/engine/driver.py:146-151; addOptimalHapsToVCF is not one)."""
    return bool(cfg.make_heuristic_plot or cfg.make_plots or cfg.plot_per_sample_likelihoods
                or wants_dump(cfg))


def gls_from_labels(reads: SampleReads, H: np.ndarray, n_latent: int, nSNPs: int,
                    minGLValue: float = 1e-10) -> np.ndarray:
    """Haploid GLs [n_latent, 2, nSNPs] from read labels (vectorized host
    equivalent of make_gl_from_u_bq, reference-single.R:19-42)."""
    probs = bq_to_probs(reads.bq)
    read_of_base = np.repeat(np.arange(reads.nReads), np.diff(reads.offsets))
    h_of_base = H[read_of_base]
    gl = np.ones((n_latent, 2, nSNPs), dtype=np.float64)
    nz = reads.bq != 0
    for h in range(n_latent):
        w = (h_of_base == h) & nz
        np.multiply.at(gl[h, 0], reads.u[w], probs[w, 0])
        np.multiply.at(gl[h, 1], reads.u[w], probs[w, 1])
    if minGLValue > 0:
        hi = gl.max(axis=1, keepdims=True)
        fix = (gl < minGLValue).any(axis=1, keepdims=True)
        scaled = np.maximum(gl / hi, minGLValue)
        gl = np.where(fix, scaled, gl)
    return gl


def emat_read_vs_dosages(reads: SampleReads, hap_dos: np.ndarray,
                         max_diff: float = 1e10) -> np.ndarray:
    """P(read | hap dosage vector) per latent hap, [n_latent, R] (host;
    for read confidence, reference functions.R:1615-1660)."""
    nl = hap_dos.shape[0]
    probs = bq_to_probs(reads.bq)
    read_of_base = np.repeat(np.arange(reads.nReads), np.diff(reads.offsets))
    e = hap_dos[:, reads.u]                          # [nl, nBases]
    term = e * probs[None, :, 1] + (1 - e) * probs[None, :, 0]
    logterm = np.log(np.maximum(term, 1e-300))
    out = np.zeros((nl, reads.nReads))
    for h in range(nl):
        np.add.at(out[h], read_of_base, logterm[h])
    return np.exp(out)


class _ChainReads:
    """One sample's reads as the Gibbs call takes them for B chains: the slot
    layout (built once per chain count), the padded read rows, and, when
    it fits lem_full_budget, the whole-panel log eMatRead of the reads."""

    def __init__(self, ctx: RegionContext, reads: SampleReads, trans: np.ndarray,
                 nGrids: int, whole_panel: bool):
        dev = ctx.device
        self.device = dev
        self.gin = GibbsInputs.build_batched([reads], trans, nGrids)
        self.R = self.gin.R
        pr = PaddedReads.build_batched([reads], ref_error=ctx.prep.ref_error)
        self.rows = {k: torch.as_tensor(getattr(pr, k), device=dev) for k in ("u_pad", "lr", "la")}
        self._layouts: Dict[int, SlotLayout] = {}
        self.lem_full = None
        if whole_panel:
            cache = ReadWindowCache(pr.u_pad, pr.lpr, pr.lpa, pr.mask, nGrids, dev,
                                    lr=pr.lr, la=pr.la)
            K = ctx.prep.K
            if (K * cache.Rpad + K * nGrids * 32) * 4 <= lem_full_budget(dev):
                self.lem_full = lem_full_from_cache(ctx.e_full_dev(), cache)

    def layout(self, B: int) -> SlotLayout:
        if B not in self._layouts:
            self._layouts[B] = SlotLayout.build(self.gin, B, self.device)
        return self._layouts[B]

    def lem(self, which_p: torch.Tensor, words: Optional[torch.Tensor], max_diff: float):
        """(log read emissions [B, Kp, R], uninformative-read flags [B, R])
        against the padded subsets which_p [B, Kp] (words: their packed
        words, needed without the whole-panel cache)."""
        if self.lem_full is not None:
            return lem_subset(self.lem_full, which_p, max_diff, self.R)
        B = words.shape[0]
        r = {k: v.expand(B, -1, -1) for k, v in self.rows.items()}
        em = emat_read_from_bits(words, r["u_pad"], r["lr"], r["la"], max_diff, R_out=self.R)
        return torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9


def impute_one_sample(ctx: RegionContext, reads: SampleReads, cfg: ImputeConfig, seed: int,
                      ff: float = 0.0, reads_all: Optional[SampleReads] = None) -> SampleResult:
    """Impute one sample on ctx.device: C = cfg.nGibbsSamples chains through
    the seek iterations, dosages and genotype posteriors accumulated past
    the burn-in, then the consensus labels' phasing pass. ff is the fetal
    fraction (NIPT); under rare/common `reads` holds the common-SNP reads
    and reads_all the all-SNP ones, and the outputs lie on the all-SNP
    axis. In an HLA run (ctx.hla_capture) the result carries the captured
    gamma of the last seek iteration's FB."""
    prep = ctx.prep
    dev = ctx.device
    nSNPs, nGrids, K, nl = prep.nSNPs, prep.nGrids, prep.K, ctx.n_latent
    rng = np.random.default_rng(seed)
    sec = timed_sections(ctx.timers, dev)
    as_t = lambda x: torch.as_tensor(x, device=dev)
    gibbs = ctx.gibbs_call()

    if reads.nReads < cfg.minimum_number_of_sample_reads:
        return SampleResult(imputed=False)

    reads = reads.sorted_by_grid()
    C = cfg.nGibbsSamples
    n_its = cfg.small_ref_panel_gibbs_iterations + 1
    use_ms = cfg.use_mspbwt
    with sec("inputs_build"):
        side = _ChainReads(ctx, reads, ctx.trans, nGrids, whole_panel=True)
    R = side.R
    label_prior = [0.5, 0.5] if nl == 2 else [0.5, (1 - ff) / 2, ff / 2]
    Kp_sub = pad_to_multiple(ctx.Ksub, 128)

    which_haps = np.stack([np.sort(rng.choice(K, size=ctx.Ksub, replace=False))
                           for _ in range(C)])
    H = np.zeros((C, R), dtype=np.int32)
    H[:, : reads.nReads] = rng.choice(nl, size=(C, reads.nReads), p=label_prior)
    max_diff = cfg.maxDifferenceBetweenReads

    hla_gammas = None
    dosage_acc = np.zeros(nSNPs)
    gp_acc = np.zeros((3, nSNPs))
    fet_dosage_acc = np.zeros(nSNPs)
    fet_gp_acc = np.zeros((3, nSNPs))
    n_acc = 0
    hap_dos_final = np.zeros((C, nl, nSNPs))

    do_block = np.zeros(n_its, dtype=bool)
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if 1 <= bit <= n_its:
            do_block[bit - 1] = True
    nb_slots = ctx.block_slots()
    # diagnostics, copied to the host only when an option reads them
    keep_calls = cfg.make_plots or cfg.plot_per_sample_likelihoods or wants_dump(cfg)
    keep_seek_dosages = cfg.make_heuristic_plot or cfg.record_interim_dosages
    diag: Dict = {"seek_dosages": [], "label_usage": []}

    def pad_subsets(which_b):
        # pad rows repeat the first haplotype: they carry zero weight
        which_b = np.asarray(which_b, dtype=np.int64)
        return as_t(np.concatenate(
            [which_b, np.repeat(which_b[:, :1], Kp_sub - which_b.shape[1], axis=1)], axis=1))

    def run_chains(which_b, H0_b, iterative, first_b, max_diff, dosages=use_ms):
        """One Gibbs call over the B chains, retried with a tenth of
        maxDifferenceBetweenReads on underflow. Returns (labels [B, R],
        the call (its dosages when `dosages`), max_diff)."""
        B = which_b.shape[0]
        which_p = pad_subsets(which_b)
        words = (gather_words(ctx.rhb_dev(), which_p)
                 if dosages or side.lem_full is None else None)
        uniforms = as_t(rng.random((n_its, B, R)).astype(np.float32))
        block_u = as_t(rng.random((n_its, nb_slots, 3, B)).astype(np.float32))
        resample_u = (as_t(rng.random((n_its, B, R)).astype(np.float32))
                      if nl == 3 and nb_slots else None)
        H0_t, first_t = as_t(np.ascontiguousarray(H0_b)), as_t(first_b.astype(np.int32))
        for _ in range(11):
            with sec("gibbs:sweep_kernel"):
                lem, skip = side.lem(which_p, words, max_diff)
                call = gibbs(
                    side.layout(B), ctx.tensors["gibbs_trans"], lem, skip, uniforms, H0_t,
                    first_t, iterative, which_b.shape[1],
                    block_u=block_u if nb_slots else None, do_block=do_block,
                    smooth_w=ctx.smooth_w, quantile_prob=ctx.block_quantile,
                    words=words if dosages else None, ref_error=prep.ref_error, timed=sec,
                    nl=nl, ff=ff, resample_u=resample_u, boundaries=ctx.boundaries_dev(),
                )
            if not bool(call.underflow.any()):
                break
            max_diff = max(1.0, max_diff / 10.0)
            print_message(f"Underflow; retrying with maxDifferenceBetweenReads={max_diff}")
        if keep_calls:
            diag["per_it"] = call.per_it.cpu().numpy()
            diag["H_class"] = call.H_class.cpu().numpy() if nl == 3 else None
        return call.H.cpu().numpy(), call, max_diff

    def ms_dosages(call):
        """The Gibbs call's hap dosages [B, nl, nSNPs] (msPBWT selection)."""
        return call.hap_dos[:, :, :nSNPs].double().cpu().numpy()

    def run_fb_and_select(H_b, which_b):
        """Full-panel FB per (chain, latent hap); returns the hap dosages, the
        re-selected subsets (QUILT1 heuristic path) and, in an HLA run, the
        captured gamma [B, nl, K] (else None)."""
        B = H_b.shape[0]
        with sec("fb:gl_build"):
            gls = np.ones((B * nl, 2, nSNPs), dtype=np.float32)
            for c in range(B):
                gls[c * nl:(c + 1) * nl] = gls_from_labels(
                    reads, H_b[c, : reads.nReads], nl, nSNPs, cfg.minGLValue)
        with sec("fb:kernel"):
            fb_inputs, thinned = ctx.fb_state()
            if ctx.sharded_fb is not None:
                res = ctx.sharded_fb(as_t(gls))
            else:
                res = fb_full_batched(as_t(gls), fb_inputs, K_top=max(8, cfg.K_top_matches),
                                      ref_error=prep.ref_error, **ctx.fb_plan_args)
            hap_dos = res[0][:, :nSNPs].reshape(B, nl, nSNPs).double().cpu().numpy()
            tv, ti = res[2].cpu().numpy(), res[3].cpu().numpy()
            gcap = res[4].reshape(B, nl, -1).double().cpu().numpy() if ctx.hla_capture else None
        with sec("fb:select"):
            new_sets = select_new_haps_host(tv, ti, thinned, which_b, rng, ctx.Ksub - ctx.Knew,
                                            ctx.Knew, K, nl, cfg.K_top_matches)
        return hap_dos, new_sets, gcap

    def select_mspbwt(hap_dos_rows, which_b):
        """msPBWT re-selection of each row (select_new_haps_mspbwt_v3,
        mspbwt.R:230-474), on the host."""
        with sec("select:mspbwt"):
            out = np.empty_like(which_b)
            for c in range(which_b.shape[0]):
                n_keep = ctx.Ksub - ctx.Knew
                prev_sel = rng.choice(which_b[c], size=n_keep, replace=False)
                new = select_new_haps_mspbwt(
                    prep.ms_indices, prep.panel, hap_dos_rows[c], ctx.Knew, K, prev_sel, rng,
                    mspbwtL=cfg.mspbwtL, mspbwtM=cfg.mspbwtM,
                    heuristic_approach=cfg.heuristic_approach,
                )
                out[c] = np.sort(np.concatenate([prev_sel, new]))
        return out

    # rare/common (QUILT2 impute_rare_common; reference: rare_common.R:109-470)
    rare_common = (cfg.impute_rare_common and reads_all is not None
                   and prep.snp_is_common is not None)
    if rare_common:
        reads_all = reads_all.sorted_by_grid()
        nSNPs_all = len(prep.snp_is_common)
        with sec("inputs_build"):
            side_all = _ChainReads(ctx, reads_all, ctx.trans_all, ctx.nGrids_all,
                                   whole_panel=False)
        dosage_all_acc = np.zeros(nSNPs_all)
        gp_all_acc = np.zeros((3, nSNPs_all))
        fet_dosage_all_acc = np.zeros(nSNPs_all)
        fet_gp_all_acc = np.zeros((3, nSNPs_all))
        n_all_acc = 0

    def run_all_snp_gibbs(which_b, hap_dos_common, max_diff):
        """Final all-SNP Gibbs call for a batch of chains (rare/common
        mode): labels from the common-SNP dosages, subset words from the
        region's all-SNP panel, no block moves. Returns the hap dosages
        [B, nl, nSNPs_all]."""
        B = which_b.shape[0]
        R_all = side_all.R
        with sec("rare:bits_build"):
            words = gather_words(ctx.tensors["rhb_all"], pad_subsets(which_b))
        H0 = np.zeros((B, R_all), dtype=np.int32)
        for c in range(B):
            H0[c, : reads_all.nReads] = initial_all_snp_labels(
                reads_all, hap_dos_common[c], prep.snp_is_common, nl, ff, rng)
        uniforms = as_t(rng.random((n_its, B, R_all)).astype(np.float32))
        H0_t, zero = as_t(H0), torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(11):
            with sec("rare:sweep_kernel"):
                lem, skip = side_all.lem(None, words, max_diff)
                call = gibbs(
                    side_all.layout(B), ctx.tensors["gibbs_trans_all"], lem, skip, uniforms,
                    H0_t, zero, False, which_b.shape[1], words=words,
                    ref_error=prep.ref_error, timed=sec, nl=nl, ff=ff,
                )
            if not bool(call.underflow.any()):
                break
            max_diff = max(1.0, max_diff / 10.0)
        return call.hap_dos[:, :, :nSNPs_all].double().cpu().numpy()

    # ------------------------------------------------------------------
    # main chains
    # ------------------------------------------------------------------
    first_read = rng.integers(0, max(reads.nReads, 1), size=C).astype(np.int32)
    for i_it in range(1, ctx.n_seek_its + 1):
        H, call, max_diff = run_chains(which_haps, H, i_it == 1, first_read, max_diff,
                                       dosages=use_ms or keep_seek_dosages)
        if keep_seek_dosages:
            # the chains' mean dosage after each seek iteration (reference:
            # heuristic.R:40-176, record_interim_dosages at functions.R:552)
            gp_g = call.gp[:, :, :nSNPs].double()
            diag["seek_dosages"].append((gp_g[:, 1] + 2 * gp_g[:, 2]).mean(0).cpu().numpy())
        if cfg.record_read_label_usage:
            # the chains' labels after each seek iteration (functions.R:564)
            diag["label_usage"].append(H[:, : reads.nReads].copy())
        if use_ms:
            hap_dos = ms_dosages(call)
            which_haps = select_mspbwt(hap_dos, which_haps)
        else:
            hap_dos, which_haps, gcap = run_fb_and_select(H, which_haps)
            if gcap is not None:
                hla_gammas = gcap
        if i_it > ctx.n_burn_in_seek_its:
            h1, h2 = hap_dos[:, 0], hap_dos[:, 1]
            dosage_acc += (h1 + h2).sum(axis=0)
            gp_acc[0] += ((1 - h1) * (1 - h2)).sum(axis=0)
            gp_acc[1] += (h1 * (1 - h2) + (1 - h1) * h2).sum(axis=0)
            gp_acc[2] += (h1 * h2).sum(axis=0)
            if nl == 3:
                h3 = hap_dos[:, 2]
                fet_dosage_acc += (h1 + h3).sum(axis=0)
                fet_gp_acc[0] += ((1 - h1) * (1 - h3)).sum(axis=0)
                fet_gp_acc[1] += (h1 * (1 - h3) + (1 - h1) * h3).sum(axis=0)
                fet_gp_acc[2] += (h1 * h3).sum(axis=0)
            n_acc += C
        hap_dos_final = hap_dos

    if rare_common:
        hd_a = run_all_snp_gibbs(which_haps, hap_dos_final, max_diff)
        h1a, h2a = hd_a[:, 0], hd_a[:, 1]
        dosage_all_acc += (h1a + h2a).sum(axis=0)
        gp_all_acc[0] += ((1 - h1a) * (1 - h2a)).sum(axis=0)
        gp_all_acc[1] += (h1a * (1 - h2a) + (1 - h1a) * h2a).sum(axis=0)
        gp_all_acc[2] += (h1a * h2a).sum(axis=0)
        if nl == 3:
            h3a = hd_a[:, 2]
            fet_dosage_all_acc += (h1a + h3a).sum(axis=0)
            fet_gp_all_acc[0] += ((1 - h1a) * (1 - h3a)).sum(axis=0)
            fet_gp_all_acc[1] += (h1a * (1 - h3a) + (1 - h1a) * h3a).sum(axis=0)
            fet_gp_all_acc[2] += (h1a * h3a).sum(axis=0)
        n_all_acc += C

    # ------------------------------------------------------------------
    # cross-chain consensus (diploid; NIPT folds 3->2 first, reference
    # functions.R:1788-1832)
    # ------------------------------------------------------------------
    with sec("consensus"):
        labels_all = H[:, : reads.nReads].T.astype(np.int64)    # [R, C]
        conf_all = np.zeros_like(labels_all, dtype=bool)
        for c in range(C):
            conf_all[:, c] = read_confidence(emat_read_vs_dosages(reads, hap_dos_final[c]))
        if nl == 3:
            labels2 = labels_all.copy()
            conf2 = conf_all & (labels_all != 2)
            labels2[labels_all == 2] = 1
            cons = consensus_read_labels(labels2, conf2)
            cons[labels_all[:, C - 1] == 2] = 2
        else:
            cons = consensus_read_labels(labels_all, conf_all)

    # ------------------------------------------------------------------
    # phasing pass (reference: i_gibbs_sample == nGibbsSamples+1), the
    # consensus chain replicated over the C rows
    # ------------------------------------------------------------------
    H_p = np.zeros((C, R), dtype=np.int32)
    H_p[:, : reads.nReads] = cons[None, :]
    wh_p = np.repeat(which_haps[C - 1:C], C, axis=0).copy()
    zero_first = np.zeros(C, dtype=np.int32)
    for _ in range(ctx.n_seek_its):
        H_p, call, max_diff = run_chains(wh_p, H_p, False, zero_first, max_diff)
        if use_ms:
            hap_dos_ph = ms_dosages(call)
            wh_p[:] = select_mspbwt(hap_dos_ph[:1], wh_p[:1])
        else:
            hap_dos_ph, wh_p, _ = run_fb_and_select(H_p, wh_p)
    hap_dos_ph = hap_dos_ph[:1]

    if rare_common:
        hap_dos_ph = run_all_snp_gibbs(wh_p[:1], hap_dos_ph[:1], max_diff)
        gp = gp_all_acc / max(n_all_acc, 1)
        dosage = dosage_all_acc / max(n_all_acc, 1)
        fet_gp = fet_gp_all_acc / max(n_all_acc, 1)
        fet_dosage = fet_dosage_all_acc / max(n_all_acc, 1)
        allele_count = sample_allele_count(reads_all, nSNPs_all)
    else:
        gp = gp_acc / max(n_acc, 1)
        dosage = dosage_acc / max(n_acc, 1)
        fet_gp = fet_gp_acc / max(n_acc, 1)
        fet_dosage = fet_dosage_acc / max(n_acc, 1)
        allele_count = sample_allele_count(reads, nSNPs)
    common = dict(
        imputed=True, dosage=dosage, gp=gp, read_labels=cons, allele_count=allele_count,
        per_it_likelihoods=diag.get("per_it"), H_class=diag.get("H_class"),
        seek_dosages=np.stack(diag["seek_dosages"]) if diag["seek_dosages"] else None,
        read_label_usage=np.stack(diag["label_usage"]) if diag["label_usage"] else None)
    if nl == 2:
        hd1, hd2 = recast_haps(hap_dos_ph[0, 0], hap_dos_ph[0, 1], gp)
        return SampleResult(
            phased_haps=np.stack([np.round(hd1), np.round(hd2)]),
            hla_gammas=hla_gammas,
            hla_gamma_total=None if hla_gammas is None else hla_gammas.sum(axis=(0, 1)),
            **common)
    return SampleResult(
        phased_haps=np.stack(recast_nipt_haps(*hap_dos_ph[0], gp, fet_gp)),
        mat_gp=gp, fet_gp=fet_gp, mat_dosage=dosage, fet_dosage=fet_dosage, **common)


def optimal_hap_dosages(ctx: RegionContext, reads: SampleReads, cfg: ImputeConfig,
                        truth_haps_sample: np.ndarray) -> np.ndarray:
    """Haploid dosages [2, nSNPs] when each read's haplotype is known from
    the truth [nSNPs, 2] (nan: unknown): the OHD FORMAT field of
    addOptimalHapsToVCF (reference: functions.R:280-281,1419). Each read
    goes to the truth haplotype that explains it best, and one full-panel
    FB call of the two rows gives the dosages."""
    prep = ctx.prep
    nSNPs = prep.nSNPs
    reads = reads.sorted_by_grid()
    truth = np.nan_to_num(truth_haps_sample.T.astype(np.float64), nan=0.5)
    H_opt = emat_read_vs_dosages(reads, truth).argmax(axis=0).astype(np.int32)
    gls = gls_from_labels(reads, H_opt, 2, nSNPs, cfg.minGLValue).astype(np.float32)
    fb_inputs, _ = ctx.fb_state()
    res = fb_full_batched(torch.as_tensor(gls, device=ctx.device), fb_inputs,
                          K_top=max(8, cfg.K_top_matches), ref_error=prep.ref_error,
                          **ctx.fb_plan_args)
    return res[0][:, :nSNPs].double().cpu().numpy()
