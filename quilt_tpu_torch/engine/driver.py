"""Multi-sample imputation driver of the port: the dispatch of
quilt_tpu/engine/driver.py:quilt_impute (:44-484) between the batched engine
(engine/batch.py) and the per-sample one (engine/sample.py: lone samples,
HLA runs and runs with per-sample diagnostics), with the rare/common read
split and all-SNP output axis of :94-114, the multi-host sample shards of
:126-142 (each process of a torch.distributed group imputes its contiguous
shard, batching within it; the accumulators are summed and the columns
gathered across processes, :344-362, and process 0 writes the VCF), the
INFO / allele frequency / HWE aggregation after it, the VCF write through
out.vcf_writer (with the OHD field of addOptimalHapsToVCF), and the
diagnostic outputs: the per-sample plots and their data files (out.plots),
the hap-selection strategy comparison and the npz dump of per-sample
objects."""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ImputeConfig
from ..io.reads import SampleReads
from ..out.metrics import calculate_pse, r2_simple
from ..out.plots import (
    plot_block_gibbs, plot_hclass, plot_heuristic_comparison, plot_read_label_flips,
    plot_sample_diagnostics,
)
from ..out.vcf_writer import (
    MISSING_DIPLOID_COL, MISSING_NIPT_COL, diploid_sample_column, hwe_from_counts,
    info_score, nipt_sample_column, write_quilt_vcf,
)
from ..panel.prepare import PreparedReference
from ..utils import print_message, set_verbosity
from ..utils.log import SectionTimers

from ..dist.hosts import (
    allgather_columns, process_info, reduce_sum_across_hosts, sample_shards,
)
from ..dist.mesh import as_device, default_devices
from ..inputs import pad_to_multiple
from ..kernels.gibbs_sweep import fwd_scratch_floats
from ..kernels.nipt_bank import bank_scratch_floats
from .batch import SampleResult, impute_samples_batched
from .context import (
    RegionContext, context_fields, validate_impute_config,
    validate_region_consistency,
)
from .rare_common import restrict_reads_to_common
from .sample import (
    impute_one_sample, needs_per_sample_diagnostics, optimal_hap_dosages, wants_dump,
)

# the per-sample objects the npz dump can hold (quilt_tpu/engine/driver.py:453-456)
_EXPORTABLE = (
    "read_labels", "per_it_likelihoods", "H_class", "dosage", "gp",
    "phased_haps", "seek_dosages", "read_label_usage", "hla_gammas",
)
# fraction of the card's free memory one Gibbs chain batch may take, and the
# budget used when the device is the CPU (the JAX package's 10 GiB)
_GIBBS_MEM_FRACTION = 0.5
_CPU_GIBBS_BYTES = 10 << 30


@dataclass
class ImputeOutput:
    results: List[Optional[SampleResult]]
    vcf_path: Optional[str]
    eaf: np.ndarray
    info: np.ndarray
    r2_per_sample: Optional[List[float]] = None
    timing: Optional[Dict] = None


def max_chains(K_pad: int, W: int, G: int, device: torch.device, nl: int = 2) -> int:
    """Largest Gibbs chain batch whose working set fits: per chain, the
    lemg/beta/alpha [G, nl, K_pad] planes (twice: inputs and outputs of a
    sweep), the [G, W, K_pad] float32 slot emissions (and the gather that
    builds them), the [K_pad, R ~ 4G] read emissions, and the scratch planes
    of the kernels' global forms where K_pad takes them (the forward sweep's
    alpha; at nl = 3 the block move's bank)."""
    scratch = fwd_scratch_floats(K_pad, nl) + (bank_scratch_floats(K_pad, G) if nl == 3 else 0)
    per_row = 4 * (2 * 3 * nl * G * K_pad + 2 * G * max(W, 1) * K_pad + 4 * G * K_pad + scratch)
    if device.type == "cuda":
        budget = int(torch.cuda.mem_get_info(device)[0] * _GIBBS_MEM_FRACTION)
    else:
        budget = _CPU_GIBBS_BYTES
    return max(budget // per_row, 1)


def _region_context(prep: PreparedReference, cfg: ImputeConfig, device,
                    devices=None, timers: Optional[SectionTimers] = None) -> RegionContext:
    """The region's context, cached on `prep`: reused while the devices and
    every config field that building it read keep their values. It takes
    `timers` (default: new ones, as the configuration asks)."""
    if timers is None:
        timers = SectionTimers(cfg.print_extra_timing_information, device)
    cached = getattr(prep, "_torch_ctx_cache", None)
    want = tuple(as_device(d) for d in (default_devices(device) if devices is None else devices))
    if cached is not None:
        fields, key, ctx = cached
        if (ctx.device == torch.device(device) and ctx.devices == want
                and key == _key(cfg, fields)):
            ctx.timers = timers
            return ctx
    ctx, fields = context_fields(prep, cfg, device, want, timers)
    prep._torch_ctx_cache = (fields, _key(cfg, fields), ctx)
    return ctx


def _key(cfg: ImputeConfig, fields) -> tuple:
    return tuple((f, repr(getattr(cfg, f))) for f in sorted(fields))


def quilt_impute(prep: PreparedReference, samples: Sequence[SampleReads],
                 sample_names: Sequence[str], cfg: ImputeConfig, device,
                 output_filename: Optional[str] = None,
                 ff_values: Optional[np.ndarray] = None,
                 truth_gen: Optional[np.ndarray] = None,
                 truth_haps: Optional[np.ndarray] = None,
                 region_name: str = "region", devices=None) -> ImputeOutput:
    """Imputation of `samples` on `device` (a torch device: "cuda" on the
    GPU, "cpu" for the tests), diploid or NIPT (cfg.method; ff_values [N]
    the samples' fetal fractions): QUILT1, or QUILT2 with use_mspbwt
    and / or impute_rare_common. Under rare/common the samples hold
    all-SNP reads and every output (VCF sites, dosages, truth_gen) is on
    the all-SNP axis. truth_gen [nSNPs, N] and truth_haps [nSNPs, N, 2]
    give per-sample r2 / PSE reports (NIPT: of the mother); with
    addOptimalHapsToVCF, truth_haps also gives the OHD field of diploid
    runs. The diagnostic options write under cfg.outputdir, in files named
    after region_name. cfg.mesh_data x cfg.mesh_panel > 1 runs on a mesh of
    `devices` (default: the visible cards from `device` on; a device may
    repeat). In a torch.distributed group (dist.hosts.init_multihost) this
    process imputes its shard of the samples (the others' entries of
    `samples` may be None), the results of the others' samples are None,
    and only process 0 writes the VCF."""
    t0 = time.time()
    timers = SectionTimers(cfg.print_extra_timing_information, device)
    with timers.section("impute", root=True):
        set_verbosity(cfg.verbose)
        validate_impute_config(cfg)
        validate_region_consistency(prep, cfg)
        device = torch.device(device)
        ctx = _region_context(prep, cfg, device, devices, timers)
        N = len(samples)
        rank, nproc = process_info()
        local = [int(i) for i in sample_shards(N, nproc)[rank]] if nproc > 1 else list(range(N))
        if nproc > 1:
            print_message(f"Multi-host: process {rank}/{nproc} imputes {len(local)}/{N} samples")
        nipt = cfg.method == "nipt"
        ff_values = np.zeros(N) if ff_values is None else np.asarray(ff_values, dtype=float)
        if len(ff_values) != N:
            raise ValueError(f"{len(ff_values)} fetal fractions for {N} samples")
        rare_common = cfg.impute_rare_common and prep.snp_is_common is not None
        samples_all = None
        if rare_common:
            # the seek loop runs on common SNPs (reference: quilt.R:664-684,
            # functions.R:130-174)
            ctx.timers.count("rare.sites", ctx.rare_sites)
            ctx.timers.count("rare.carriers", ctx.rare_carriers)
            samples_all = list(samples)
            samples = [None if r is None else
                       restrict_reads_to_common(r, prep.snp_is_common, prep.grid)
                       for r in samples_all]
            nSNPs = len(prep.snp_is_common)
            out_pos, out_ref, out_alt = prep.pos_all, prep.ref_allele_all, prep.alt_allele_all
            in_region = prep.in_region_all()
        else:
            nSNPs = prep.nSNPs
            out_pos, out_ref, out_alt = prep.pos, prep.ref_allele, prep.alt_allele
            in_region = prep.in_region()

        results: List[Optional[SampleResult]] = [None] * N
        # the batched engine takes several samples at a time; a lone sample, the
        # samples of an HLA run and a run with per-sample diagnostics go through
        # the per-sample engine (quilt_tpu/engine/driver.py:146-158)
        if (cfg.sample_batch > 1 and N > 1 and not cfg.hla_run
                and not needs_per_sample_diagnostics(cfg)):
            with ctx.timers.section("driver.plan"):
                # sample batches, clamped so one Gibbs call's working set fits the device
                W_max = 1
                for r in samples:
                    if r is not None and r.nReads:
                        W_max = max(W_max, int(np.bincount(np.clip(r.wif0, 0, prep.nGrids - 1),
                                                           minlength=prep.nGrids).max()))
                cap = max_chains(pad_to_multiple(max(ctx.Ksub, 1), 128), W_max, prep.nGrids,
                                 device, ctx.n_latent)
                sample_batch = max(1, min(cfg.sample_batch, cap // max(cfg.nGibbsSamples, 1)))
                if sample_batch < cfg.sample_batch:
                    print_message(f"Clamping sample_batch {cfg.sample_batch} -> {sample_batch} "
                                  f"(Gibbs working set at Ksubset={cfg.Ksubset})")
                # a NIPT batch shares one fetal fraction (the label prior and the class
                # tables of a Gibbs call are made from it): batches form within the
                # samples of equal ff
                by_ff: Dict[float, List[int]] = {}
                for i in local:
                    by_ff.setdefault(float(ff_values[i]) if nipt else 0.0, []).append(i)
                groups = [v[j:j + sample_batch] for v in by_ff.values()
                          for j in range(0, len(v), sample_batch)]
            for group in groups:
                if len(group) == 1 and rare_common:
                    continue   # no batching win: the per-sample engine below
                print_message(f"Imputing samples {group[0] + 1}-{group[-1] + 1}/{N} (batched)")
                for i, res in zip(group, impute_samples_batched(
                        ctx, [samples[i] for i in group], cfg, seed=cfg.seed + group[0],
                        ff=float(ff_values[group[0]]) if nipt else 0.0,
                        reads_all_list=[samples_all[i] for i in group] if rare_common else None)):
                    results[i] = res
        for i in local:
            if results[i] is None:
                print_message(f"Imputing sample {i + 1}/{N}: {sample_names[i]}")
                results[i] = impute_one_sample(
                    ctx, samples[i], cfg, seed=cfg.seed + i, ff=float(ff_values[i]),
                    reads_all=samples_all[i] if rare_common else None)

        with ctx.timers.section("driver.stats"):
            eij_sum = np.zeros(nSNPs)
            var_sum = np.zeros(nSNPs)
            af_sum = np.zeros(nSNPs)
            hwe_counts = np.zeros((nSNPs, 3), dtype=np.int64)
            allele_count = np.zeros((nSNPs, 2))
            columns: List[Optional[List[str]]] = []
            r2s: List[float] = []
            n_imputed = 0
            with_ohd = cfg.addOptimalHapsToVCF and truth_haps is not None
            af_out = prep.af_all if rare_common else prep.af
            for i, res in enumerate(results):
                if res is None:
                    columns.append(None)    # another process's sample
                    continue
                if not res.imputed:
                    print_message(f"Sample {sample_names[i]} has fewer than "
                                  f"{cfg.minimum_number_of_sample_reads} reads; output missing")
                    miss = MISSING_NIPT_COL if nipt else MISSING_DIPLOID_COL
                    if with_ohd and not nipt:
                        miss += ":.,."
                    columns.append([miss] * nSNPs)
                    continue
                n_imputed += 1
                gp = res.mat_gp if nipt else res.gp
                eij = np.round(gp[1] + 2 * gp[2], 3)
                fij = np.round(gp[1] + 4 * gp[2], 3)
                eij_sum += eij
                var_sum += fij - eij ** 2
                af_sum += eij / 2
                hwe_counts[np.arange(nSNPs), gp.argmax(axis=0)] += 1
                allele_count += res.allele_count
                ohd = None
                if with_ohd and not nipt and not rare_common:
                    # optimal haploid dosages given the truth's read labels
                    # (reference: functions.R:280-281,1419)
                    with ctx.timers.section("ohd"):
                        ohd = optimal_hap_dosages(ctx, samples[i], cfg, truth_haps[:, i])
                with ctx.timers.section("vcf:columns"):
                    if nipt:
                        columns.append(nipt_sample_column(
                            res.mat_gp, res.fet_gp, res.mat_dosage, res.fet_dosage,
                            res.phased_haps))
                    else:
                        columns.append(diploid_sample_column(
                            res.gp, res.phased_haps, res.dosage,
                            output_gt_phased_genotypes=cfg.output_gt_phased_genotypes, ohd=ohd,
                        ))
                if (cfg.make_plots or cfg.plot_per_sample_likelihoods) and cfg.outputdir:
                    _plot_sample(ctx, cfg, sample_names[i], region_name, res, gp, out_pos, af_out,
                                 None if truth_gen is None else truth_gen[:, i], samples[i])
                if truth_gen is not None:
                    r2 = r2_simple(truth_gen[:, i], res.dosage)
                    r2s.append(r2)
                    msg = f"  r2 vs truth: {r2:.4f}"
                    # common / rare split by panel MAF, as the JAX driver prints it
                    af = prep.af_all if rare_common else prep.af
                    com = np.minimum(af, 1 - af) >= 0.05
                    if com.any() and (~com).any():
                        msg += (f" (common {r2_simple(truth_gen[com, i], res.dosage[com]):.4f}, "
                                f"rare {r2_simple(truth_gen[~com, i], res.dosage[~com]):.4f})")
                    if truth_haps is not None:
                        pse = calculate_pse(res.phased_haps[:2].T, truth_haps[:, i])
                        msg += f", PSE: {pse['pse']:.4f} ({pse.get('phase_sites', 0)} het sites)"
                    print_message(msg)

            if nproc > 1:
                # the accumulators summed and the columns gathered across processes,
                # so the merged VCF is the one process's
                red = reduce_sum_across_hosts({
                    "eij_sum": eij_sum, "var_sum": var_sum, "af_sum": af_sum,
                    "hwe_counts": hwe_counts, "allele_count": allele_count,
                    "n_imputed": np.array(n_imputed, dtype=np.int64),
                })
                eij_sum, var_sum, af_sum = red["eij_sum"], red["var_sum"], red["af_sum"]
                hwe_counts, allele_count = red["hwe_counts"], red["allele_count"]
                n_imputed = int(red["n_imputed"])
                columns = allgather_columns({i: columns[i] for i in local}, N)
                if rank != 0:
                    output_filename = None      # process 0 writes the merged VCF
            denom = max(n_imputed, 1)
            eaf = af_sum / denom
            info = info_score(eij_sum, var_sum, denom)
        if output_filename:
            with ctx.timers.section("vcf:write"):
                with ctx.timers.section("vcf.hwe"):
                    hwe = hwe_from_counts(hwe_counts)
                write_quilt_vcf(
                    output_filename, chrom=prep.chrom, pos=out_pos,
                    ref_allele=out_ref, alt_allele=out_alt,
                    sample_names=sample_names, sample_columns=columns, eaf=eaf,
                    info=info, hwe=hwe, allele_count=allele_count, in_region=in_region,
                    method=cfg.method,
                    output_gt_phased_genotypes=cfg.output_gt_phased_genotypes,
                    with_ohd=with_ohd, timed=ctx.timers.section,
                )
            print_message(f"Wrote {output_filename}")
        if (cfg.make_heuristic_plot and truth_gen is not None and cfg.outputdir
                and not rare_common):
            _heuristic_comparison(ctx, cfg, results, samples, sample_names, region_name,
                                  truth_gen, ff_values)
        if wants_dump(cfg) and (cfg.outputdir or cfg.output_RData_filename):
            _dump_objects(cfg, results, sample_names, region_name)
    timers.report()
    timing = timers.as_dict() if timers.enabled else None
    print_message(f"Done QUILT ({time.time() - t0:.1f}s)")
    return ImputeOutput(
        results=results, vcf_path=output_filename, eaf=eaf, info=info,
        r2_per_sample=r2s if truth_gen is not None else None, timing=timing,
    )


def _plot_sample(ctx: RegionContext, cfg: ImputeConfig, name: str, region_name: str,
                 res: SampleResult, gp, pos, af, truth, reads: SampleReads) -> None:
    """The per-sample plots of make_plots / plot_per_sample_likelihoods
    (quilt_tpu/engine/driver.py:286-323): the dosage panel with the
    per-iteration likelihood traces, the read-label flips and NIPT read
    classes when recorded, and the block-Gibbs boundaries."""
    plot_sample_diagnostics(cfg.outputdir, name, region_name, pos=pos, dosage=res.dosage,
                            gp=gp, af=af, truth_gen=truth,
                            per_it_likelihoods=res.per_it_likelihoods)
    if res.read_label_usage is not None:
        plot_read_label_flips(cfg.outputdir, name, region_name, res.read_label_usage)
    if res.H_class is not None:
        plot_hclass(cfg.outputdir, name, region_name, res.H_class)
    if ctx.boundaries is not None and len(ctx.boundaries):
        plot_block_gibbs(cfg.outputdir, name, region_name, L_grid=ctx.prep.L_grid,
                         smooth_rate=ctx.smooth_cm, boundaries=ctx.boundaries,
                         read_label_usage=res.read_label_usage,
                         read_grids=None if reads is None else reads.wif0)


def _heuristic_comparison(ctx: RegionContext, cfg: ImputeConfig, results, samples,
                          sample_names, region_name, truth_gen, ff_values) -> None:
    """make_heuristic_plot (quilt_tpu/engine/driver.py:390-440; reference:
    heuristic.R:40-176): each sample's dosage r2 against truth after each
    seek iteration, under this run's hap selection and, rerun on the same
    context, under the others the prepared reference allows (QUILT1 top-K,
    msPBWT with either match-finding approach)."""
    can_mspbwt = ctx.prep.ms_indices is not None
    cur = f"mspbwt {cfg.heuristic_approach}" if cfg.use_mspbwt else "QUILT1 top-K"
    variants = {}
    if cfg.use_mspbwt:
        variants["QUILT1 top-K"] = replace(cfg, use_mspbwt=False, make_plots=False)
    elif can_mspbwt:
        variants[f"mspbwt {cfg.heuristic_approach}"] = replace(
            cfg, use_mspbwt=True, make_plots=False)
    if can_mspbwt:
        other = "B" if cfg.heuristic_approach == "A" else "A"
        variants[f"mspbwt {other}"] = replace(
            cfg, use_mspbwt=True, heuristic_approach=other, make_plots=False)
    for i, res in enumerate(results):
        if res is None or not res.imputed or res.seek_dosages is None:
            continue
        traces = {cur: [r2_simple(truth_gen[:, i], d) for d in res.seek_dosages]}
        if not cfg.use_mspbwt:
            # the reference's zilong A and B rows are the current non-msPBWT
            # selection captured at two points (functions.R:752-778)
            traces["zilong A (= current)"] = traces[cur]
            traces["zilong B (= current)"] = traces[cur]
        for label, vcfg in variants.items():
            alt = impute_one_sample(ctx, samples[i], vcfg, seed=cfg.seed + i,
                                    ff=float(ff_values[i]))
            if alt.imputed and alt.seek_dosages is not None:
                traces[label] = [r2_simple(truth_gen[:, i], d) for d in alt.seek_dosages]
        plot_heuristic_comparison(cfg.outputdir, sample_names[i], region_name, traces)


def _dump_objects(cfg: ImputeConfig, results, sample_names, region_name) -> None:
    """The npz counterpart of the reference's output_RData_filename /
    RData_objects_to_save dump (quilt.R:1029-1068;
    quilt_tpu/engine/driver.py:442-484): every requested per-sample object
    under <object>_<sample>."""
    wanted = _EXPORTABLE
    if cfg.RData_objects_to_save:
        unknown = [o for o in cfg.RData_objects_to_save if o not in _EXPORTABLE]
        if unknown:
            print_message(f"Warning: unknown RData_objects_to_save {unknown}; "
                          f"exportable: {list(_EXPORTABLE)}")
        wanted = [o for o in cfg.RData_objects_to_save if o in _EXPORTABLE]
    dump = {}
    for name, res in zip(sample_names, results):
        if res is None or not res.imputed:
            continue
        for obj in wanted:
            val = getattr(res, obj, None)
            if val is not None:
                dump[f"{obj}_{name}"] = val
    out_npz = cfg.output_RData_filename
    if not out_npz:
        os.makedirs(os.path.join(cfg.outputdir, "RData"), exist_ok=True)
        out_npz = os.path.join(cfg.outputdir, "RData", f"quilt.output.{region_name}.npz")
    np.savez_compressed(out_npz, **dump)
    print_message(f"Wrote output objects to {out_npz}")
