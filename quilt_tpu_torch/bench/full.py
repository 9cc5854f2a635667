"""The full benchmark table on one card: the port of the JAX side's
bench_full.py, with its ten sections and keys and the port's modules in
their place.

- fb_kernel: the FB at bench.fb's shape (K = 5,120 x 2,048 grids x 28 rows).
- sharded_fb_body: the panel-sharded FB (dist/mesh.py ShardedFB, the
  segment kernels of csrc/fb_sharded.cu) over make_mesh(1, 2, [cuda:0] x 2)
  at that shape; the two shards run in turn on the one card. "pergrid" is
  null: the port keeps one sharded body.
- fb_kernel_tiled: the FB at K = 40,960 and 98,304 x 512 grids x 16 rows
  (the K-split kernels of csrc/fb_tiled.cu where fb_plan takes them), with
  the plan beside each.
- end_to_end (and its stage_breakdown_s), end_to_end_quilt2, end_to_end_nipt
  (ff 0.2), end_to_end_ont (~6 kb reads at phred 10): quilt_impute at the
  quick-start shape (K = 5,120, 16,384 SNPs, Ksubset 600, 7 chains x 3 seek
  iterations x 21 sweeps, the samples in one batch at ~1x), timed after a
  warm-up call.
- hla_typing: the synthetic 40-allele world of bench_full.py, one sample
  through the per-sample engine with gamma capture and type_hla_sample.
- end_to_end_K100k / end_to_end_K100k_quilt2: 8 samples against a
  98,304-haplotype panel, QUILT1 and QUILT2 (the msPBWT build timed apart).
- gibbs_sweep: one sample's 21-sweep Gibbs call at 7 chains (bench.gibbs).

Each end-to-end section also records r2 against truth (maternal and fetal
for NIPT) and the peak device memory of its timed call. The samples of
every world are truth mosaics of that world's own panel. Numbers are the
card's, beside its name and power limit."""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ImputeConfig
from ..dist.mesh import ShardedFB, make_mesh
from ..engine.context import RegionContext
from ..engine.driver import _region_context, quilt_impute
from ..engine.sample import impute_one_sample
from ..hla import HLAGene, prepare_hla_reference, simulate_hla_db, type_hla_sample
from ..hla.db import BASES, alleles_at_positions
from ..hla.typing import GeneRead
from ..inputs import FBInputs, pad_to_multiple
from ..io import simulate_sample_reads
from ..kernels.fb import fb_plan
from ..kernels.fb_sharded import SEG_LEN
from ..out.metrics import r2_simple
from ..panel import PreparedReference, assign_positions_to_grid, compress_panel, prepare_panel
from ..panel.mspbwt import build_mspbwt_indices
from ..panel.prepare import trans_rates
from . import fb as bfb
from . import gibbs as bgibbs
from .common import (
    baseline, device_report, fast_packed_panel, packed_truth_mosaic, peak_device_bytes,
    require_cuda, timed,
)

N_SAMPLES = 32
K_PANEL, NSNPS, KSUBSET, K_BIG = 5120, 16384, 600, 98304
# the TOPMed r2 imputation panel's size: 97,256 samples, 194,512 haplotypes
# (Taliun et al., Nature 2021); chip_smoke.py's k200k world
K_HUGE = 194512
TILED_GRIDS, TILED_ROWS = 512, 16
NIPT_FF = 0.2
ONT_READ_BP, ONT_PHRED = 6000, 10
PERGRID_NOTE = ("the port keeps one sharded body, the segmented one; the JAX per-grid body is "
                "the XLA FB behind the QUILT_FB switch, which the port does not carry")


@dataclass(frozen=True)
class Sizes:
    """The report's shapes, bench_full.py's (SIZES). The end-to-end panel
    is the first K haplotypes and nSNPs SNPs of the FB world's panel."""
    fb_K: int = bfb.K
    fb_nSNPs: int = bfb.NSNPS
    fb_rows: int = bfb.ROWS
    K: int = K_PANEL
    nSNPs: int = NSNPS
    ksubset: int = KSUBSET
    tiled_Ks: Tuple[int, ...] = (40960, K_BIG)
    tiled_grids: int = TILED_GRIDS
    tiled_rows: int = TILED_ROWS
    K_big: int = K_BIG
    n_big: int = 8
    hla_alleles: int = 40
    hla_K: int = 200


SIZES = Sizes()


def e2e_config(n_samples: int, ksubset: int = KSUBSET, **kw) -> ImputeConfig:
    """bench_full.py's end-to-end config: 7 chains x 3 seek iterations x 21
    sweeps, Ksubset = Knew = 600, all n_samples in one batch."""
    return ImputeConfig(nGibbsSamples=7, n_seek_its=3, Ksubset=ksubset, Knew=ksubset,
                        small_ref_panel_gibbs_iterations=20, seed=1, sample_batch=n_samples,
                        override_default_params_for_small_ref_panel=False, make_plots=False, **kw)


def panel_af(rhb: np.ndarray, nSNPs: int, rows: int = 4096) -> np.ndarray:
    """Alt-allele frequency [nSNPs] of the packed panel [K, nSNPs/32]
    uint32, unpacked `rows` haplotypes at a time (bit b of word g is SNP
    32 g + b, utils.bits)."""
    total = np.zeros(nSNPs, dtype=np.int64)
    for k0 in range(0, rhb.shape[0], rows):
        words = np.ascontiguousarray(rhb[k0:k0 + rows], dtype="<u4")
        bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
        total += bits[:, :nSNPs].sum(axis=0, dtype=np.int64)
    return total / rhb.shape[0]


def reference_from_packed(rhb: np.ndarray, nSNPs: int) -> PreparedReference:
    """bench_full.py's prepared reference of a packed panel [K, nSNPs/32]:
    SNPs 60 bp apart (chr20, A/G), 1 cM/Mb, a 0.99 stay rate between grids,
    nMaxDH 255, no region buffer."""
    pos = np.arange(1, nSNPs + 1, dtype=np.int64) * 60
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    return PreparedReference(
        chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
        alt_allele=np.array(["G"] * nSNPs), rhb_t=rhb, af=panel_af(rhb, nSNPs), grid=grid,
        L_grid=np.asarray(L_grid), cM_grid=np.asarray(L_grid, dtype=np.float64) * 1e-6,
        sigma=np.full(nGrids - 1, 0.99), panel=compress_panel(rhb, nSNPs, nMaxDH=255),
        regionStart=None, regionEnd=None, buffer=0, nGen=100, ref_error=0.001)


def e2e_world(rng: np.random.Generator, n_samples: int, K: int = K_PANEL, nSNPs: int = NSNPS,
              rhb: Optional[np.ndarray] = None, prep: Optional[PreparedReference] = None,
              read_length_bp: int = 600, phred: int = 25, ff: Optional[float] = None) -> Dict:
    """A world of n_samples samples at ~1x against a packed panel (rhb, else
    a new fast_packed_panel of K haplotypes; prep, else its prepared
    reference): each sample's reads (read_length_bp at phred) from a truth
    mosaic of the panel's haplotypes, three of them at fetal fraction ff
    (NIPT) when ff is given. Returns {"prep", "samples", "truths", "ffs",
    "rhb"} (the world dict of chip_smoke.py's phases)."""
    if rhb is None:
        rhb = fast_packed_panel(rng, K, nSNPs // 32)
    if prep is None:
        prep = reference_from_packed(rhb, nSNPs)
    samples, truths = [], []
    for _ in range(n_samples):
        truth = packed_truth_mosaic(rng, rhb, prep.nSNPs, n_latent=2 if ff is None else 3)
        reads, _ = simulate_sample_reads(rng, truth, prep.pos, prep.grid, coverage=1.0,
                                         read_length_bp=read_length_bp, phred=phred,
                                         ff=0.0 if ff is None else ff)
        samples.append(reads)
        truths.append(truth)
    ffs = None if ff is None else np.full(n_samples, ff)
    return dict(prep=prep, samples=samples, truths=truths, ffs=ffs, rhb=rhb)


def run_impute(world: Dict, cfg: ImputeConfig, device):
    """quilt_impute of the world's samples (ImputeOutput)."""
    names = [f"S{i}" for i in range(len(world["samples"]))]
    return quilt_impute(world["prep"], world["samples"], names, cfg, device,
                        ff_values=world.get("ffs"))


def r2_report(world: Dict, out) -> Dict:
    """r2 of each sample's dosage against its truth (min and mean; NaN for
    a sample left unimputed); NIPT: of the mother (haplotypes 1 + 2) and of
    the fetus (1 + 3)."""
    def r2s(rows, field):
        return [float("nan") if getattr(r, field) is None else
                r2_simple(t[list(rows)].sum(0).astype(float), getattr(r, field))
                for t, r in zip(world["truths"], out.results)]

    def stats(name, v):
        return {f"{name}_min": float(np.min(v)), f"{name}_mean": float(np.mean(v))}

    if world.get("ffs") is None:
        return stats("r2", r2s((0, 1), "dosage"))
    return {**stats("r2_maternal", r2s((0, 1), "mat_dosage")),
            **stats("r2_fetal", r2s((0, 2), "fet_dosage"))}


def timed_impute(world: Dict, cfg: ImputeConfig, device):
    """(output, seconds, peak device bytes) of the timed call of the
    world's samples on the card, after a warm-up call (kernel builds and
    the region context, cached on the prepared reference)."""
    dev = require_cuda(device)
    run_impute(world, cfg, dev)
    (out, dt), peak = peak_device_bytes(lambda: timed(lambda: run_impute(world, cfg, dev), dev,
                                                      warmup=False), dev)
    return out, dt, peak


def fb_plan_of(prep: PreparedReference, cfg: ImputeConfig, device, rows: int) -> Dict:
    """The plan fb_plan takes for `rows` FB rows on the region's FB inputs."""
    family, per_call, splits = fb_plan(rows, _region_context(prep, cfg, device).fb_state()[0])
    return {"family": family, "rows_per_call": per_call, "splits": splits}


def _e2e_section(world: Dict, cfg: ImputeConfig, device, config: str, ref_key: Optional[str],
                 ref_name: str = "vs_measured_ref_core") -> Dict:
    out, dt, peak = timed_impute(world, cfg, device)
    N = len(world["samples"])
    sec = {"samples_per_s": N / dt, "seconds_for_N_samples": dt, "N": N,
           "K_panel": world["prep"].K, "config": config}
    if ref_key:
        sec[ref_name] = (N / dt) / baseline(ref_key)
    sec.update(r2_report(world, out), peak_device_bytes=peak)
    return sec


def end_to_end(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    """QUILT1 at the quick-start shape, then its per-stage wall times (the
    same call again with the section timers on, which drain the device at
    each stage boundary)."""
    cfg = e2e_config(len(world["samples"]), ksubset)
    sec = _e2e_section(world, cfg, device, "7 chains x 3 seek its x 21 sweeps, Ksubset=600",
                       "samples_per_s_core")
    n_reads = sum(r.nReads for r in world["samples"])
    dt = sec["seconds_for_N_samples"]
    sec.update(reads_per_s=n_reads / dt, snps_per_s=sec["N"] * world["prep"].nSNPs / dt,
               n_reads_total=n_reads, nSNPs=world["prep"].nSNPs,
               gibbs_backend=bgibbs.form_name(pad_to_multiple(ksubset, 128)))
    out = run_impute(world, dataclasses.replace(cfg, print_extra_timing_information=True),
                     device)
    sec["stage_breakdown_s"] = {k: round(v["seconds"], 3) for k, v in (out.timing or {}).items()}
    return sec


def end_to_end_quilt2(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    """QUILT2 (msPBWT selection) on the end-to-end world."""
    prep = world["prep"]
    prep.ms_indices = build_mspbwt_indices(prep.panel.hapMatcher)
    try:
        sec = _e2e_section(world, e2e_config(len(world["samples"]), ksubset, use_mspbwt=True),
                           device,
                           "QUILT2 path: mspbwt selection, same shapes", "samples_per_s_core")
    finally:
        prep.ms_indices = None
    del sec["K_panel"]          # as bench_full.py's section
    return sec


def end_to_end_nipt(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    sec = _e2e_section(world, e2e_config(len(world["samples"]), ksubset, method="nipt"), device,
                       "triploid mother+fetus, 7 chains x 3 seek its", "samples_per_s_core_nipt")
    sec["ff"] = float(world["ffs"][0])
    return sec


def end_to_end_ont(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    sec = _e2e_section(world, e2e_config(len(world["samples"]), ksubset), device,
                       "ONT-shaped: ~6kb reads at 10% error, 1x coverage", "samples_per_s_core_ont")
    sec["mean_snps_per_read"] = float(np.mean([np.diff(r.offsets).mean()
                                               for r in world["samples"]]))
    return sec


def end_to_end_K100k(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    """QUILT1 against the 98,304-haplotype panel, with the FB plan its
    batch takes (samples x 7 chains x 2 rows)."""
    N = len(world["samples"])
    cfg = e2e_config(N, ksubset)
    sec = _e2e_section(world, cfg, device, "QUILT1 path, K-split FB selection, same shapes",
                       "samples_per_s_core_K98304", "vs_measured_ref_core_same_K")
    sec["fb_plan"] = fb_plan_of(world["prep"], cfg, device, N * 7 * 2)
    return sec


def end_to_end_K100k_quilt2(world: Dict, device, ksubset: int = KSUBSET) -> Dict:
    """QUILT2 against the 98,304-haplotype panel; the msPBWT index build
    (host) timed apart, with the rank structure it chose."""
    prep = world["prep"]
    t0 = time.perf_counter()
    prep.ms_indices = build_mspbwt_indices(prep.panel.hapMatcher)
    build_s = time.perf_counter() - t0
    try:
        sec = _e2e_section(world, e2e_config(len(world["samples"]), ksubset, use_mspbwt=True),
                           device, "QUILT2 path: mspbwt selection, same shapes",
                           "samples_per_s_core_K98304", "vs_measured_ref_core_same_K")
        sec["mspbwt_rank"] = "planes" if prep.ms_indices[0].planes is not None else "occ"
    finally:
        prep.ms_indices = None
    sec["mspbwt_build_seconds"] = build_s
    return sec


def hla_world(rng: np.random.Generator, n_alleles: int = 40, K: int = 200,
              n_gene_reads: int = 200) -> Dict:
    """bench_full.py's synthetic IMGT-style world: a 6 kb gene with 400
    variant sites over n_alleles simulated alleles, a panel of K
    haplotypes each carrying one allele at the variant sites, one sample
    carrying alleles 1 and 3 (its reads over the panel SNPs at 2x, phred 28)
    and n_gene_reads 150 bp gene reads at 1% error."""
    gene = HLAGene("HLA-A", "chr6", 10_001, 16_000)
    db = simulate_hla_db(rng, gene, n_alleles=n_alleles, n_variant_sites=400)
    var_sites = np.flatnonzero((db.seqs != db.seqs[0][None, :]).any(axis=0))
    pos = gene.start + var_sites.astype(np.int64)
    ref = np.array([BASES[b] for b in db.seqs[0, var_sites]])
    alt = np.array([BASES[db.seqs[:, s][db.seqs[:, s] != db.seqs[0, s]][0]] for s in var_sites])
    hap_allele = rng.integers(0, db.n_alleles, K)
    states, _ = alleles_at_positions(db, pos, ref, alt)
    haps = (states[hap_allele] == 1).astype(np.uint8)
    prep = prepare_panel(chrom="chr6", pos=pos, ref_allele=ref, alt_allele=alt, haps=haps,
                         nMaxDH=64)
    hla_ref = prepare_hla_reference(db, prep, k=10)
    true_a = (1, 3)
    truth = np.stack([states[a] == 1 for a in true_a]).astype(np.uint8)
    reads, _ = simulate_sample_reads(rng, truth, prep.pos, prep.grid, coverage=2.0,
                                     read_length_bp=400, phred=28)
    L = 150
    gene_reads = []
    for r in range(n_gene_reads):
        start = int(rng.integers(0, gene.length - L))
        seq = db.seqs[true_a[r % 2], start:start + L].copy()
        err = rng.random(L) < 0.01
        gene_reads.append(GeneRead(pos0=gene.start - 1 + start,
                                   seq=np.where(err, (seq + 1) % 4, seq).astype(np.uint8),
                                   qual=np.full(L, 30)))
    cfg = ImputeConfig(nGibbsSamples=7, n_seek_its=2, Ksubset=K, Knew=K,
                       small_ref_panel_gibbs_iterations=20, hla_run=True,
                       gamma_physically_closest_to=(gene.start + gene.end) // 2,
                       override_default_params_for_small_ref_panel=False, seed=5)
    return dict(db=db, prep=prep, hla_ref=hla_ref, reads=reads, gene_reads=gene_reads, cfg=cfg,
                expected={db.allele_names[a] for a in true_a})


def run_hla(world: Dict, ctx: RegionContext, device):
    """One sample's gamma-capturing engine call and its HLA typing."""
    res = impute_one_sample(ctx, world["reads"], world["cfg"], seed=11)
    return type_hla_sample(world["hla_ref"], world["gene_reads"], gammas=res.hla_gamma_total,
                           device=device)


def hla_typing(world: Dict, device) -> Dict:
    dev = require_cuda(device)
    ctx = RegionContext.build(world["prep"], world["cfg"], dev)
    impute_one_sample(ctx, world["reads"], world["cfg"], seed=11)        # warm-up
    typed, dt = timed(lambda: run_hla(world, ctx, dev), dev, warmup=False)
    return {"seconds_per_sample": dt, "n_gene_reads": len(world["gene_reads"]),
            "n_alleles": world["db"].n_alleles, "K_panel": world["prep"].K,
            "call_correct": {typed.bestallele1, typed.bestallele2} == world["expected"],
            "config": ("synthetic IMGT-style world; full pipeline: gamma-capture QUILT run + "
                       "kmer filter + per-allele read likelihoods + combination")}


def tiled_world(rng: np.random.Generator, K: int, nGrids: int = TILED_GRIDS,
                rows: int = TILED_ROWS) -> Dict:
    """bench_full.py's large-panel FB input: a fast_packed_panel of K
    haplotypes over nGrids grids (every 10th thinned) and GLs [rows, 2, S]."""
    rhb = fast_packed_panel(rng, K, nGrids)
    fb = FBInputs.build(compress_panel(rhb, nGrids * 32, nMaxDH=255),
                        trans_rates(np.full(nGrids - 1, 0.99)),
                        thinned_grids=np.arange(0, nGrids, bfb.THIN_EVERY))
    gl = rng.uniform(0.05, 1.0, (rows, 2, fb.S)).astype(np.float32)
    return dict(fb=fb, gl=gl, K=K, nSNPs=fb.S, nGrids=nGrids, rows=rows)


def sharded_fb_body(world: Dict, device, n_panel: int = 2, reps: int = 3) -> Dict:
    """The panel-sharded FB over make_mesh(1, n_panel, [device] x n_panel)
    at the FB world's shape: its seconds a call and the exchanges a grid."""
    dev = require_cuda(device)
    sharded = ShardedFB(world["fb"], make_mesh(1, n_panel, [dev] * n_panel), K_top=bfb.K_TOP)
    gl = torch.as_tensor(world["gl"], device=dev)
    sharded(gl)                                                          # warm-up
    before = sharded.exchanges
    out, dt = timed(lambda: sharded(gl), dev, reps, warmup=False)
    bfb.check_dosage(out[0].cpu().numpy())
    cells = 2.0 * world["rows"] * world["K"] * world["fb"].nGrids
    return {"seg_len": SEG_LEN, "n_panel": n_panel, "collectives_per_grid_pergrid": None,
            "collectives_per_grid_segmented": (sharded.exchanges - before) / reps
            / world["fb"].nGrids,
            "pergrid": None, "note": PERGRID_NOTE,
            "segmented": {"cells_per_s": cells / dt, "seconds": dt}}


def gibbs_sweep(world: Dict, device, rng: np.random.Generator, chains: int = 7) -> Dict:
    """bench_full.py's Gibbs section: one sample's 21-sweep call at 7
    chains on a bench.gibbs world."""
    require_cuda(device)
    dt = bgibbs.time_call(world, chains, bgibbs.N_ITS, rng, device)
    nReads = world["reads"].nReads
    rps = bgibbs.N_ITS * chains * nReads / dt
    return {"seconds_per_21_sweep_call": dt, "read_resamples_per_s": rps, "nReads": nReads,
            "chains": chains, "Ksubset": world["Ksub"], "nGrids": world["nGrids"],
            "max_reads_per_grid": int(world["ginputs"].read_count.max()),
            "backend": bgibbs.form_name(world["Kp"]),
            "vs_measured_ref_core": rps / baseline("gibbs_resamples_per_s_core")}


def _free(device) -> None:
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def full_report(device="cuda", n_samples: int = N_SAMPLES) -> Dict:
    """Every section at SIZES, in bench_full.py's order, beside the card;
    each world is built just before its sections and dropped after them."""
    dev = require_cuda(device)
    rng = np.random.default_rng(0)
    z = SIZES
    results: Dict = dict(device_report(dev), backend="cuda", n_samples=n_samples)
    seconds: Dict[str, float] = {}

    def section(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"{name}: {seconds[name]:.1f} s", flush=True)
        return out

    fb_w = bfb.fb_world(rng, z.fb_K, z.fb_nSNPs, z.fb_rows)
    results["fb_kernel"] = section("fb_kernel", lambda: bfb.time_fb(fb_w, dev))
    results["sharded_fb_body"] = section("sharded_fb_body", lambda: sharded_fb_body(fb_w, dev))
    results["fb_kernel_tiled"] = {}
    for K in z.tiled_Ks:
        tw = tiled_world(rng, K, z.tiled_grids, z.tiled_rows)
        results["fb_kernel_tiled"][f"K{K}"] = section(f"fb_kernel_tiled K{K}",
                                                      lambda: bfb.time_fb(tw, dev, reps=3))
        del tw
    rhb = fb_w["rhb"][:z.K, :z.nSNPs // 32].copy()
    del fb_w
    world = e2e_world(rng, n_samples, nSNPs=z.nSNPs, rhb=rhb)
    nipt = e2e_world(rng, n_samples, rhb=rhb, prep=world["prep"], ff=NIPT_FF)
    ont = e2e_world(rng, n_samples, rhb=rhb, prep=world["prep"], read_length_bp=ONT_READ_BP,
                    phred=ONT_PHRED)
    for name, fn, w in (("end_to_end", end_to_end, world),
                        ("end_to_end_quilt2", end_to_end_quilt2, world),
                        ("end_to_end_nipt", end_to_end_nipt, nipt),
                        ("end_to_end_ont", end_to_end_ont, ont)):
        results[name] = section(name, lambda: fn(w, dev, z.ksubset))
    del world, nipt, ont
    _free(dev)
    hw = hla_world(rng, z.hla_alleles, z.hla_K)
    results["hla_typing"] = section("hla_typing", lambda: hla_typing(hw, dev))
    big = e2e_world(rng, min(z.n_big, n_samples), K=z.K_big, nSNPs=z.nSNPs)
    for name, fn in (("end_to_end_K100k", end_to_end_K100k),
                     ("end_to_end_K100k_quilt2", end_to_end_K100k_quilt2)):
        results[name] = section(name, lambda: fn(big, dev, z.ksubset))
    del big
    _free(dev)
    gw = bgibbs.gibbs_world(rng, dev, z.K, z.nSNPs, z.ksubset)
    results["gibbs_sweep"] = section("gibbs_sweep", lambda: gibbs_sweep(gw, dev, rng))
    results["section_seconds"] = seconds
    return results
