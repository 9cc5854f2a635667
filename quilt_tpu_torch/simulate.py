"""Synthetic worlds for the port's smoke run and tests, made from a seed
with the port's simulators (io.simulate) and reference preparation
(panel.prepare)."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .io import simulate_panel, simulate_sample_reads
from .io.bam_writer import BamWriter, write_panel_vcf
from .io.simulate import simulate_truth_mosaic
from .panel import prepare_panel


def make_world(rng: np.random.Generator, K: int, nSNPs: int, n_samples: int,
               coverage: float = 1.0, read_length_bp: int = 600, rare_frac: float = 0.0,
               quilt2: bool = False, ffs=None) -> Dict:
    """A prepared panel of K haplotypes over nSNPs SNPs spaced ~60 bp, and
    n_samples samples' reads (phred 25) from truth mosaics of the panel.
    rare_frac of the sites are rewritten to 1-4 carriers (rare_sites).
    quilt2 prepares the panel as `prepare2` does (rare/common split at the
    default rare_af_threshold, msPBWT indices) and simulates the reads on
    the all-SNP axis. ffs [n_samples] makes NIPT samples: three truth
    haplotypes (mother's transmitted and untransmitted, the fetus's
    paternal) and reads drawn from them at the sample's fetal fraction.
    Returns {"prep", "samples", "truths" ([2 or 3, nSNPs] each, all SNPs)}."""
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=nSNPs * 60)
    if rare_frac:
        rare_sites(rng, haps, int(round(rare_frac * nSNPs)), max_carriers=4)
    quilt2_opts = dict(impute_rare_common=True, use_mspbwt=True, mspbwt_nindices=4)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps,
                         **(quilt2_opts if quilt2 else {}))
    grid = prep.grid_all if quilt2 else prep.grid
    samples, truths = [], []
    for i in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2 if ffs is None else 3)
        reads, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=coverage,
                                         read_length_bp=read_length_bp, phred=25,
                                         ff=0.0 if ffs is None else float(ffs[i]))
        samples.append(reads)
        truths.append(truth)
    return dict(prep=prep, samples=samples, truths=truths)


def rare_sites(rng: np.random.Generator, haps: np.ndarray, n_sites: int,
               max_carriers: int = 1) -> np.ndarray:
    """Rewrite n_sites random sites of the panel haps [K, nSNPs] in place
    to 1..max_carriers carrier haplotypes each (as
    tests/test_engine_batched.py makes rare sites). Returns the sites."""
    K, nSNPs = haps.shape
    sites = rng.choice(nSNPs, n_sites, replace=False)
    for s in sites:
        haps[:, s] = 0
        haps[rng.choice(K, int(rng.integers(1, max_carriers + 1)), replace=False), s] = 1
    return sites


def write_bam_world(out_dir: str, rng: np.random.Generator, K: int = 80,
                    nSNPs: int = 384, n_samples: int = 2, n_rare: int = 0, ff=None,
                    coverage: float = 2.0):
    """A panel VCF, a genetic map and one BAM per sample (300 bp reads at
    ~coverage from truth mosaics of the panel) under out_dir; n_rare sites
    carry a single carrier haplotype (rare at `prepare2 --rare_af_threshold
    0.03` for K = 80). With a fetal fraction ff the samples are NIPT ones:
    three truth haplotypes, reads from them with probabilities (0.5,
    (1-ff)/2, ff/2). Returns (vcf path, map path, bamlist path, truths
    [n_samples] of [2 or 3, nSNPs], nSNPs)."""
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=200_000)
    if n_rare:
        rare_sites(rng, haps, n_rare)
    vcf = os.path.join(out_dir, "panel.vcf.gz")
    write_panel_vcf(vcf, "chr20", pos, np.array(["A"] * nSNPs), np.array(["G"] * nSNPs), haps)
    gmap = os.path.join(out_dir, "map.txt")
    with open(gmap, "w") as fh:
        fh.write("position COMBINED_rate.cM.Mb. Genetic_Map.cM.\n"
                 f"{pos[0]} 1.0 0.0\n{pos[-1]} 1.0 {(pos[-1] - pos[0]) / 1e6:.6f}\n")
    truths, bams = [], []
    for i in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2 if ff is None else 3)
        truths.append(truth)
        bam = os.path.join(out_dir, f"s{i}.bam")
        with BamWriter(bam, "chr20", int(pos[-1]) + 1000, sample_name=f"SAMP{i}") as w:
            for r in range(int(coverage * (pos[-1] - pos[0]) / 300)):
                start0 = int(rng.integers(pos[0] - 100, pos[-1]))
                h = (int(rng.integers(0, 2)) if ff is None
                     else int(rng.choice(3, p=[0.5, (1 - ff) / 2, ff / 2])))
                seq = []
                for off in range(300):
                    si = np.searchsorted(pos, start0 + 1 + off)
                    if si < nSNPs and pos[si] == start0 + 1 + off:
                        a = truth[h, si] ^ int(rng.random() < 0.003)
                        seq.append("G" if a else "A")
                    else:
                        seq.append("C")
                w.write_read(f"r{r}", start0, "".join(seq), [25] * 300)
        bams.append(bam)
    bamlist = os.path.join(out_dir, "bamlist.txt")
    with open(bamlist, "w") as fh:
        fh.write("\n".join(bams) + "\n")
    return vcf, gmap, bamlist, truths, nSNPs


def random_sweep_state(rng: np.random.Generator, G: int, B: int, W: int, K: int,
                       K_real: int, max_reads: int, p_skip: float = 0.05, counts=None,
                       nl: int = 2):
    """A random Gibbs sweep state of nl latent rows a chain in the sweep kernels' layouts
    (numpy arrays, in the argument order of kernels.gibbs_sweep.fwd_sweep):
    up to max_reads reads per (grid, chain) in W slots, log emissions in
    [-6, 0] with the pad haplotypes (>= K_real) copying haplotype 0, a share
    p_skip of the reads uninformative, lemg consistent with the random labels, and
    first_read uniform over each chain's reads. counts [G, B], when given,
    sets the reads per (grid, chain) instead of the uniform draw."""
    BN = nl * B
    if counts is None:
        counts = rng.integers(0, max_reads + 1, size=(G, B))
    counts = np.minimum(np.asarray(counts, dtype=np.int64), W)
    valid = np.arange(W)[None, :, None] < counts[:, None, :]
    lem_pad = rng.uniform(-6.0, 0.0, size=(G, W, B, K)).astype(np.float32)
    lem_pad[..., K_real:] = lem_pad[..., :1]
    lem_pad = np.where(valid[..., None], lem_pad, np.float32(0.0))
    labels = rng.integers(0, nl, size=(G, W, B)).astype(np.int32)
    starts = np.cumsum(counts, axis=0) - counts
    r_pad = np.where(valid, starts[:, None, :] + np.arange(W)[None, :, None], -1)
    skip = (~valid | (rng.random((G, W, B)) < p_skip)).astype(np.int32)
    u = rng.random((G, W, B)).astype(np.float32)
    slots = np.stack([u.view(np.int32), labels, skip, r_pad.astype(np.int32)], axis=1)
    oh = (np.stack([labels == h for h in range(nl)], -1) & valid[..., None]).astype(np.float32)
    lemg = np.einsum("gwbn,gwbk->gnbk", oh, lem_pad).reshape(G, BN, K).astype(np.float32)
    lab = oh.sum(axis=(0, 1))
    beta = rng.uniform(0.2, 1.0, size=(G, BN, K)).astype(np.float32)
    first = (rng.random(B) * counts.sum(axis=0)).astype(np.int32)[:, None]
    trans = np.stack([np.full(G, 0.98), np.full(G, 0.02)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    cnt_max = counts.max(axis=1).astype(np.int32)[None, :]
    return tuple(np.ascontiguousarray(x) for x in (
        lemg, beta, lem_pad, slots, first, lab, trans, cnt_max))
