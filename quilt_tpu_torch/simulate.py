"""Synthetic worlds for the port's smoke run and tests, made from a seed
with the port's simulators (io.simulate, hla.db) and reference preparation
(panel.prepare)."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .hla.db import HLAGene, alleles_at_positions, save_hla_db, simulate_hla_db
from .io import simulate_panel, simulate_sample_reads
from .io.bam_writer import BamWriter, write_panel_vcf
from .io.simulate import simulate_truth_mosaic
from .panel import prepare_panel


def make_world(rng: np.random.Generator, K: int, nSNPs: int, n_samples: int,
               coverage: float = 1.0, read_length_bp: int = 600, rare_frac: float = 0.0,
               quilt2: bool = False, ffs=None, hot_map: bool = False, phred: int = 25) -> Dict:
    """A prepared panel of K haplotypes over nSNPs SNPs spaced ~60 bp, and
    n_samples samples' reads of read_length_bp at base quality phred (ONT:
    ~6-20 kb at phred 10) from truth mosaics of the panel.
    rare_frac of the sites are rewritten to 1-4 carriers (rare_sites).
    quilt2 prepares the panel as `prepare2` does (rare/common split at the
    default rare_af_threshold, msPBWT indices) and simulates the reads on
    the all-SNP axis. ffs [n_samples] makes NIPT samples: three truth
    haplotypes (mother's transmitted and untransmitted, the fetus's
    paternal) and reads drawn from them at the sample's fetal fraction.
    hot_map prepares the panel with hot_genetic_map's map (nGen 1,000), so
    the static block-Gibbs boundaries fall in its hotspots.
    Returns {"prep", "samples", "truths" ([2 or 3, nSNPs] each, all SNPs)}."""
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=nSNPs * 60)
    if rare_frac:
        rare_sites(rng, haps, int(round(rare_frac * nSNPs)), max_carriers=4)
    opts = dict(impute_rare_common=True, use_mspbwt=True, mspbwt_nindices=4) if quilt2 else {}
    if hot_map:
        opts.update(gmap_pos=pos, gmap_cm=hot_genetic_map(nSNPs), nGen=1000)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, **opts)
    grid = prep.grid_all if quilt2 else prep.grid
    samples, truths = [], []
    for i in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2 if ffs is None else 3)
        reads, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=coverage,
                                         read_length_bp=read_length_bp, phred=phred,
                                         ff=0.0 if ffs is None else float(ffs[i]))
        samples.append(reads)
        truths.append(truth)
    return dict(prep=prep, samples=samples, truths=truths)


def hot_genetic_map(nSNPs: int) -> np.ndarray:
    """Genetic map (cM at each SNP) with a hotspot of 60 SNPs at 15x the
    background rate every 400 SNPs from SNP 300, as
    tests/test_block_otf.py:test_pse_parity_hot_map builds it."""
    rate = np.full(nSNPs, 1.0)
    for h0 in range(300, nSNPs - 60 + 1, 400):
        rate[h0:h0 + 60] = 15.0
    return np.cumsum(rate) * 2e-5


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


def write_hla_world(out_dir: str, rng: np.random.Generator, K: int = 5120, nSNPs: int = 16384,
                    n_samples: int = 4, n_alleles: int = 2000) -> Dict:
    """An HLA world under out_dir: a panel of K haplotypes over nSNPs SNPs
    (~60 bp apart, ref A / alt G) with a 3,000 bp gene in the middle, whose
    160 panel SNPs are the variant sites of a simulated allele database of
    n_alleles alleles (hla.db.simulate_hla_db); each panel haplotype carries
    one allele, drawn with Zipf frequencies (the r-th allele ~ 1/r). The
    samples' truth haplotypes are mosaics of the panel without a switch
    inside the gene, so each carries one panel allele. Writes the prepared
    reference (prep.npz, as `prepare` would), the allele database
    (hla_db.npz, for `hla-prepare --hla_db`) and a BAM a sample: 600 bp reads
    at 1x over the region plus 150 bp reads at 1x over the gene, the
    sequence being the truth haplotype's alleles at the SNPs, the allele's
    sequence inside the gene and C elsewhere, with 0.3% base errors.
    Returns {"prep_file", "db_file", "bamlist", "gene", "alleles" ([n_samples]
    of the two truth allele names), "truths" ([2, nSNPs] each)}."""
    gene_length, read_length_bp, gene_read_length_bp = 3000, 600, 150
    gene0 = HLAGene("HLA-B", "chr6", 1, gene_length)
    db = simulate_hla_db(rng, gene0, n_alleles=n_alleles, n_variant_sites=160)
    var = np.flatnonzero((db.seqs != db.seqs[0][None, :]).any(axis=0))
    n_bg = nSNPs - len(var)
    haps_bg, pos_bg = simulate_panel(rng, K=K, nSNPs=n_bg, region_span=n_bg * 60)
    start = int(pos_bg[n_bg // 2]) + 30
    pos_bg = np.where(pos_bg >= start, pos_bg + gene_length + 60, pos_bg)
    gene = HLAGene("HLA-B", "chr6", start, start + gene_length - 1)
    db.gene = gene
    pos_g = start + var.astype(np.int64)
    ref_g = np.array(["ACGT"[b] for b in db.seqs[0, var]])
    alt_g = []
    for s in var:
        col = db.seqs[:, s]
        other = col[(col != db.seqs[0, s]) & (col < 4)]
        alt_g.append("ACGT"[int(np.bincount(other, minlength=4).argmax())])
    alt_g = np.array(alt_g)
    freq = 1.0 / np.arange(1, n_alleles + 1)
    hap_allele = rng.choice(n_alleles, size=K, p=freq / freq.sum())
    states, _ = alleles_at_positions(db, pos_g, ref_g, alt_g)
    pos = np.concatenate([pos_bg, pos_g])
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    haps = np.concatenate([haps_bg, (states[hap_allele] == 1).astype(np.uint8)], axis=1)[:, order]
    ref = np.concatenate([np.array(["A"] * n_bg), ref_g])[order]
    alt = np.concatenate([np.array(["G"] * n_bg), alt_g])[order]
    prep = prepare_panel(chrom="chr6", pos=pos, ref_allele=ref, alt_allele=alt, haps=haps)
    prep_file = os.path.join(out_dir, "prep.npz")
    prep.save(prep_file)
    db_file = os.path.join(out_dir, "hla_db.npz")
    save_hla_db(db, db_file)

    in_gene = (pos >= gene.start) & (pos <= gene.end)
    g0 = int(np.flatnonzero(in_gene)[0])
    snp_base = np.where(haps == 1, 2, 0).astype(np.uint8)          # A = 0, G = 2
    L_region = int(pos[-1]) + 1000
    truths, alleles, bams = [], [], []
    for i in range(n_samples):
        truth = np.zeros((2, nSNPs), dtype=np.uint8)
        seqs = np.full((2, L_region), 1, dtype=np.uint8)               # C
        names = []
        for h in range(2):
            jumps = rng.random(nSNPs) < 0.002
            jumps[0] = True
            jumps[in_gene] = False
            src = rng.integers(0, K, size=nSNPs)[
                np.maximum.accumulate(np.where(jumps, np.arange(nSNPs), 0))]
            truth[h] = haps[src, np.arange(nSNPs)]
            seqs[h, pos - 1] = snp_base[src, np.arange(nSNPs)]
            a = int(hap_allele[src[g0]])
            seqs[h, gene.start - 1:gene.end] = db.seqs[a]
            names.append(db.allele_names[a])
        truths.append(truth)
        alleles.append(tuple(names))
        bam = os.path.join(out_dir, f"s{i}.bam")
        with BamWriter(bam, "chr6", L_region, sample_name=f"HLA{i}") as w:
            r = 0
            for L, lo, hi, n in (
                    (read_length_bp, int(pos[0]) - 100, int(pos[-1]),
                     int((pos[-1] - pos[0]) / read_length_bp)),
                    (gene_read_length_bp, gene.start - 1, gene.end - gene_read_length_bp,
                     gene_length // gene_read_length_bp)):
                for _ in range(n):
                    s0 = int(rng.integers(max(lo, 0), min(hi, L_region - L)))
                    b = seqs[int(rng.integers(0, 2)), s0:s0 + L].copy()
                    err = rng.random(L) < 0.003
                    b[err] = (b[err] + rng.integers(1, 4, int(err.sum()))) % 4
                    w.write_read(f"r{r}", s0, "".join("ACGTN"[x] for x in b), [25] * L)
                    r += 1
        bams.append(bam)
    bamlist = os.path.join(out_dir, "bamlist.txt")
    with open(bamlist, "w") as fh:
        fh.write("\n".join(bams) + "\n")
    return dict(prep_file=prep_file, db_file=db_file, bamlist=bamlist, gene=gene,
                alleles=alleles, truths=truths)
