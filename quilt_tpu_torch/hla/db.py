"""HLA allele database representation and simulator.

Stands in for the IPD-IMGT/HLA alignment ingestion of the reference
(QUILT/R/hla_prepare_functions.R: get_hla_gene_information :956,
make_and_save_hla_all_alleles_kmers :213): per gene, 4-digit alleles with
genomic-aligned sequences over the gene span. Real IPD-IMGT parsing plugs
in by constructing HLAAlleleDB from the alignment files; the simulator
fabricates a consistent world for tests (the reference does the same for
its HLA acceptance tests, test-acceptance-hla.R:1-120).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

BASES = "ACGT"


@dataclass
class HLAGene:
    name: str
    chrom: str
    start: int          # 1-based inclusive genomic span
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start + 1


@dataclass
class HLAAlleleDB:
    gene: HLAGene
    allele_names: List[str]
    seqs: np.ndarray          # uint8 [A, L] base codes 0..3 (4 = unknown)

    @property
    def n_alleles(self) -> int:
        return len(self.allele_names)

    def seq_str(self, a: int) -> str:
        return "".join(BASES[b] if b < 4 else "N" for b in self.seqs[a])


def simulate_hla_db(
    rng: np.random.Generator,
    gene: HLAGene,
    n_alleles: int = 8,
    n_variant_sites: int = 40,
) -> HLAAlleleDB:
    """Fabricate an allele database: a random base sequence with allele-
    distinguishing variant sites."""
    L = gene.length
    base = rng.integers(0, 4, size=L).astype(np.uint8)
    sites = np.sort(rng.choice(L, size=n_variant_sites, replace=False))
    seqs = np.tile(base, (n_alleles, 1))
    for a in range(1, n_alleles):
        nvar = rng.integers(max(2, n_variant_sites // 4), n_variant_sites + 1)
        which = rng.choice(sites, size=nvar, replace=False)
        for s in which:
            seqs[a, s] = (seqs[a, s] + rng.integers(1, 4)) % 4
    names = [f"{gene.name}*{i // 10 + 1:02d}:{i % 10 + 1:02d}"
             for i in range(n_alleles)]
    return HLAAlleleDB(gene=gene, allele_names=names, seqs=seqs.astype(np.uint8))


def alleles_at_positions(
    db: HLAAlleleDB, pos: np.ndarray, ref: np.ndarray, alt: np.ndarray
) -> np.ndarray:
    """For panel SNPs inside the gene: each allele's 0/1 (ref/alt) state,
    -1 where the allele sequence matches neither. [A, nSNPs_in_gene]."""
    g = db.gene
    inside = (pos >= g.start) & (pos <= g.end)
    idx = np.flatnonzero(inside)
    out = np.full((db.n_alleles, len(idx)), -1, dtype=np.int8)
    for j, si in enumerate(idx):
        off = int(pos[si] - g.start)
        rc = BASES.index(str(ref[si])) if str(ref[si]) in BASES else -1
        ac = BASES.index(str(alt[si])) if str(alt[si]) in BASES else -1
        col = db.seqs[:, off]
        out[col == rc, j] = 0
        out[col == ac, j] = 1
    return out, idx


def save_hla_db(db: HLAAlleleDB, path: str) -> None:
    np.savez_compressed(
        path,
        gene_name=np.array(db.gene.name),
        gene_chrom=np.array(db.gene.chrom),
        gene_span=np.array([db.gene.start, db.gene.end]),
        allele_names=np.asarray(db.allele_names),
        seqs=db.seqs,
    )


def load_hla_db(path: str) -> HLAAlleleDB:
    z = np.load(path, allow_pickle=False)
    gene = HLAGene(
        name=str(z["gene_name"]),
        chrom=str(z["gene_chrom"]),
        start=int(z["gene_span"][0]),
        end=int(z["gene_span"][1]),
    )
    return HLAAlleleDB(
        gene=gene,
        allele_names=[str(x) for x in z["allele_names"]],
        seqs=z["seqs"],
    )
