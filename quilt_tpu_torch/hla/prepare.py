"""HLA reference preparation.

Functional equivalent of QUILT_HLA_prepare_reference (reference:
QUILT/R/quilt-hla-prepare-reference.R:26-119 + hla_prepare_functions.R +
hla_prepare_phase_functions.R): build the kmer filter database over all
allele sequences and label each reference-panel haplotype with its best
4-digit allele.

Two labeling paths:
- With an unphased HLA types panel (``hla_types_panel``, per-reference-
  sample 4-digit diploid types): the two-step phasing of
  phase_hla_haplotypes (hla_prepare_phase_functions.R:1-813) — initial
  orientation from allele-database SNP profiles at quality-filtered sites,
  then iterative window-extension refinement rebuilding empirical allele
  profiles from already-phased haplotypes; unphased samples are dropped
  (hla_phasing_determine_who_to_remove, :656-710).
- Without one: each haplotype is assigned by maximum per-SNP agreement with
  each allele's implied ref/alt states — a direct likelihood assignment
  (documented deviation; serves when no typed panel is available).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..panel.prepare import PreparedReference
from ..utils import print_message, unpack_bits_32
from .db import BASES, HLAAlleleDB, alleles_at_positions


def build_kmer_set(db: HLAAlleleDB, k: int = 10) -> Set[int]:
    """All k-mers (2-bit packed) present in any allele sequence
    (equivalent of make_and_save_hla_all_alleles_kmers,
    hla_prepare_functions.R:213)."""
    kmers: Set[int] = set()
    for a in range(db.n_alleles):
        seq = db.seqs[a]
        code = 0
        valid = 0
        for b in seq:
            if b >= 4:
                code, valid = 0, 0
                continue
            code = ((code << 2) | int(b)) & ((1 << (2 * k)) - 1)
            valid += 1
            if valid >= k:
                kmers.add(code)
    return kmers


def normalize_hla_type(t: str, gene_name: str = "") -> str:
    """Normalize a types-panel entry to a bare 4-digit string ("01:01").

    Mirrors the reference's cleanup (hla_prepare_phase_functions.R:404-421):
    strip the gene prefix and '*', and when several candidate types are
    '/'-separated keep the first (lowest-numbered) one. Returns '' for
    missing/None entries.
    """
    t = (t or "").strip()
    if not t or t.upper() in ("NONE", "NA", "-"):
        return ""
    t = t.split("/")[0]
    if "*" in t:
        t = t.split("*", 1)[1]
    elif gene_name and t.startswith(gene_name):
        t = t[len(gene_name):].lstrip("-")
    parts = t.split(":")
    if len(parts) >= 2:
        t = f"{parts[0]}:{parts[1]}"
    return t


def load_hla_types_panel(path: str, region: str):
    """Read an unphased HLA types panel table (tab-separated, header; e.g.
    the 1000 Genomes 20181129 HLA types file the reference uses,
    hla_prepare_phase_functions.R:60,266). Returns (sample_ids, types1,
    types2) for gene `region` (e.g. "A"); types are normalized 4-digit
    strings, '' when missing. Sample IDs come from the 'Sample.ID' column
    (the reference indexes hlatypes[,3])."""
    import csv

    with open(path) as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    header = [h.strip().replace(" ", ".").replace("-", ".") for h in rows[0]]
    want1, want2 = f"HLA.{region}.1", f"HLA.{region}.2"
    try:
        c1, c2 = header.index(want1), header.index(want2)
    except ValueError as e:
        raise ValueError(
            f"types panel {path} lacks columns {want1}/{want2}: {header}"
        ) from e
    sid_col = header.index("Sample.ID") if "Sample.ID" in header else 2
    ids, t1, t2 = [], [], []
    for r in rows[1:]:
        if len(r) <= max(c1, c2, sid_col):
            continue
        ids.append(r[sid_col].strip())
        t1.append(normalize_hla_type(r[c1], region))
        t2.append(normalize_hla_type(r[c2], region))
    return ids, t1, t2


def _db_allele_index(db: HLAAlleleDB) -> Dict[str, int]:
    """4-digit string ("01:01") -> allele index in the database."""
    out: Dict[str, int] = {}
    for i, name in enumerate(db.allele_names):
        key = normalize_hla_type(name)
        if key and key not in out:
            out[key] = i
    return out


def phase_hla_haplotypes(
    db: HLAAlleleDB,
    prep: PreparedReference,
    types1: List[str],
    types2: List[str],
    extensions: range = range(50, 1001, 50),
    corr_cutoff: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Phase unordered per-sample 4-digit types onto the two panel
    haplotypes of each sample (reference: hla_perform_step_1_phasing,
    hla_prepare_phase_functions.R:252-653, + step-2 integration :716-813).

    types1/types2 are normalized 4-digit strings per panel sample (hap 2i,
    2i+1 belong to sample i), '' when missing. Returns (hap_labels [K]
    int32 allele index or -1, phased [nSamp] bool). Samples that cannot be
    phased get -1 labels — the equivalent of being written to the
    who-to-remove exclusion list (:656-710).

    Step 1a: distances between each haplotype's inflated allele dosages and
    each reported type's database SNP profile, restricted to sites whose
    observed-vs-predicted genotype correlation exceeds `corr_cutoff`
    (:478-487); confident orientations per the reference's mismatch rules
    (<4 with alternative >4, margin >2, homozygous types, one-sided margins
    when only one type is in the database; :530-538).
    Step 1b: iterative window extension — rebuild per-allele profiles
    empirically from already-phased haplotypes over a widening SNP-index
    window and assign remaining samples to the nearer orientation
    (:556-640).
    """
    idx_of = _db_allele_index(db)
    states, gene_idx = alleles_at_positions(
        db, prep.pos, prep.ref_allele, prep.alt_allele
    )
    K = prep.K
    nSamp = K // 2
    assert len(types1) == nSamp and len(types2) == nSamp
    e = prep.ref_error
    lo_d, hi_d = min(e, 0.001), max(1 - e, 0.999)
    haps01 = unpack_bits_32(prep.rhb_t, prep.nSNPs).astype(np.float64)
    obs_all = np.where(haps01 > 0.5, hi_d, lo_d)

    a1 = np.array([idx_of.get(t, -1) for t in types1], dtype=np.int64)
    a2 = np.array([idx_of.get(t, -1) for t in types2], dtype=np.int64)
    t_known1 = np.array([bool(t) for t in types1])
    t_known2 = np.array([bool(t) for t in types2])
    homo = t_known1 & t_known2 & (np.asarray(types1) == np.asarray(types2))

    # database profiles at gene SNPs: [A, nGene] in (0,1), NaN unknown
    nGene = len(gene_idx)
    prof_db = np.full((db.n_alleles, nGene), np.nan)
    prof_db[states == 0] = lo_d
    prof_db[states == 1] = hi_d

    def _row(prof, ai):
        out = np.full((nSamp, prof.shape[1]), np.nan)
        ok = ai >= 0
        out[ok] = prof[ai[ok]]
        return out

    o1 = obs_all[0::2][:, gene_idx]
    o2 = obs_all[1::2][:, gene_idx]
    p1 = _row(prof_db, a1)
    p2 = _row(prof_db, a2)

    # site quality: correlation of observed vs predicted genotype dosage
    # across samples (hla_prepare_phase_functions.R:478-487)
    obsgen = o1 + o2
    predgen = p1 + p2
    good = np.zeros(nGene, dtype=bool)
    with np.errstate(invalid="ignore", divide="ignore"):
        for j in range(nGene):
            pg = predgen[:, j]
            m = np.isfinite(pg)
            if m.sum() < 3:
                continue
            og = obsgen[m, j]
            if og.std() == 0 or pg[m].std() == 0:
                continue
            c = np.corrcoef(og, pg[m])[0, 1]
            good[j] = np.isfinite(c) and c > corr_cutoff

    def _dist(o, p):
        # unknown allele states (NaN sites) contribute nothing; a type
        # missing or absent from the database (all-NaN row) -> NaN distance
        with np.errstate(invalid="ignore"):
            out = np.nansum(np.abs(o[:, good] - p[:, good]), axis=1)
        out[np.isnan(p).all(axis=1)] = np.nan
        return out

    d11, d12 = _dist(o1, p1), _dist(o1, p2)
    d21, d22 = _dist(o2, p1), _dist(o2, p2)
    phase1 = d11 + d22   # orientation A: hap1=type1, hap2=type2
    phase2 = d12 + d21   # orientation B: flipped

    def _fin(x):
        return np.isfinite(x)

    # confident initial orientations (reference :530-538)
    phased1 = (
        (_fin(phase1) & _fin(phase2) & (phase1 < 4) & (phase2 > 4))
        | (_fin(phase1) & _fin(phase2) & (phase2 - phase1 > 2) & (phase1 < 4))
        | homo
        | (~_fin(d21) & _fin(d12) & _fin(d22) & (d12 - d22 > 2) & (d22 < 2))
        | (~_fin(d12) & _fin(d21) & _fin(d11) & (d21 - d11 > 2) & (d11 < 2))
    )
    phased2 = (
        (_fin(phase1) & _fin(phase2) & (phase1 > 4) & (phase2 < 4))
        | (_fin(phase1) & _fin(phase2) & (phase1 - phase2 > 2) & (phase2 < 4))
        | (~_fin(d21) & _fin(d12) & _fin(d22) & (d22 - d12 > 2) & (d12 < 2))
        | (~_fin(d12) & _fin(d21) & _fin(d11) & (d11 - d21 > 2) & (d21 < 2))
    ) & ~phased1

    # step 1b: window-extension refinement from empirically phased profiles
    types1_a = np.asarray(types1, dtype=object)
    types2_a = np.asarray(types2, dtype=object)
    g_lo, g_hi = (int(gene_idx.min()), int(gene_idx.max())) if nGene else (0, 0)
    for ext in extensions:
        if not (phased1 | phased2).any():
            break
        lo = max(0, g_lo - ext)
        hi = min(prep.nSNPs - 1, g_hi + ext)
        w = slice(lo, hi + 1)
        ow1, ow2 = obs_all[0::2, w], obs_all[1::2, w]
        # allele label currently assigned to each hap
        al1 = np.where(phased1, types1_a, np.where(phased2, types2_a, ""))
        al2 = np.where(phased1, types2_a, np.where(phased2, types1_a, ""))
        labels = np.empty(K, dtype=object)
        labels[0::2], labels[1::2] = al1, al2
        uniq = sorted({x for x in labels if x})
        if not uniq:
            break
        prof = {}
        for u in uniq:
            rows = obs_all[np.asarray(labels == u, dtype=bool)][:, w]
            prof[u] = rows.mean(axis=0)
        nan_row = np.full(hi - lo + 1, np.nan)
        pw1 = np.stack([prof.get(t, nan_row) for t in types1_a])
        pw2 = np.stack([prof.get(t, nan_row) for t in types2_a])

        def _cnt(o, p):
            with np.errstate(invalid="ignore"):
                diff = (np.abs(o - p) > 0.9).sum(axis=1).astype(np.float64)
            diff[np.isnan(p).all(axis=1)] = np.nan
            return diff

        b11, b12 = _cnt(ow1, pw1), _cnt(ow1, pw2)
        b21, b22 = _cnt(ow2, pw1), _cnt(ow2, pw2)
        pb1, pb2 = b11 + b22, b12 + b21
        nb1 = (
            (_fin(pb1) & _fin(pb2) & (pb1 < pb2))
            | homo
            | (~_fin(b21) & _fin(b12) & _fin(b22) & (b12 - b22 > 2))
            | (~_fin(b12) & _fin(b21) & _fin(b11) & (b21 - b11 > 2))
        )
        nb2 = (
            (_fin(pb1) & _fin(pb2) & (pb1 > pb2))
            | (~_fin(b21) & _fin(b12) & _fin(b22) & (b22 - b12 > 2))
            | (~_fin(b12) & _fin(b21) & _fin(b11) & (b11 - b21 > 2))
        ) & ~nb1
        update = ~phased1 & ~phased2
        phased1[update] = nb1[update]
        phased2[update] = nb2[update]

    # step 2: integrate — per-hap allele labels (reference :762-807)
    phased = phased1 | phased2
    hap_labels = np.full(K, -1, dtype=np.int32)
    first = np.where(phased1, a1, np.where(phased2, a2, -1))
    second = np.where(phased1, a2, np.where(phased2, a1, -1))
    hap_labels[0::2] = np.where(phased, first, -1).astype(np.int32)
    hap_labels[1::2] = np.where(phased, second, -1).astype(np.int32)
    return hap_labels, phased


@dataclass
class HLAPrepared:
    db: HLAAlleleDB
    kmers: Set[int]
    k: int
    hap_labels: np.ndarray         # int32 [K] allele index per panel hap (-1 none)
    hap_label_scores: np.ndarray   # float [K] agreement fraction
    gene_snp_idx: np.ndarray       # panel SNP indices inside the gene
    gamma_grid: int                # grid closest to the gene centre

    def allele_prior_from_gamma(self, gamma: np.ndarray) -> np.ndarray:
        """Map a full-panel state posterior [K] to allele probabilities [A]
        via the haplotype labels (equivalent of the state-posterior ->
        allele likelihood combination, hla_functions.R:757-852)."""
        A = self.db.n_alleles
        out = np.zeros(A)
        w = self.hap_labels >= 0
        np.add.at(out, self.hap_labels[w], gamma[: len(self.hap_labels)][w])
        s = out.sum()
        if s > 0:
            out /= s
        else:
            out[:] = 1.0 / A
        return out


def prepare_hla_reference(
    db: HLAAlleleDB,
    prep: PreparedReference,
    k: int = 10,
    hla_types: Optional[Tuple[List[str], List[str], List[str]]] = None,
) -> HLAPrepared:
    """`hla_types`, when given, is (sample_ids, types1, types2) from
    load_hla_types_panel; panel haplotypes are then labeled by the two-step
    phasing (phase_hla_haplotypes). Otherwise direct per-hap max-agreement
    labeling is used."""
    g = db.gene
    states, gene_idx = alleles_at_positions(
        db, prep.pos, prep.ref_allele, prep.alt_allele
    )
    K = prep.K
    haps_gene = unpack_bits_32(prep.rhb_t, prep.nSNPs)[:, gene_idx]
    A = db.n_alleles
    # agreement score per (hap, allele) over sites where the allele is
    # ref/alt-consistent
    labels = np.full(K, -1, dtype=np.int32)
    scores = np.zeros(K)
    if hla_types is not None:
        if prep.sample_names is None:
            raise ValueError(
                "hla_types_panel given but the prepared reference has no "
                "sample names (re-run prepare from a VCF/sample file)"
            )
        ids, pt1, pt2 = hla_types
        by_id = {s: i for i, s in enumerate(ids)}
        names = [str(s) for s in prep.sample_names]
        t1 = [pt1[by_id[s]] if s in by_id else "" for s in names]
        t2 = [pt2[by_id[s]] if s in by_id else "" for s in names]
        labels, phased = phase_hla_haplotypes(db, prep, t1, t2)
        scores = np.repeat(phased.astype(np.float64), 2)
        print_message(
            f"HLA phasing {g.name}: {int(phased.sum())}/{len(phased)} "
            f"samples phased ({int((~phased).sum())} to remove)"
        )
    elif len(gene_idx):
        agree = np.zeros((K, A))
        for a in range(A):
            known = states[a] >= 0
            if known.sum() == 0:
                continue
            agree[:, a] = (
                (haps_gene[:, known] == states[a][known][None, :]).mean(axis=1)
            )
        labels = agree.argmax(axis=1).astype(np.int32)
        scores = agree.max(axis=1)
        labels[scores < 0.5] = -1
    gamma_grid = int(prep.grid[gene_idx[len(gene_idx) // 2]]) if len(gene_idx) \
        else int(prep.grid[np.abs(prep.pos - (g.start + g.end) // 2).argmin()])
    print_message(
        f"HLA prepare {g.name}: {A} alleles, {len(gene_idx)} gene SNPs, "
        f"{(labels >= 0).sum()}/{K} haps labeled, gamma grid {gamma_grid}"
    )
    return HLAPrepared(
        db=db,
        kmers=build_kmer_set(db, k),
        k=k,
        hap_labels=labels,
        hap_label_scores=scores,
        gene_snp_idx=gene_idx,
        gamma_grid=gamma_grid,
    )


def save_hla_prepared(hla: HLAPrepared, path: str) -> None:
    np.savez_compressed(
        path,
        gene_name=np.array(hla.db.gene.name),
        gene_chrom=np.array(hla.db.gene.chrom),
        gene_span=np.array([hla.db.gene.start, hla.db.gene.end]),
        allele_names=np.asarray(hla.db.allele_names),
        seqs=hla.db.seqs,
        kmers=np.fromiter(hla.kmers, dtype=np.int64),
        k=np.array(hla.k),
        hap_labels=hla.hap_labels,
        hap_label_scores=hla.hap_label_scores,
        gene_snp_idx=hla.gene_snp_idx,
        gamma_grid=np.array(hla.gamma_grid),
    )


def load_hla_prepared(path: str) -> HLAPrepared:
    from .db import HLAGene, HLAAlleleDB

    z = np.load(path, allow_pickle=False)
    gene = HLAGene(
        name=str(z["gene_name"]),
        chrom=str(z["gene_chrom"]),
        start=int(z["gene_span"][0]),
        end=int(z["gene_span"][1]),
    )
    db = HLAAlleleDB(
        gene=gene,
        allele_names=[str(x) for x in z["allele_names"]],
        seqs=z["seqs"],
    )
    return HLAPrepared(
        db=db,
        kmers=set(int(x) for x in z["kmers"]),
        k=int(z["k"]),
        hap_labels=z["hap_labels"],
        hap_label_scores=z["hap_label_scores"],
        gene_snp_idx=z["gene_snp_idx"],
        gamma_grid=int(z["gamma_grid"]),
    )
