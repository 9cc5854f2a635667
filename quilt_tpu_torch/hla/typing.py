"""HLA allele typing for one sample (a port of quilt_tpu/hla/typing.py: the
pair scan, there a jax.lax.scan, is a chunked torch reduction on the
caller's device here; the rest is the JAX package's host code).

Functional equivalent of QUILT_HLA / quilt_hla_one_sample (reference:
QUILT/R/quilt-hla.R:24-316, hla_functions.R): combine
(1) direct read-vs-allele mapping likelihoods over the gene's reads
    (do_simon_read_stuff_with_that_and_that2, hla_functions.R:1345-1645),
    with kmer-consistency filtering (filter_that*, :491-710), and
(2) allele probabilities derived from QUILT's full-panel state posterior
    at the gene-centre grid through the allele-labeled panel haplotypes
    (get_fourdigitreadscaledlikelihoodmat, :757-852),
reporting best allele pairs until cumulative posterior >= 0.99
(getbestalleles, :1327-1344).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import print_message
from .db import BASES
from .prepare import HLAPrepared


@dataclass
class GeneRead:
    pos0: int                 # 0-based genomic leftmost
    seq: np.ndarray           # uint8 base codes
    qual: np.ndarray          # int


@dataclass
class HLATypingResult:
    gene: str
    allele_names: List[str]
    # pair posteriors, both modes
    pairs_combined: List[Tuple[str, str, float]]   # sorted desc
    pairs_quilt_only: List[Tuple[str, str, float]]
    bestallele1: str
    bestallele2: str
    post: float


def revcomp_codes(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of 0..3 base codes (4 = unknown stays 4)."""
    r = seq[::-1]
    return np.where(r < 4, 3 - r, 4).astype(np.uint8)


def _rolling_kmer_codes(seq: np.ndarray, k: int):
    """(codes, valid) for every k-mer start in seq: 2-bit packed code and a
    validity mask (no unknown base inside the window)."""
    L = len(seq)
    if L < k:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    s = np.where(seq < 4, seq, 0).astype(np.int64)
    n = L - k + 1
    codes = np.zeros(n, dtype=np.int64)
    for j in range(k):
        codes = (codes << 2) | s[j:j + n]
    okbase = (seq < 4)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        valid &= okbase[j:j + n]
    return codes, valid


def build_seed_index(db, k: int) -> Dict[int, int]:
    """k-mer -> gene-alignment offset of its first occurrence across all
    alleles. Because db.seqs is the IPD-IMGT multiple alignment, one offset
    places a read against every allele simultaneously — the TPU-side
    restructuring of the reference's per-allele lookup/revlookup seed
    tables (hla_functions.R getalleles; built at hla_prepare_functions.R
    make_and_save_hla_full_alleles_filled_in)."""
    idx: Dict[int, int] = {}
    for a in range(db.n_alleles):
        codes, valid = _rolling_kmer_codes(db.seqs[a], k)
        for p in np.flatnonzero(valid):
            c = int(codes[p])
            if c not in idx:
                idx[c] = int(p)
    return idx


def place_read_by_kmers(
    seq: np.ndarray, seed_idx: Dict[int, int], k: int,
    max_probes: int = 12,
) -> Tuple[Optional[int], int]:
    """Seed a read against the gene alignment: probe k-mers at spread
    offsets, vote on the implied read start offset. Returns
    (start_offset_in_gene, n_votes); (None, 0) when nothing seeds.
    Equivalent of the reference's 4-probe kk[] lookup placement
    (hla_functions.R do_simon_read_stuff readpos construction)."""
    codes, valid = _rolling_kmer_codes(seq, k)
    n = len(codes)
    if n == 0:
        return None, 0
    step = max(1, n // max_probes)
    votes: Dict[int, int] = {}
    for off in range(0, n, step):
        if not valid[off]:
            continue
        p = seed_idx.get(int(codes[off]))
        if p is not None:
            st = p - off
            votes[st] = votes.get(st, 0) + 1
    if not votes:
        return None, 0
    st, v = max(votes.items(), key=lambda kv: kv[1])
    return st, v


def _kmer_fraction(seq: np.ndarray, kmers, k: int) -> float:
    if len(seq) < k:
        return 0.0
    n = hit = 0
    code = 0
    valid = 0
    mask = (1 << (2 * k)) - 1
    for b in seq:
        if b >= 4:
            code, valid = 0, 0
            continue
        code = ((code << 2) | int(b)) & mask
        valid += 1
        if valid >= k:
            n += 1
            if code in kmers:
                hit += 1
    return hit / max(n, 1)


def read_allele_loglik(
    read: GeneRead, hla: HLAPrepared,
    start_off: Optional[int] = None,
) -> Optional[np.ndarray]:
    """log P(read | allele) for every allele, aligning by genomic position
    (mapped reads) or by a caller-supplied gene offset (kmer-seeded
    alt-contig reads).

    Bases outside the gene span are ignored; mismatches cost log(eps/3)
    with eps from the base quality (hla_functions.R getscores :974-999).
    """
    g = hla.db.gene
    A = hla.db.n_alleles
    L = g.length
    if start_off is None:
        start_off = read.pos0 + 1 - g.start      # offset into gene seq
    lo = max(0, -start_off)
    hi = min(len(read.seq), L - start_off)
    if hi - lo < hla.k:
        return None
    idx = np.arange(lo, hi)
    gidx = start_off + idx
    seq = read.seq[idx]
    qual = np.maximum(read.qual[idx].astype(np.float64), 5.0)
    eps = 10.0 ** (-qual / 10.0)
    ok = seq < 4
    if ok.sum() < hla.k:
        return None
    allele_bases = hla.db.seqs[:, gidx]           # [A, n]
    match = allele_bases == seq[None, :]
    logp = np.where(
        match, np.log(1 - eps)[None, :], np.log(eps / 3)[None, :]
    )
    logp = np.where(ok[None, :], logp, 0.0)
    return logp.sum(axis=1)


def _pair_read_logsum(LL: np.ndarray, device) -> np.ndarray:
    """sum_r log P(read r | a1, a2) over the full A x A pair matrix, with
    P(r | a1, a2) = (P(r | a1) + P(r | a2)) / 2, for the reads' allele
    log-likelihoods LL [R, A]: per read scaled by its maximum, chunks of C
    reads summed as a float32 [A, A] reduction on `device` into a
    Kahan-compensated float32 running sum (full IPD-IMGT allele counts
    reach A > 4,000 for HLA-B; with thousands of reads the sums reach
    1e4-1e5, where plain float32 error, ~1e-2, can flip near-tie pair
    posteriors). Pairs below the float32-safe floor 1e-37 are decisively
    rejected either way. The JAX package runs the same chunks as a scan
    (quilt_tpu/hla/typing.py:223-273)."""
    R, A = LL.shape
    m = LL.max(axis=1, keepdims=True)             # per-read scale
    E = (0.5 * np.exp(LL - m)).astype(np.float32)
    C = int(max(1, min(32, (1 << 27) // max(A * A, 1))))
    n_chunks = (R + C - 1) // C
    Ep = np.zeros((n_chunks * C, A), dtype=np.float32)
    Ep[:R] = E
    Ed = torch.as_tensor(Ep, device=device).reshape(n_chunks, C, A)
    valid = torch.as_tensor((np.arange(n_chunks * C) < R).astype(np.float32),
                            device=device).reshape(n_chunks, C)
    acc = torch.zeros((A, A), dtype=torch.float32, device=device)
    comp = torch.zeros((A, A), dtype=torch.float32, device=device)
    for e, v in zip(Ed, valid):
        pair = torch.log(torch.clamp(e[:, :, None] + e[:, None, :], min=1e-37))
        chunk = (pair * v[:, None, None]).sum(dim=0)
        y = chunk - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc.double().cpu().numpy() + float(m.sum())


def type_hla_sample(
    hla: HLAPrepared,
    reads: Sequence[GeneRead],
    gammas: Optional[np.ndarray] = None,     # [n_chains, K] or [K]
    kmer_min_fraction: float = 0.5,
    post_cutoff: float = 0.99,
    *,
    device,
) -> HLATypingResult:
    """Type one sample's HLA alleles from its gene reads and, when given, the
    full-panel state posterior at the gene grid; the pair scan runs on
    `device` (a torch device; the caller's choice, "cuda" on the GPU)."""
    A = hla.db.n_alleles
    names = hla.db.allele_names
    # ---- direct read likelihoods with kmer filter
    logliks: List[np.ndarray] = []
    n_filtered = 0
    seed_idx: Optional[Dict[int, int]] = None
    for rd in reads:
        seq, qual, start_off = rd.seq, rd.qual, None
        if rd.pos0 is None or rd.pos0 < 0:
            # alt-contig read with no genomic position: place it on the
            # allele alignment by kmer seeding, trying both strands
            # (reference scores fwd + revcomp and keeps the better,
            # hla_functions.R do_simon_read_stuff :1345-1645)
            if seed_idx is None:
                seed_idx = build_seed_index(hla.db, hla.k)
            st_f, v_f = place_read_by_kmers(seq, seed_idx, hla.k)
            rc = revcomp_codes(seq)
            st_r, v_r = place_read_by_kmers(rc, seed_idx, hla.k)
            if max(v_f, v_r) < 2:
                n_filtered += 1
                continue
            if v_r > v_f:
                seq = rc
                qual = np.asarray(qual)[::-1]
                start_off = st_r
            else:
                start_off = st_f
            rd = GeneRead(pos0=-1, seq=seq, qual=qual)
        if _kmer_fraction(seq, hla.kmers, hla.k) < kmer_min_fraction:
            n_filtered += 1
            continue
        ll = read_allele_loglik(rd, hla, start_off=start_off)
        if ll is not None:
            logliks.append(ll)
    # ---- state-posterior allele prior
    if gammas is not None:
        gam = np.atleast_2d(np.asarray(gammas))
        prior = np.zeros(A)
        for row in gam:
            prior += hla.allele_prior_from_gamma(row)
        prior /= len(gam)
        prior = np.maximum(prior, 1e-12)
    else:
        prior = np.full(A, 1.0 / A)

    def pair_posteriors(use_reads: bool, use_prior: bool):
        # vectorized over the full A x A pair matrix: per read r,
        # log P(r | a1, a2) = logsumexp(ll[a1] - log2, ll[a2] - log2)
        # accumulated as an outer sum of per-read scaled likelihoods
        # (replaces the reference's per-pair loop, hla_functions.R:1345-1645;
        # O(R*A^2) vector work instead of O(A^2 * R) Python)
        logw = np.zeros((A, A))
        if use_prior:
            lp = np.log(prior)
            logw += lp[:, None] + lp[None, :]
            logw += np.where(np.eye(A, dtype=bool), 0.0, np.log(2.0))
        if use_reads and logliks:
            LL = np.stack(logliks)                    # [R, A]
            logw += _pair_read_logsum(LL, device)
        iu = np.triu_indices(A)
        vals = logw[iu]
        vals = vals - vals.max()
        p = np.exp(vals)
        p /= p.sum()
        order = np.argsort(-p)
        return [
            (names[iu[0][o]], names[iu[1][o]], float(p[o])) for o in order
        ]

    combined = pair_posteriors(use_reads=True, use_prior=gammas is not None)
    quilt_only = pair_posteriors(use_reads=False, use_prior=True)
    best = combined[0]
    print_message(
        f"HLA {hla.db.gene.name}: {len(logliks)} reads used "
        f"({n_filtered} kmer-filtered); best {best[0]}/{best[1]} "
        f"post {best[2]:.3f}"
    )
    return HLATypingResult(
        gene=hla.db.gene.name,
        allele_names=names,
        pairs_combined=combined,
        pairs_quilt_only=quilt_only,
        bestallele1=best[0],
        bestallele2=best[1],
        post=best[2],
    )


def write_hla_summaries(
    results: Dict[str, HLATypingResult],
    sample_names: Sequence[str],
    outputdir: str,
    region: str,
    post_cutoff: float = 0.99,
) -> None:
    """Write the reference's 4 summary tables (quilt-hla.R:278-307):
    {top, all >= cutoff} x {combined, quilt-only}."""
    import os

    os.makedirs(outputdir, exist_ok=True)
    for mode in ("combined", "quiltonly"):
        top_rows = ["sample_number\tsample_name\tbestallele1\tbestallele2\tpost"]
        all_rows = ["sample_number\tsample_name\tallele1\tallele2\tpost\tsums"]
        for i, sn in enumerate(sample_names):
            res = results.get(sn)
            if res is None:
                continue
            pairs = (
                res.pairs_combined if mode == "combined"
                else res.pairs_quilt_only
            )
            top_rows.append(
                f"{i + 1}\t{sn}\t{pairs[0][0]}\t{pairs[0][1]}\t{pairs[0][2]:.4f}"
            )
            cum = 0.0
            for a1, a2, p in pairs:
                cum += p
                all_rows.append(f"{i + 1}\t{sn}\t{a1}\t{a2}\t{p:.4f}\t{cum:.4f}")
                if cum >= post_cutoff:
                    break
        for kind, rows in (("topresult", top_rows), ("allres", all_rows)):
            path = os.path.join(
                outputdir, f"quilt.hla.output.{mode}.{kind}.{region}.txt"
            )
            with open(path, "w") as fh:
                fh.write("\n".join(rows) + "\n")
