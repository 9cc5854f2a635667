"""QUILT-compatible VCF output.

Equivalent of make_and_write_output_file + headers (reference:
QUILT/R/writers.R:1-279) and the per-sample column construction
(functions.R:1408-1462): FORMAT GT:GP:DS:HD for diploid,
GT:MGP:MDS:FGP:FDS for NIPT, INFO EAF/INFO_SCORE/HWE/ERC/EAC/PAF, written
as BGZF so downstream htslib tooling can index it.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np

from .bgzf import BgzfWriter


def info_score(eij_sum: np.ndarray, var_sum: np.ndarray, N: int) -> np.ndarray:
    """IMPUTE-style info score from accumulated per-sample eij and
    (fij - eij^2) sums (reference: writers.R:50-56)."""
    thetaHat = eij_sum / (2 * N)
    denom = 2 * N * thetaHat * (1 - thetaHat)
    with np.errstate(invalid="ignore", divide="ignore"):
        info = 1 - var_sum / denom
    info = np.where(
        (np.round(thetaHat, 2) == 0) | (np.round(thetaHat, 2) == 1), 1.0, info
    )
    return np.clip(np.nan_to_num(info, nan=1.0), 0.0, 1.0)


def hwe_exact(het: int, hom1: int, hom2: int) -> float:
    """Exact Hardy-Weinberg p-value (Wigginton, Cutler & Abecasis 2005).

    Equivalent of STITCH::generate_hwe_on_counts used at writers.R:58.
    """
    n_het, n_hom1, n_hom2 = int(het), int(hom1), int(hom2)
    if n_het < 0 or n_hom1 < 0 or n_hom2 < 0:
        return 1.0
    rare = 2 * min(n_hom1, n_hom2) + n_het
    genotypes = n_het + n_hom1 + n_hom2
    if genotypes == 0:
        return 1.0
    probs = np.zeros(rare + 1)
    mid = rare * (2 * genotypes - rare) // (2 * genotypes)
    if (mid % 2) != (rare % 2):
        mid += 1
    probs[mid] = 1.0
    # downward from mid
    het_i = mid
    hom_r = (rare - mid) // 2
    hom_c = genotypes - het_i - hom_r
    while het_i > 1:
        probs[het_i - 2] = (
            probs[het_i] * het_i * (het_i - 1.0)
            / (4.0 * (hom_r + 1.0) * (hom_c + 1.0))
        )
        het_i -= 2
        hom_r += 1
        hom_c += 1
    het_i = mid
    hom_r = (rare - mid) // 2
    hom_c = genotypes - het_i - hom_r
    while het_i <= rare - 2:
        probs[het_i + 2] = (
            probs[het_i] * 4.0 * hom_r * hom_c
            / ((het_i + 2.0) * (het_i + 1.0))
        )
        het_i += 2
        hom_r -= 1
        hom_c -= 1
    s = probs.sum()
    if s <= 0:
        return 1.0
    probs /= s
    target = probs[n_het if n_het <= rare else rare]
    return float(min(1.0, probs[probs <= target + 1e-12].sum()))


def hwe_from_counts(hwe_counts: np.ndarray) -> np.ndarray:
    """Vector of HWE p-values from per-site genotype counts [nSNPs, 3]
    ordered (hom-ref, het, hom-alt)."""
    return np.array(
        [hwe_exact(c[1], c[0], c[2]) for c in hwe_counts], dtype=np.float64
    )


def _fmt(x: float) -> str:
    return f"{x:.3f}".rstrip("0").rstrip(".") if x == x else "."


def fmt_g(arr: np.ndarray, decimals: int = 3) -> np.ndarray:
    """Vectorized f"{round(x, decimals):g}" over an array.

    Rounds half-to-even on the binary product x*10^decimals and formats
    via a lookup over the unique rounded values, so a whole-VCF column
    formats in a handful of numpy passes instead of per-cell Python
    round()+format (the dominant host cost of the column build).
    DEVIATION from Python round(): at values whose scaled product is an
    exact binary half (e.g. 0.0005*1000 == 0.5 exactly) the tie breaks
    on the product rather than the true decimal, so 0.0005 formats as
    '0' where round(0.0005, 3) gives 0.001 — a <=1-ulp-of-last-digit
    difference on probability fields."""
    a = np.asarray(arr, dtype=np.float64).ravel()
    scale = 10.0 ** decimals
    q = np.round(a * scale)
    # fast path: 3-decimal fields (GP/DS/HD) live on a tiny integer
    # lattice — one gather from a static byte table instead of a
    # unique+format pass per call
    if decimals == 3:
        qi = q.astype(np.int64)
        if (q == qi).all() and qi.size and 0 <= qi.min() and qi.max() < len(
            _FMT3_TABLE
        ):
            return _FMT3_TABLE[qi].reshape(np.shape(arr))
    uq, inv = np.unique(q, return_inverse=True)
    # bytes ("S") lookup: byte-string concat in _join_fields is ~4x
    # faster than unicode and the VCF body is ASCII by construction
    strs = np.array([f"{v / scale:g}".encode() for v in uq])
    return strs[inv].reshape(np.shape(arr))


_FMT3_TABLE = np.array(
    [f"{v / 1000.0:g}".encode() for v in range(4001)]
)


def _join_fields(*parts) -> np.ndarray:
    """Elementwise byte-string concat of numpy arrays / literals."""
    out = None
    for p in parts:
        p = np.asarray(p)
        if p.dtype.kind == "U":
            p = np.char.encode(p)
        out = p if out is None else np.char.add(out, p)
    return out


def diploid_sample_column(
    gp: np.ndarray,              # [3, nSNPs]
    phased: np.ndarray,          # [2, nSNPs] 0/1
    dosage: np.ndarray,          # [nSNPs]
    hap_dosages: Optional[np.ndarray] = None,   # [2, nSNPs] float
    output_gt_phased_genotypes: bool = True,
    ohd: Optional[np.ndarray] = None,  # [2, nSNPs] optimal haploid dosages
) -> List[str]:
    if hap_dosages is None:
        hap_dosages = phased.astype(float)
    if output_gt_phased_genotypes:
        p0 = np.rint(phased[0]).astype(np.int64).clip(0, 1)
        p1 = np.rint(phased[1]).astype(np.int64).clip(0, 1)
        gt = np.array([b"0|0", b"0|1", b"1|0", b"1|1"])[2 * p0 + p1]
    else:
        maxgp = gp.max(axis=0)
        argmax = gp.argmax(axis=0)
        gt = np.where(
            maxgp >= 0.9,
            np.array(["0/0", "0/1", "1/1"])[argmax],
            "./.",
        )
    col = _join_fields(
        gt, ":", fmt_g(gp[0]), ",", fmt_g(gp[1]), ",", fmt_g(gp[2]),
        ":", fmt_g(dosage), ":", fmt_g(hap_dosages[0]), ",",
        fmt_g(hap_dosages[1]),
    )
    if ohd is not None:
        # OHD: optimal haploid dosages under truth read labels
        # (reference: FORMAT GT:GP:DS:HD:OHD, functions.R:281)
        col = _join_fields(col, ":", fmt_g(ohd[0]), ",", fmt_g(ohd[1]))
    return col.tolist()          # python bytes; the writer emits bytes


def nipt_sample_column(
    mat_gp: np.ndarray,
    fet_gp: np.ndarray,
    mat_dosage: np.ndarray,
    fet_dosage: np.ndarray,
    phased: np.ndarray,          # [3, nSNPs]
) -> List[str]:
    ph = np.rint(phased).astype(np.int64).clip(0, 1)
    gt8 = np.array([
        b"0|0|0", b"0|0|1", b"0|1|0", b"0|1|1",
        b"1|0|0", b"1|0|1", b"1|1|0", b"1|1|1",
    ])
    col = _join_fields(
        gt8[4 * ph[0] + 2 * ph[1] + ph[2]],
        ":", fmt_g(mat_gp[0]), ",", fmt_g(mat_gp[1]), ",", fmt_g(mat_gp[2]),
        ":", fmt_g(mat_dosage),
        ":", fmt_g(fet_gp[0]), ",", fmt_g(fet_gp[1]), ",", fmt_g(fet_gp[2]),
        ":", fmt_g(fet_dosage),
    )
    return col.tolist()          # python bytes; the writer emits bytes


MISSING_DIPLOID_COL = "./.:.,.,.:.:.,."
MISSING_NIPT_COL = ".|.|.:.,.,.:.:.,.,.:."


def make_header(
    sample_names: Sequence[str],
    method: str = "diploid",
    output_gt_phased_genotypes: bool = True,
    with_ohd: bool = False,
) -> str:
    info = (
        '##INFO=<ID=INFO_SCORE,Number=.,Type=Float,Description="Info score">\n'
        '##INFO=<ID=EAF,Number=.,Type=Float,Description="Estimated allele frequency">\n'
        '##INFO=<ID=HWE,Number=.,Type=Float,Description="Hardy-Weinberg p-value">\n'
        '##INFO=<ID=ERC,Number=.,Type=Float,Description="Estimated number of copies of the reference allele from the pileup">\n'
        '##INFO=<ID=EAC,Number=.,Type=Float,Description="Estimated number of copies of the alternate allele from the pileup">\n'
        '##INFO=<ID=PAF,Number=.,Type=Float,Description="Estimated allele frequency using the pileup of reference and alternate alleles">\n'
    )
    if method == "nipt":
        fmt = (
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Phased genotypes in order of maternal transmitted, maternal untransmitted, and fetal transmitted">\n'
            '##FORMAT=<ID=MGP,Number=3,Type=Float,Description="Maternal Posterior genotype probability of 0/0, 0/1, and 1/1">\n'
            '##FORMAT=<ID=MDS,Number=1,Type=Float,Description="Maternal Diploid dosage">\n'
            '##FORMAT=<ID=FGP,Number=3,Type=Float,Description="Fetal Posterior genotype probability of 0/0, 0/1, and 1/1">\n'
            '##FORMAT=<ID=FDS,Number=1,Type=Float,Description="Fetal Diploid dosage">\n'
        )
    else:
        if output_gt_phased_genotypes:
            gt = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Phased genotypes">\n'
        else:
            gt = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Most likely genotype, given posterior probability of at least 0.90">\n'
        fmt = gt + (
            '##FORMAT=<ID=GP,Number=3,Type=Float,Description="Posterior genotype probability of 0/0, 0/1, and 1/1">\n'
            '##FORMAT=<ID=DS,Number=1,Type=Float,Description="Diploid dosage">\n'
            '##FORMAT=<ID=HD,Number=2,Type=Float,Description="Haploid dosages">\n'
        )
        if with_ohd:
            # OHD: haploid dosages when read labels are known from truth
            # (reference: writers.R:66-67, FORMAT GT:GP:DS:HD:OHD)
            fmt += '##FORMAT=<ID=OHD,Number=2,Type=Float,Description="Optimal haploid dosages (truth read labels)">\n'
    cols = "\t".join(
        ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
         "FORMAT"] + list(sample_names)
    )
    return "##fileformat=VCFv4.0\n" + info + fmt + cols + "\n"


def write_quilt_vcf(
    path: str,
    chrom: str,
    pos: np.ndarray,
    ref_allele: np.ndarray,
    alt_allele: np.ndarray,
    sample_names: Sequence[str],
    sample_columns: Sequence[Sequence],   # per sample: nSNPs str-or-bytes
    eaf: np.ndarray,
    info: np.ndarray,
    hwe: np.ndarray,
    allele_count: np.ndarray,    # [nSNPs, 2] (alt, total)
    in_region: Optional[np.ndarray] = None,
    method: str = "diploid",
    output_gt_phased_genotypes: bool = True,
    write_index: bool = True,
    with_ohd: bool = False,
    timed=None,
) -> None:
    """timed(name): a context manager around the spans of the write
    (the engine's SectionTimers.section): "vcf.format" the lines and their
    buffering, with "vcf.deflate" each BGZF block inside it, then
    "vcf.tabix" the index."""
    from .tabix import TabixIndexer

    timed = timed or (lambda name: contextlib.nullcontext())
    nSNPs = len(pos)
    if in_region is None:
        in_region = np.ones(nSNPs, dtype=bool)
    fmt = "GT:MGP:MDS:FGP:FDS" if method == "nipt" else "GT:GP:DS:HD"
    if with_ohd and method != "nipt":
        fmt += ":OHD"
    erc = allele_count[:, 1] - allele_count[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        paf = allele_count[:, 0] / allele_count[:, 1]
    paf = np.nan_to_num(paf, nan=0.0)
    idx = TabixIndexer() if write_index else None
    offsets = []          # (site, virtual start, virtual end) of each line
    with timed("vcf.format"):
        # vectorized INFO strings (per-cell round()+format is the dominant host
        # cost at whole-chromosome nSNPs)
        info_fields = _join_fields(
            "EAF=", fmt_g(eaf, 5), ";INFO_SCORE=", fmt_g(info, 5),
            ";HWE=", np.char.mod("%.2e", np.asarray(hwe, dtype=np.float64)),
            ";ERC=", fmt_g(erc, 5), ";EAC=", fmt_g(allele_count[:, 0], 5),
            ";PAF=", fmt_g(paf, 5),
        ).tolist()
        pos_str = np.asarray(pos).astype(np.int64).astype(str).tolist()
        ref_l = np.asarray(ref_allele).astype(str).tolist()
        alt_l = np.asarray(alt_allele).astype(str).tolist()
        with BgzfWriter(path, timed=timed) as w:
            w.write(make_header(sample_names, method, output_gt_phased_genotypes,
                                with_ohd=with_ohd and method != "nipt"))
            for s in range(nSNPs):
                if not in_region[s]:
                    continue
                fields = [
                    chrom, pos_str[s], ".", ref_l[s],
                    alt_l[s], ".", "PASS", info_fields[s], fmt,
                ] + [col[s] for col in sample_columns]
                vbeg = w.tell_virtual()
                w.write(b"\t".join(
                    f if isinstance(f, bytes) else f.encode() for f in fields
                ) + b"\n")
                if idx is not None:
                    offsets.append((s, vbeg, w.tell_virtual()))
    if idx is not None:
        with timed("vcf.tabix"):
            for s, vbeg, vend in offsets:
                idx.add(chrom, int(pos[s]), vbeg, vend)
            idx.write(path + ".tbi")
