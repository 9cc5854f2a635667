"""Reference-panel VCF ingestion (host side).

Functional equivalent of STITCH::Rcpp_get_hap_info_from_vcf (vcfpp/htslib
C++ used at QUILT/R/quilt-prepare-reference.R:228-246): stream a (bgzipped)
VCF, keep bi-allelic SNPs with unique positions in the target region, apply
sample selection, and emit phased haplotype alleles plus the rare/common
split at af_cutoff.

Pure-Python/NumPy with a fast path for the common all-single-character
"a|b" genotype layout (parsed by byte-striding instead of per-field split).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import print_message
from ..out.bgzf import bgzf_open


@dataclass
class PanelVCF:
    chrom: str
    pos: np.ndarray           # int64 [nSNPs]
    ref_allele: np.ndarray    # str
    alt_allele: np.ndarray    # str
    haps: np.ndarray          # uint8 [K, nSNPs] phased alleles
    sample_names: List[str]
    n_skipped: int


def read_panel_vcf(
    path: str,
    region_chrom: Optional[str] = None,
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
    keep_samples: Optional[Sequence[str]] = None,
    exclude_samples: Optional[Sequence[str]] = None,
    use_native: bool = True,
) -> PanelVCF:
    if use_native:
        try:
            from .native import native_available, read_panel_vcf_native
            from ..utils import unpack_bits_32
            if native_available():
                pos, ref, alt, rhb_t, names, n_skip = read_panel_vcf_native(
                    path, region_chrom, region_start, region_end
                )
                haps = unpack_bits_32(rhb_t, len(pos))
                mask = np.ones(len(names), dtype=bool)
                if keep_samples is not None:
                    keep = set(keep_samples)
                    mask &= np.array([s in keep for s in names])
                if exclude_samples is not None:
                    exc = set(exclude_samples)
                    mask &= np.array([s not in exc for s in names])
                keep_idx = np.flatnonzero(mask)
                if len(keep_idx) != len(names):
                    rows = np.sort(
                        np.concatenate([keep_idx * 2, keep_idx * 2 + 1])
                    )
                    haps = haps[rows]
                    names = [names[i] for i in keep_idx]
                order = np.argsort(pos, kind="stable")
                chrom_out = region_chrom
                if not chrom_out:
                    for line in bgzf_open(path):
                        if not line.startswith("#"):
                            chrom_out = line.split("\t", 1)[0]
                            break
                print_message(
                    f"Read panel VCF (native): {haps.shape[0]} haplotypes x "
                    f"{haps.shape[1]} SNPs ({n_skip} skipped)"
                )
                return PanelVCF(
                    chrom=chrom_out or "",
                    pos=pos[order],
                    ref_allele=ref[order],
                    alt_allele=alt[order],
                    haps=haps[:, order],
                    sample_names=names,
                    n_skipped=n_skip,
                )
        except Exception as e:
            print_message(f"Native VCF path failed ({e}); using Python parser")
    sample_names: List[str] = []
    keep_idx: Optional[np.ndarray] = None
    pos_list: List[int] = []
    ref_list: List[str] = []
    alt_list: List[str] = []
    hap_rows: List[np.ndarray] = []
    chrom_seen: Optional[str] = None
    n_skipped = 0
    seen_pos = set()

    for line in bgzf_open(path):
        if line.startswith("##"):
            continue
        if line.startswith("#CHROM"):
            cols = line.rstrip("\n").split("\t")
            sample_names = cols[9:]
            mask = np.ones(len(sample_names), dtype=bool)
            if keep_samples is not None:
                keep = set(keep_samples)
                mask &= np.array([s in keep for s in sample_names])
            if exclude_samples is not None:
                exc = set(exclude_samples)
                mask &= np.array([s not in exc for s in sample_names])
            keep_idx = np.flatnonzero(mask)
            sample_names = [sample_names[i] for i in keep_idx]
            continue
        fields = line.rstrip("\n").split("\t", 9)
        if len(fields) < 10:
            continue
        chrom, pos_s, _, ref, alt = fields[0], fields[1], fields[2], fields[3], fields[4]
        if region_chrom is not None and chrom != region_chrom:
            continue
        pos = int(pos_s)
        if region_start is not None and pos < region_start:
            continue
        if region_end is not None and pos > region_end:
            continue
        if len(ref) != 1 or len(alt) != 1 or ref not in "ACGT" or alt not in "ACGT":
            n_skipped += 1
            continue
        if pos in seen_pos:
            n_skipped += 1
            continue
        gt_str = fields[9]
        alleles = _parse_gt_row(gt_str)
        if alleles is None:
            n_skipped += 1
            continue
        if keep_idx is not None and len(keep_idx) * 2 != len(alleles):
            alleles = alleles.reshape(-1, 2)[keep_idx].reshape(-1)
        seen_pos.add(pos)
        chrom_seen = chrom
        pos_list.append(pos)
        ref_list.append(ref)
        alt_list.append(alt)
        hap_rows.append(alleles)

    if not pos_list:
        raise ValueError(f"No usable variants found in {path}")
    haps = np.stack(hap_rows, axis=1)          # [K, nSNPs]
    order = np.argsort(np.asarray(pos_list, dtype=np.int64), kind="stable")
    print_message(
        f"Read panel VCF: {haps.shape[0]} haplotypes x {haps.shape[1]} SNPs "
        f"({n_skipped} skipped)"
    )
    return PanelVCF(
        chrom=chrom_seen or "",
        pos=np.asarray(pos_list, dtype=np.int64)[order],
        ref_allele=np.asarray(ref_list)[order],
        alt_allele=np.asarray(alt_list)[order],
        haps=haps[:, order],
        sample_names=sample_names,
        n_skipped=n_skipped,
    )


def _parse_gt_row(gt_str: str) -> Optional[np.ndarray]:
    """Parse the tab-joined genotype columns of one record into a flat
    haplotype allele vector (2 per sample). Fast path for uniform 'a|b'."""
    s = gt_str.rstrip("\n")
    n = (len(s) + 1) // 4
    if len(s) == 4 * n - 1:
        b = np.frombuffer(s.encode(), dtype=np.uint8)
        a1 = b[0::4]
        sep = b[1::4]
        a2 = b[2::4]
        if (
            len(a1) == n and len(a2) == n
            and ((sep == ord("|")) | (sep == ord("/"))).all()
        ):
            alle = np.empty(2 * n, dtype=np.uint8)
            alle[0::2] = a1 - ord("0")
            alle[1::2] = a2 - ord("0")
            if (alle <= 1).all():
                return alle
    # general path
    out: List[int] = []
    for fieldx in s.split("\t"):
        gt = fieldx.split(":", 1)[0]
        parts = gt.replace("|", "/").split("/")
        if len(parts) != 2:
            return None
        for p in parts:
            if p not in ("0", "1"):
                return None
            out.append(int(p))
    return np.asarray(out, dtype=np.uint8)


def read_genetic_map(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Genetic map file: 3 columns (position, rate cM/Mb, cM), optionally
    gzipped, with header (reference: maps/README.md:1-24)."""
    pos, cm = [], []
    for i, line in enumerate(bgzf_open(path)):
        parts = line.split()
        if i == 0 and not parts[0].isdigit():
            continue
        if len(parts) < 3:
            continue
        pos.append(int(float(parts[0])))
        cm.append(float(parts[2]))
    return np.asarray(pos, dtype=np.int64), np.asarray(cm, dtype=np.float64)


def read_posfile(path: str):
    """posfile: chr pos ref alt, tab separated, no header
    (reference QUILT.R posfile docs)."""
    chroms, pos, ref, alt = [], [], [], []
    for line in bgzf_open(path):
        p = line.split()
        if len(p) < 4:
            continue
        chroms.append(p[0])
        pos.append(int(p[1]))
        ref.append(p[2])
        alt.append(p[3])
    return (
        np.asarray(chroms), np.asarray(pos, dtype=np.int64),
        np.asarray(ref), np.asarray(alt),
    )


def read_genfile(path: str) -> Tuple[List[str], np.ndarray]:
    """genfile: header with sample names, then one row of diploid genotypes
    (0/1/2) per SNP."""
    rows = []
    names: List[str] = []
    for i, line in enumerate(bgzf_open(path)):
        parts = line.split()
        if i == 0:
            names = parts
            continue
        rows.append([int(float(x)) if x != "NA" else -1 for x in parts])
    gen = np.asarray(rows, dtype=np.int64)
    return names, np.where(gen < 0, np.nan, gen.astype(np.float64))


def read_phasefile(path: str) -> Tuple[List[str], np.ndarray]:
    """phasefile: header with sample names, then 'a|b' (or 'a|b|c' for NIPT)
    per sample per SNP. Returns [nSNPs, N, ploidy]."""
    names: List[str] = []
    rows = []
    for i, line in enumerate(bgzf_open(path)):
        parts = line.split()
        if i == 0:
            names = parts
            continue
        row = []
        for x in parts:
            row.append([float(v) if v != "." else np.nan
                        for v in x.split("|")])
        rows.append(row)
    return names, np.asarray(rows, dtype=np.float64)


def read_hap_legend(
    hap_file: str,
    legend_file: str,
    sample_file: str = "",
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
):
    """IMPUTE-format reference panel: .hap(.gz) 0/1 matrix (rows = SNPs,
    cols = haplotypes) + .legend(.gz) (id position a0 a1 header).

    The reference's alternative panel input path
    (quilt-prepare-reference.R:265-344 get_haplotypes_from_reference).
    Returns (pos, ref, alt, haps [K, nSNPs], sample_names).
    """
    pos_l, ref_l, alt_l, keep_rows = [], [], [], []
    for i, line in enumerate(bgzf_open(legend_file)):
        if i == 0:
            continue
        p = line.split()
        if len(p) < 4:
            continue
        position = int(p[1])
        inside = (
            (region_start is None or position >= region_start)
            and (region_end is None or position <= region_end)
        )
        keep_rows.append(inside)
        if inside:
            pos_l.append(position)
            ref_l.append(p[2])
            alt_l.append(p[3])
    rows = []
    r = 0
    for line in bgzf_open(hap_file):
        vals = line.split()
        if not vals:
            continue
        if r < len(keep_rows) and keep_rows[r]:
            rows.append(np.array(vals, dtype=np.uint8))
        r += 1
    haps = np.stack(rows, axis=1) if rows else np.zeros((0, 0), np.uint8)
    names: List[str] = []
    if sample_file:
        for i, line in enumerate(bgzf_open(sample_file)):
            if i == 0:
                continue
            p = line.split()
            if p:
                names.append(p[0])
    return (
        np.asarray(pos_l, dtype=np.int64),
        np.asarray(ref_l), np.asarray(alt_l), haps, names,
    )
