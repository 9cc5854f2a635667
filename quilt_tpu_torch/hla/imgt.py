"""IPD-IMGT/HLA genomic alignment (`<GENE>_gen.txt`) parser.

Functional equivalent of the reference's
get_and_reformat_gen_alignments_for_hla_region
(QUILT/R/hla_prepare_functions.R:572-668), which whitespace-tokenizes the
IMGT alignment text: blocks start at "gDNA" markers; within a block each
allele row is a name token (GENE*...) followed by sequence chunk tokens.
Alignment characters: '-' = same as the first (reference) allele, '.' =
gap, '*' = unknown, '|' = exon/intron boundary marker columns.

Post-processing mirrors the reference exactly:
- '-' columns are replaced by the first allele's character;
- columns up to and including the first '|' of the reference row are
  trimmed (sequence before the CDS start), and all remaining '|' columns
  are dropped;
- negative-strand genes are reverse-complemented.

`db_from_imgt` converts the alignment into an HLAAlleleDB for the typing
pipeline; alignment gaps ('.') are filled from the reference allele and
unknowns ('*') become code 4 (documented deviation: the reference keeps
per-allele variable-length sequences plus lookup tables; the TPU typing
kernel wants a fixed [A, L] matrix).
"""
from __future__ import annotations

import re
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from .db import BASES, HLAAlleleDB, HLAGene

_COMP = str.maketrans("ACGT", "TGCA")


def _tokenize(text: str) -> List[str]:
    toks = text.split()
    # drop everything from the trailing "Please see http://..." footer on
    for i, t in enumerate(toks):
        if t.startswith("Please"):
            return toks[:i]
    return toks


def parse_imgt_gen_alignment(
    text: str, gene: str, strand: int = 1,
) -> Tuple[List[str], np.ndarray]:
    """Parse one `<gene>_gen.txt` alignment. Returns (allele_names,
    char matrix [A, L]) after reference-fill, CDS trim and stranding."""
    toks = _tokenize(text)
    name_re = re.compile(re.escape(gene) + r"\*")
    starts = [i for i, t in enumerate(toks) if t == "gDNA"]
    if not starts:
        raise ValueError(f"no gDNA blocks found for {gene}")
    bounds = starts + [len(toks)]
    names: List[str] = []
    seqs: dict = {}
    for k in range(len(starts)):
        lo, hi = bounds[k] + 2, bounds[k + 1]
        cur: Optional[str] = None
        block: dict = {}
        for t in toks[lo:hi]:
            if name_re.match(t):
                cur = t
                block.setdefault(cur, [])
                if k == 0 and cur not in seqs:
                    names.append(cur)
                    seqs[cur] = []
            elif cur is not None:
                block[cur].append(t)
        for nm, chunks in block.items():
            if nm in seqs:
                seqs[nm].append("".join(chunks))
    if not names:
        raise ValueError(f"no alleles matching {gene}* found")
    strs = ["".join(seqs[nm]) for nm in names]
    L = len(strs[0])
    # ragged rows (alleles absent from later blocks) pad with unknowns
    strs = [s.ljust(L, "*")[:L] for s in strs]
    mat = np.frombuffer(
        "".join(strs).encode(), dtype="S1"
    ).reshape(len(names), L).astype("U1")
    # '-' means "same as reference allele" (hla_prepare_functions.R:624)
    ref_row = mat[0]
    mat = np.where(mat == "-", ref_row[None, :], mat)
    # trim up to and including the reference row's first '|', drop '|' cols
    bar = np.flatnonzero(ref_row == "|")
    if len(bar):
        mat = mat[:, bar[0] + 1:]
    mat = mat[:, mat[0] != "|"]
    if strand != 1:
        flat = mat.copy()
        for a, b in zip("ACGT", "TGCA"):
            flat[mat == a] = b
        mat = flat[:, ::-1]
    return names, mat


def db_from_imgt(
    gene: HLAGene,
    allele_names: List[str],
    mat: np.ndarray,
    four_digit: bool = True,
) -> HLAAlleleDB:
    """Alignment matrix -> HLAAlleleDB over the gene span. Gaps take the
    reference allele's base; collapse to 4-digit allele resolution keeps
    the first (canonical, IMGT-ordered) representative of each 4-digit
    group, as the reference's downstream tables do."""
    ref_row = mat[0]
    mat = np.where(mat == ".", ref_row[None, :], mat)
    # drop columns where the reference itself is a gap
    keep = ref_row != "."
    mat = mat[:, keep]
    code = np.full(mat.shape, 4, dtype=np.uint8)
    for i, b in enumerate(BASES):
        code[mat == b] = i
    names = allele_names
    if four_digit:
        seen = {}
        for i, nm in enumerate(names):
            short = ":".join(nm.split(":")[:2])
            seen.setdefault(short, i)
        idx = sorted(seen.values())
        names = [":".join(names[i].split(":")[:2]) for i in idx]
        code = code[idx]
    L = gene.length
    if code.shape[1] >= L:
        code = code[:, :L]
    else:
        pad = np.full((code.shape[0], L - code.shape[1]), 4, dtype=np.uint8)
        code = np.concatenate([code, pad], axis=1)
    return HLAAlleleDB(gene=gene, allele_names=names, seqs=code)


def load_imgt_zip(
    zip_path: str, gene: HLAGene, strand: int = 1,
) -> HLAAlleleDB:
    """Load `alignments/<gene>_gen.txt` from the IPD-IMGT release zip (the
    reference's ipd_igmt_alignments_zip_file input,
    quilt-hla-prepare-reference.R:67-68)."""
    member = f"alignments/{gene.name}_gen.txt"
    with zipfile.ZipFile(zip_path) as zf:
        cands = [n for n in zf.namelist() if n.endswith(member)
                 or n.endswith(f"{gene.name}_gen.txt")]
        if not cands:
            raise FileNotFoundError(f"{member} not in {zip_path}")
        text = zf.read(cands[0]).decode(errors="replace")
    names, mat = parse_imgt_gen_alignment(text, gene.name, strand)
    return db_from_imgt(gene, names, mat)
