"""Per-sample read data: the `sampleReads` equivalent.

The reference stores, per read, (J, wif0, bq, u): number of covered SNPs - 1,
central grid, signed base qualities (negative => base supports the reference
allele), and 0-based SNP indices (reference: QUILT/R/gibbs-small.R:27-35;
SURVEY.md section 2.1). Here reads are flat CSR-style arrays, the natural form
both for host processing and for building padded device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SampleReads:
    """Flat read set for one sample.

    u/bq are concatenated per-read arrays; read r covers
    u[offsets[r]:offsets[r+1]]. bq is signed phred: bq > 0 means the base
    supports the alternate allele with error 10^(-bq/10); bq < 0 the
    reference allele with error 10^(bq/10).
    """

    u: np.ndarray         # int32 [nBases], SNP indices (0-based)
    bq: np.ndarray        # int16 [nBases], signed phred
    offsets: np.ndarray   # int64 [nReads+1]
    wif0: np.ndarray      # int32 [nReads], central grid (0-based)
    qname: Optional[np.ndarray] = None   # str [nReads], read names

    @property
    def nReads(self) -> int:
        return len(self.offsets) - 1

    def read(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.offsets[r], self.offsets[r + 1]
        return self.u[s:e], self.bq[s:e]

    def sorted_by_grid(self) -> "SampleReads":
        """Stable-sort reads by central grid (required by the Gibbs sweep)."""
        order = np.argsort(self.wif0, kind="stable")
        return self.subset(order)

    def subset(self, order: np.ndarray) -> "SampleReads":
        """Reads `order` (indices, in that order) as a new flat read set."""
        lens = np.diff(self.offsets)[order]
        new_off = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        # source base of each output base: its read's old start, shifted by
        # the base's place within the read
        src = (np.repeat(self.offsets[order] - new_off[:-1], lens)
               + np.arange(new_off[-1], dtype=np.int64))
        return SampleReads(
            u=self.u[src].astype(np.int32, copy=False),
            bq=self.bq[src].astype(np.int16, copy=False),
            offsets=new_off,
            wif0=self.wif0[order],
            qname=None if self.qname is None else self.qname[order],
        )

    @classmethod
    def from_lists(
        cls, us: List[np.ndarray], bqs: List[np.ndarray], grid: np.ndarray
    ) -> "SampleReads":
        offsets = np.zeros(len(us) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in us], out=offsets[1:])
        u = (
            np.concatenate(us).astype(np.int32)
            if us
            else np.zeros(0, dtype=np.int32)
        )
        bq = (
            np.concatenate(bqs).astype(np.int16)
            if bqs
            else np.zeros(0, dtype=np.int16)
        )
        rs = cls(
            u=u, bq=bq, offsets=offsets, wif0=np.zeros(len(us), dtype=np.int32)
        )
        snap_reads_to_grid(rs, grid)
        return rs


def snap_reads_to_grid(reads: SampleReads, grid: np.ndarray) -> None:
    """Set each read's central grid to the grid of its median covered SNP.

    Equivalent of STITCH snap_sampleReads_to_grid (used at
    QUILT/R/functions.R:295-298).
    """
    for r in range(reads.nReads):
        s, e = reads.offsets[r], reads.offsets[r + 1]
        if e > s:
            mid = reads.u[s + (e - s - 1) // 2]
            reads.wif0[r] = grid[mid]


def downsample_reads(
    reads: SampleReads,
    nSNPs: int,
    max_cov: float,
    rng: np.random.Generator,
) -> SampleReads:
    """Per-site downsampling to a coverage ceiling (downsampleToCov semantics,
    reference: QUILT.R flag downsampleToCov; applied in STITCH's BAM
    converter). Drops whole reads that push any site above max_cov."""
    cov = np.zeros(nSNPs, dtype=np.int32)
    keep = np.ones(reads.nReads, dtype=bool)
    order = rng.permutation(reads.nReads)
    for r in order:
        s, e = reads.offsets[r], reads.offsets[r + 1]
        sites = reads.u[s:e]
        if len(sites) and (cov[sites] >= max_cov).any():
            keep[r] = False
        else:
            cov[sites] += 1
    return reads.subset(np.flatnonzero(keep))


def bq_to_probs(bq: np.ndarray) -> np.ndarray:
    """Signed phred -> (pRef, pAlt) per base, [n, 2].

    Equivalent of STITCH::convertScaledBQtoProbs
    (semantics at QUILT/R/gibbs-small.R:27-35).
    """
    bq = np.asarray(bq, dtype=np.float64)
    out = np.empty((len(bq), 2), dtype=np.float64)
    neg = bq < 0
    eps_neg = 10.0 ** (bq[neg] / 10.0)
    out[neg, 0] = 1.0 - eps_neg
    out[neg, 1] = eps_neg / 3.0
    pos = bq > 0
    eps_pos = 10.0 ** (-bq[pos] / 10.0)
    out[pos, 0] = eps_pos / 3.0
    out[pos, 1] = 1.0 - eps_pos
    zero = bq == 0
    out[zero] = 0.25
    return out
