"""Synthetic data simulators for tests and benchmarks.

Fills the role of STITCH::make_acceptance_test_data_package /
make_reference_package and QUILT's fixture generators
make_quilt_fb_test_package / make_reference_single_test_package (reference:
QUILT/R/test-drivers.R:127-462): fabricate a phased panel with LD structure,
truth samples as panel mosaics, and low-coverage reads with base errors —
no files required.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .reads import SampleReads, snap_reads_to_grid


@dataclass
class SimTruth:
    haps: np.ndarray          # [n_latent, nSNPs] 0/1 truth haplotypes
    labels: np.ndarray        # [nReads] 0-based latent hap of each read
    ff: float = 0.0           # fetal fraction (nipt)


def simulate_panel(
    rng: np.random.Generator,
    K: int = 200,
    nSNPs: int = 512,
    n_founders: int = 12,
    switch_rate: float = 0.01,
    region_span: int = 1_000_000,
    mutation: float = 0.002,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate a phased reference panel with LD.

    Founder haplotypes are iid Bernoulli(af) with af ~ Beta(0.4, 0.4); panel
    haps are founder mosaics with per-SNP switch probability switch_rate plus
    light mutation. Returns (haps uint8 [K, nSNPs], pos int64 [nSNPs]).
    """
    af = rng.beta(0.4, 0.4, size=nSNPs)
    af = np.clip(af, 0.02, 0.98)
    founders = (rng.random((n_founders, nSNPs)) < af).astype(np.uint8)
    # mosaic copy chains
    jumps = rng.random((K, nSNPs)) < switch_rate
    jumps[:, 0] = True
    choice = rng.integers(0, n_founders, size=(K, nSNPs))
    idx = np.where(jumps, np.arange(nSNPs)[None, :], 0)
    idx = np.maximum.accumulate(idx, axis=1)
    founder_of = choice[np.arange(K)[:, None], idx]
    haps = founders[founder_of, np.arange(nSNPs)[None, :]]
    # light mutation
    mut = rng.random((K, nSNPs)) < mutation
    haps = np.where(mut, 1 - haps, haps).astype(np.uint8)
    pos = np.sort(rng.choice(region_span, size=nSNPs, replace=False)) + 1
    return haps, pos.astype(np.int64)


def simulate_truth_mosaic(
    rng: np.random.Generator,
    panel_haps: np.ndarray,
    n_latent: int = 2,
    switch_rate: float = 0.002,
    exclude: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Truth haplotypes as mosaics of panel haplotypes."""
    K, nSNPs = panel_haps.shape
    pool = np.setdiff1d(np.arange(K), exclude) if exclude is not None else np.arange(K)
    out = np.zeros((n_latent, nSNPs), dtype=np.uint8)
    for i in range(n_latent):
        jumps = rng.random(nSNPs) < switch_rate
        jumps[0] = True
        choice = rng.choice(pool, size=nSNPs)
        idx = np.where(jumps, np.arange(nSNPs), 0)
        idx = np.maximum.accumulate(idx)
        out[i] = panel_haps[choice[idx], np.arange(nSNPs)]
    return out


def simulate_sample_reads(
    rng: np.random.Generator,
    truth_haps: np.ndarray,
    pos: np.ndarray,
    grid: np.ndarray,
    coverage: float = 1.0,
    read_length_bp: int = 300,
    phred: int = 25,
    ff: float = 0.0,
) -> Tuple[SampleReads, SimTruth]:
    """Simulate reads from truth haplotypes.

    For diploid (truth_haps has 2 rows) each read picks a hap uniformly; for
    NIPT (3 rows: maternal transmitted / maternal untransmitted / paternal
    fetal) with priors (0.5, (1-ff)/2, ff/2) (reference:
    QUILT/R/functions.R:586).
    """
    n_latent, nSNPs = truth_haps.shape
    span = pos[-1] - pos[0] + 1
    n_reads = max(int(round(coverage * span / read_length_bp)), 1)
    if n_latent == 2:
        probs = np.array([0.5, 0.5])
    else:
        probs = np.array([0.5, (1 - ff) / 2, ff / 2])
    labels = rng.choice(n_latent, size=n_reads, p=probs)
    starts = rng.integers(pos[0], pos[-1] + 1, size=n_reads)
    eps = 10.0 ** (-phred / 10.0)
    us: List[np.ndarray] = []
    bqs: List[np.ndarray] = []
    kept_labels = []
    for r in range(n_reads):
        lo, hi = starts[r], starts[r] + read_length_bp
        w = np.searchsorted(pos, [lo, hi])
        if w[1] <= w[0]:
            continue
        u = np.arange(w[0], w[1], dtype=np.int32)
        alle = truth_haps[labels[r], u]
        err = rng.random(len(u)) < eps
        obs = np.where(err, 1 - alle, alle)
        bq = np.where(obs == 1, phred, -phred).astype(np.int16)
        us.append(u)
        bqs.append(bq)
        kept_labels.append(labels[r])
    reads = SampleReads.from_lists(us, bqs, grid)
    snap_reads_to_grid(reads, grid)
    # sort by grid and keep labels aligned
    order = np.argsort(reads.wif0, kind="stable")
    reads = reads.subset(order)
    labels_sorted = np.asarray(kept_labels, dtype=np.int8)[order]
    return reads, SimTruth(haps=truth_haps, labels=labels_sorted, ff=ff)
