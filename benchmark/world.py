"""The benchmark's inputs, made from the seed with NumPy alone: the packed
panel, the truth haplotypes of each sample, and each sample's reads.

Frozen copies, so that a change to the program cannot move the yardstick:
- `fast_packed_panel`: quilt_tpu_torch/bench/common.py:fast_packed_panel;
- `packed_truth_mosaic`: quilt_tpu_torch/bench/common.py:packed_truth_mosaic;
- `simulate_reads` (`read_layout`, then `reads_of`): the draws of
  quilt_tpu_torch/io/simulate.py:simulate_sample_reads, returning plain
  arrays (each read's SNP indices and signed base qualities, sorted by
  central grid) instead of the program's read type.
`benchmark/tests/test_bm_world.py` holds each equal, bit for bit, to the
program's function at a small size. Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

SNPS_PER_GRID = 32


def fast_packed_panel(rng: np.random.Generator, K: int, nGrids: int, n_founders: int = 32,
                      switch: float = 0.02, mutation_per_bit: float = 0.008) -> np.ndarray:
    """Founder-mosaic panel [K, nGrids] uint32 in the 32-SNP packed form
    (bit b of word g is SNP 32 g + b): each haplotype copies one of
    n_founders random words a grid, switching founder with probability
    `switch` a grid, then a share mutation_per_bit of its bits flip."""
    founders = rng.integers(0, 1 << 32, size=(n_founders, nGrids), dtype=np.uint32)
    jumps = rng.integers(0, 1 << 16, size=(K, nGrids), dtype=np.uint16) \
        < int(switch * (1 << 16))
    jumps[:, 0] = True
    choice = rng.integers(0, n_founders, size=(K, nGrids), dtype=np.int8)
    idx = np.where(jumps, np.arange(nGrids, dtype=np.int32)[None, :], 0)
    np.maximum.accumulate(idx, axis=1, out=idx)
    founder_of = choice[np.arange(K)[:, None], idx]
    rhb_t = founders[founder_of, np.arange(nGrids)[None, :]]
    n_mut = int(K * nGrids * 32 * mutation_per_bit)
    mk = rng.integers(0, K, n_mut)
    mg = rng.integers(0, nGrids, n_mut)
    mb = rng.integers(0, 32, n_mut).astype(np.uint32)
    np.bitwise_xor.at(rhb_t, (mk, mg), np.uint32(1) << mb)
    return rhb_t


def packed_truth_mosaic(rng: np.random.Generator, rhb: np.ndarray, nSNPs: int,
                        n_latent: int = 2, switch_rate: float = 0.002) -> np.ndarray:
    """Truth haplotypes [n_latent, nSNPs] uint8 as mosaics of the packed
    panel's haplotypes, read from the words."""
    K = rhb.shape[0]
    s = np.arange(nSNPs)
    out = np.zeros((n_latent, nSNPs), dtype=np.uint8)
    for i in range(n_latent):
        jumps = rng.random(nSNPs) < switch_rate
        jumps[0] = True
        choice = rng.choice(np.arange(K), size=nSNPs)
        src = choice[np.maximum.accumulate(np.where(jumps, s, 0))]
        out[i] = (rhb[src, s >> 5] >> (s & 31).astype(np.uint32)) & np.uint32(1)
    return out


@dataclass
class Reads:
    """One sample's reads, sorted by central grid (the grid of the read's
    median SNP, stable): read r covers SNPs u[offsets[r]:offsets[r+1]] with
    signed base qualities bq (> 0: the alternate allele was read, < 0 the
    reference allele; |bq| the phred score)."""

    u: np.ndarray         # int32 [nBases]
    bq: np.ndarray        # int16 [nBases]
    offsets: np.ndarray   # int64 [nReads + 1]
    grid: np.ndarray      # int32 [nReads] central grid

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    def lists(self):
        """(per-read SNP indices, per-read base qualities)."""
        return ([self.u[a:b] for a, b in zip(self.offsets[:-1], self.offsets[1:])],
                [self.bq[a:b] for a, b in zip(self.offsets[:-1], self.offsets[1:])])


def read_layout(rng: np.random.Generator, pos: np.ndarray, coverage: float,
                read_length_bp: int, n_latent: int = 2):
    """Where a sample's reads lie and which truth haplotype each copies:
    (labels [n], starts [n]) for coverage * span / read_length_bp reads,
    each copying one of the n_latent haplotypes at random from a uniform
    start."""
    span = pos[-1] - pos[0] + 1
    n_reads = max(int(round(coverage * span / read_length_bp)), 1)
    labels = rng.choice(n_latent, size=n_reads, p=np.full(n_latent, 1.0 / n_latent))
    starts = rng.integers(pos[0], pos[-1] + 1, size=n_reads)
    return labels, starts


def reads_of(rng: np.random.Generator, truth: np.ndarray, pos: np.ndarray, labels, starts,
             read_length_bp: int, phred: int) -> Reads:
    """The reads of a layout from the truth haplotypes, each base misread
    with probability 10^(-phred/10); a read that covers no SNP is dropped.
    The base errors are drawn read after read, in one call."""
    eps = 10.0 ** (-phred / 10.0)
    starts = np.asarray(starts, dtype=np.int64)
    w0 = np.searchsorted(pos, starts)
    w1 = np.searchsorted(pos, starts + read_length_bp)
    keep = w1 > w0
    w0, lens, labels = w0[keep], (w1 - w0)[keep].astype(np.int64), np.asarray(labels)[keep]
    first = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=first[1:])
    read_of = np.repeat(np.arange(len(lens)), lens)
    u = (np.arange(first[-1]) - first[read_of] + w0[read_of]).astype(np.int32)
    alle = truth[labels[read_of], u]
    err = rng.random(len(u)) < eps
    obs = np.where(err, 1 - alle, alle)
    bq = np.where(obs == 1, phred, -phred).astype(np.int16)
    mid = u[first[:-1] + (lens - 1) // 2].astype(np.int64)
    grid = (mid // SNPS_PER_GRID).astype(np.int32)
    order = np.argsort(grid, kind="stable")
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens[order], out=offsets[1:])
    new_of = np.repeat(np.arange(len(order)), lens[order])
    take = np.arange(offsets[-1]) - offsets[new_of] + first[order][new_of]
    return Reads(u=u[take], bq=bq[take], offsets=offsets, grid=grid[order])


def simulate_reads(rng: np.random.Generator, truth: np.ndarray, pos: np.ndarray,
                   coverage: float, read_length_bp: int, phred: int) -> Reads:
    """Reads of one diploid sample at `coverage`, the layout and the base
    errors from one generator (the port's simulate_sample_reads' draws)."""
    labels, starts = read_layout(rng, pos, coverage, read_length_bp, truth.shape[0])
    return reads_of(rng, truth, pos, labels, starts, read_length_bp, phred)


def positions(config: Dict) -> np.ndarray:
    """SNP positions [nSNPs] int64: first_pos, then every snp_spacing_bp."""
    return (int(config["first_pos"])
            + np.arange(int(config["nSNPs"]), dtype=np.int64) * int(config["snp_spacing_bp"]))


@dataclass
class World:
    """The benchmark's inputs of one run: the panel, the SNP positions, and
    a pool of samples in batches (truth [2, nSNPs] and reads of each)."""

    rhb: np.ndarray               # uint32 [K, nGrids]
    pos: np.ndarray               # int64 [nSNPs]
    truths: List[np.ndarray]      # per pool sample
    reads: List[Reads]            # per pool sample
    sample_batch: int

    @property
    def batches(self) -> List[List[int]]:
        n = len(self.reads)
        return [list(range(i, min(i + self.sample_batch, n)))
                for i in range(0, n, self.sample_batch)]


def make_world(seed: int, config: Dict, traffic: Dict) -> World:
    """The world of `config` (panel and positions) and `traffic` (the pool
    of samples: pool_batches batches of sample_batch distinct samples at
    the mix's coverage, read length and base quality). The seed draws the
    panel, each sample's truth and its base errors; the read layouts (how
    many reads, where, from which haplotype) are the mix's own, drawn from
    its layout_seed, and the seed only orders them within each batch, so
    that every seed has the same sizes: the same seed gives the same world."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    nSNPs = int(config["nSNPs"])
    panel = config["panel"]
    rhb = fast_packed_panel(rng, int(config["K"]), nSNPs // SNPS_PER_GRID,
                            n_founders=int(panel["n_founders"]), switch=float(panel["switch"]),
                            mutation_per_bit=float(panel["mutation_per_bit"]))
    pos = positions(config)
    S, n_b = int(traffic["sample_batch"]), int(traffic["pool_batches"])
    lay_rng = np.random.default_rng(int(traffic["layout_seed"]))
    layouts = [read_layout(lay_rng, pos, float(traffic["coverage"]),
                           int(traffic["read_length_bp"])) for _ in range(S * n_b)]
    order = np.concatenate([b * S + rng.permutation(S) for b in range(n_b)])
    truths, reads = [], []
    for i in order:
        truth = packed_truth_mosaic(rng, rhb, nSNPs, 2, float(config["truth_switch_rate"]))
        truths.append(truth)
        reads.append(reads_of(rng, truth, pos, *layouts[i], int(traffic["read_length_bp"]),
                              int(traffic["phred"])))
    return World(rhb=rhb, pos=pos, truths=truths, reads=reads, sample_batch=S)
