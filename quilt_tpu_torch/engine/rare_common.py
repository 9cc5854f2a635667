"""Rare/common two-stage imputation (QUILT2 impute_rare_common): the seek
loop runs on common SNPs; one final all-SNP Gibbs call per chain batch
adds the rare sites.

restrict_reads_to_common and initial_all_snp_labels are copies of
quilt_tpu/engine/rare_common.py:20-41 and :73-105. all_snp_panel_device
takes the place of its per-call build_subset_bits_all (:44-70): the
all-SNP panel is packed once per region, on the region's device, so each
all-SNP Gibbs call gathers its subset words there (gather_words) instead
of inflating a [B, Ksub, nSNPs_all] byte tensor on the host.
all_snp_panel, the same words built on the host through an unpacked
[K, nGrids_all * 32] byte matrix, is its plain version (the tests hold
the two equal).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..io.reads import SampleReads, bq_to_probs
from ..utils import pack_bits_32, unpack_bits_32


def restrict_reads_to_common(reads_all: SampleReads, snp_is_common: np.ndarray,
                             grid_common: np.ndarray) -> SampleReads:
    """Project all-SNP reads onto the common-SNP axis (drop rare bases)."""
    common_new_index = np.cumsum(snp_is_common) - 1
    keep_base = snp_is_common[reads_all.u]
    us: List[np.ndarray] = []
    bqs: List[np.ndarray] = []
    for r in range(reads_all.nReads):
        s, e = reads_all.offsets[r], reads_all.offsets[r + 1]
        kb = keep_base[s:e]
        if not kb.any():
            continue
        us.append(common_new_index[reads_all.u[s:e][kb]].astype(np.int32))
        bqs.append(reads_all.bq[s:e][kb])
    return SampleReads.from_lists(us, bqs, grid_common).sorted_by_grid()


def all_snp_panel(rhb_t_common: np.ndarray, snp_is_common: np.ndarray,
                  rare_per_hap_info: List[np.ndarray], nGrids_all: int) -> np.ndarray:
    """Packed all-SNP panel [K, nGrids_all] int32: each haplotype's common
    alleles at their all-SNP positions, its rare carrier sites set
    (reference: rare_common.R:1-56, the small eHaps of the final Gibbs).
    Row k gathered for a subset equals build_subset_bits_all's row packed."""
    K = rhb_t_common.shape[0]
    bits = np.zeros((K, nGrids_all * 32), dtype=np.uint8)
    bits[:, np.flatnonzero(snp_is_common)] = unpack_bits_32(
        rhb_t_common, int(snp_is_common.sum()))
    lens = [len(x) for x in rare_per_hap_info]
    if sum(lens):
        bits[np.repeat(np.arange(K), lens),
             np.concatenate([np.asarray(x, dtype=np.int64) for x in rare_per_hap_info])] = 1
    return pack_bits_32(bits).view(np.int32)


def all_snp_panel_device(rhb_common: torch.Tensor, snp_is_common: np.ndarray,
                         rare_per_hap_info: List[np.ndarray], nGrids_all: int,
                         chunk_bytes: int = 1 << 30) -> torch.Tensor:
    """all_snp_panel on the device of rhb_common (the common SNPs' packed
    words [K, nGrids] int32, there already): [K, nGrids_all] int32 equal
    word for word, built a chunk of all-SNP grids at a time so that the
    chunk's int64 words and bits stay within chunk_bytes. Each common bit
    is read from its word and shifted to its all-SNP place; each rare
    carrier adds 1 << its bit. The (haplotype, SNP) pairs are distinct and
    no rare SNP is common, so every add sets a bit that is still clear and
    the sum is the OR; the int64 words (bit 31 included) then wrap to
    int32."""
    dev = rhb_common.device
    K = rhb_common.shape[0]
    nSNPs_all = len(snp_is_common)
    # common index of each all-SNP place of the grid-padded axis, -1 where rare or pad
    src = np.full(nGrids_all * 32, -1, dtype=np.int64)
    src[np.flatnonzero(snp_is_common)] = np.arange(int(np.sum(snp_is_common)))
    src_t = torch.as_tensor(src, device=dev)
    lens = np.array([len(x) for x in rare_per_hap_info], dtype=np.int64)
    hap = np.repeat(np.arange(K, dtype=np.int64), lens)
    snp = (np.concatenate([np.asarray(x, dtype=np.int64) for x in rare_per_hap_info])
           if lens.sum() else np.zeros(0, np.int64))
    order = np.argsort(snp, kind="stable")
    hap_t = torch.as_tensor(hap[order], device=dev)
    snp_t = torch.as_tensor(snp[order], device=dev)
    cut = np.searchsorted(snp[order], np.arange(0, nGrids_all + 1) * 32)
    if snp.size and (snp.min() < 0 or snp.max() >= nSNPs_all):
        raise ValueError(f"a rare carrier's SNP lies outside the {nSNPs_all} all-SNP sites")
    out = torch.empty((K, nGrids_all), dtype=torch.int32, device=dev)
    step = max(1, int(chunk_bytes) // (K * 32 * 8))
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    for g0 in range(0, nGrids_all, step):
        g1 = min(nGrids_all, g0 + step)
        j = src_t[g0 * 32:g1 * 32].view(g1 - g0, 32)                 # [n, 32]
        jc = j.clamp(min=0)
        bits = (rhb_common[:, (jc >> 5).reshape(-1)].view(K, g1 - g0, 32).to(torch.int64)
                >> (jc & 31)) & 1
        bits = torch.where(j >= 0, bits, 0)                           # [K, n, 32]
        words = (bits << shifts).sum(-1)                              # [K, n] int64
        a, b = int(cut[g0]), int(cut[g1])
        if b > a:
            s = snp_t[a:b]
            words.view(-1).index_put_(((hap_t[a:b] * (g1 - g0)) + (s >> 5) - g0,),
                                      torch.ones_like(s) << (s & 31), accumulate=True)
        out[:, g0:g1] = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return out


def initial_all_snp_labels(reads_all: SampleReads, hap_dos_common: np.ndarray,
                           snp_is_common: np.ndarray, n_latent: int, ff: float,
                           rng: np.random.Generator) -> np.ndarray:
    """Draw starting labels for all-SNP reads from P(read | imputed hap)
    with rare positions uninformative (reference: rare_common.R:61-107)."""
    nSNPs_all = len(snp_is_common)
    hap_all = np.full((n_latent, nSNPs_all), 0.5)
    hap_all[:, snp_is_common] = hap_dos_common
    probs = bq_to_probs(reads_all.bq)
    e = hap_all[:, reads_all.u]
    term = e * probs[None, :, 1] + (1 - e) * probs[None, :, 0]
    logterm = np.log(np.maximum(term, 1e-300))
    read_of_base = np.repeat(np.arange(reads_all.nReads), np.diff(reads_all.offsets))
    lse = np.zeros((n_latent, reads_all.nReads))
    for h in range(n_latent):
        np.add.at(lse[h], read_of_base, logterm[h])
    lse -= lse.max(axis=0, keepdims=True)
    p = np.exp(lse)
    if n_latent == 3:
        p = p * np.array([0.5, (1 - ff) / 2, ff / 2])[:, None]
    p = p / p.sum(axis=0, keepdims=True)
    u = rng.random(reads_all.nReads)
    H = (np.cumsum(p, axis=0) <= u[None, :]).sum(axis=0)
    return np.minimum(H, n_latent - 1).astype(np.int32)
