"""Haplotype re-selection between seek iterations, read confidence, and
the host-side consensus and recast helpers.

select_new_haps_device and read_confidence_device are torch versions of
quilt_tpu/engine/selection.py:63-150 (a torch.Generator replaces the jax
key), for the batched engine; select_new_haps_from_topk and
read_confidence are NumPy copies of :21 and :215, for the per-sample
engine and, through select_new_haps_host, the batched one's mesh path;
consensus_read_labels, recast_haps and recast_nipt_haps are NumPy copies
of :153-303 (their module imports jax).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def select_new_haps_from_topk(top_idx: np.ndarray, top_vals: np.ndarray, Knew: int, K: int,
                              previously_selected: np.ndarray, rng: np.random.Generator,
                              K_top_matches: int = 5) -> np.ndarray:
    """Pick Knew haplotypes from ranked top-match lists top_idx / top_vals
    [n_lists, K_top] (everything_select_good_haps, reference:
    QUILT/R/functions.R:2262-2310): all rank-1 matches, then rank-2, ...,
    outside the retained set; at the depth that overflows, a random subset;
    when the lists run out, every listed haplotype, then a random fill."""
    prev = set(previously_selected.tolist())
    keep: List[int] = []
    kept = set()
    depth_max = min(K_top_matches, top_idx.shape[1])
    for depth in range(depth_max):
        new = np.unique(top_idx[:, depth])
        new = [h for h in new.tolist() if h not in prev and h not in kept]
        room = Knew - len(keep)
        if len(new) < room:
            keep.extend(new)
            kept.update(new)
        else:
            chosen = rng.choice(len(new), size=room, replace=False)
            keep.extend(np.asarray(new)[chosen].tolist())
            kept.update(keep)
            break
    if len(keep) < Knew:
        allm = np.unique(top_idx)
        extra = [h for h in allm.tolist() if h not in prev and h not in kept]
        room = Knew - len(keep)
        keep.extend(extra[:room])
        kept.update(keep)
    if len(keep) < Knew:
        pool = np.setdiff1d(np.arange(K), np.asarray(sorted(kept | prev), dtype=np.int64))
        fill = rng.choice(pool, size=Knew - len(keep), replace=False)
        keep.extend(fill.tolist())
    return np.asarray(keep[:Knew], dtype=np.int64)


def _gather_topk_lists(tv, ti, thinned, n_latent, chain, K_top):
    """Per-chain ranked top-match lists [n_thin*n_latent, K_top] from the FB
    kernel's per-grid outputs (batch rows chain*n_latent + h); a copy of
    quilt_tpu/engine/sample.py:_gather_topk_lists."""
    rows_i = []
    rows_v = []
    for h in range(n_latent):
        b = chain * n_latent + h
        rows_i.append(ti[thinned, b, :])
        rows_v.append(tv[thinned, b, :])
    return np.concatenate(rows_i, axis=0), np.concatenate(rows_v, axis=0)


def select_new_haps_host(tv: np.ndarray, ti: np.ndarray, thinned: np.ndarray,
                         which: np.ndarray, rng: np.random.Generator, n_keep: int, Knew: int,
                         K: int, nl: int, K_top_matches: int) -> np.ndarray:
    """The host re-selection of every chain (the per-sample engine, and the
    batched one on the panel-sharded FB's merged lists): tv / ti [Gp, B *
    nl, width] top gammas and haplotype indices, thinned [n_thin] grids,
    which [B, Ksub] the current subsets. Per chain, n_keep of its subset
    kept at random and Knew new from its lists (select_new_haps_from_topk).
    Returns the new sorted subsets [B, Ksub]."""
    new_sets = np.empty_like(which)
    for c in range(which.shape[0]):
        prev_sel = rng.choice(which[c], size=n_keep, replace=False)
        li, lv = _gather_topk_lists(tv, ti, thinned, nl, c, tv.shape[2])
        new = select_new_haps_from_topk(li, lv, Knew, K, prev_sel, rng, K_top_matches)
        new_sets[c] = np.sort(np.concatenate([prev_sel, new]))
    return new_sets


def read_confidence(em_vs_haps: np.ndarray, minrp: float = 0.95) -> np.ndarray:
    """Which reads confidently belong to one haplotype, from P(read | final
    haplotype dosages) [n_latent, R] (reference:
    assess_ability_of_reads_to_be_confident, functions.R:1615-1660)."""
    if em_vs_haps.shape[0] == 2:
        p1, p2 = em_vs_haps
        with np.errstate(invalid="ignore", divide="ignore"):
            mp = p1 / (p1 + p2)
        mp = np.where(np.isfinite(mp), mp, 0.5)
        mp = np.where(mp < 0.5, 1 - mp, mp)
        return mp > minrp
    d = em_vs_haps.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = em_vs_haps / d
    mp = np.nanmax(np.where(np.isfinite(p), p, 1 / 3), axis=0)
    return mp > minrp


def select_new_haps_device(tv, ti, which, gen: torch.Generator, n_keep: int,
                           Knew: int, K: int, nl: int, K_top_matches: int):
    """Batched everything_select_good_haps (reference:
    QUILT/R/functions.R:2262-2310) on the device.

    tv/ti [nThin, B*nl, K_top] top gammas and haplotype indices at the
    thinned grids; which [B, Ksub] current subsets. Every panel haplotype
    gets a priority key: ranked candidates depth + intra-depth noise
    (depths past K_top_matches demoted behind all primary depths), untouched
    haplotypes a large random key (the random pool fill), the n_keep
    randomly retained haplotypes +inf; the Knew smallest keys win, the
    lowest index first among equal keys (the JAX top_k's order). Returns
    the new sorted subsets [B, Ksub]."""
    nThin, BN, K_top = tv.shape
    B = BN // nl
    Ksub = which.shape[1]
    dev = which.device
    perm_keys = torch.rand((B, Ksub), generator=gen, device=dev)
    order = torch.argsort(perm_keys, dim=1)[:, :n_keep]
    prev = which.gather(1, order)                                  # [B, n_keep]
    ti_b = ti.reshape(nThin, B, nl, K_top).permute(1, 2, 0, 3).reshape(B, nl * nThin, K_top)
    tv_b = tv.reshape(nThin, B, nl, K_top).permute(1, 2, 0, 3).reshape(B, nl * nThin, K_top)
    depth = torch.arange(K_top, dtype=torch.float32, device=dev)[None, None, :]
    demote = torch.where(depth < K_top_matches, 0.0, 1e4)
    noise = torch.rand(ti_b.shape, generator=gen, device=dev)
    cand_key = torch.where(tv_b > 0, depth + demote + noise, torch.inf).reshape(B, -1)
    cand = torch.clamp(ti_b, 0, K - 1).reshape(B, -1).long()
    pool = 1e6 + torch.rand((B, K), generator=gen, device=dev)
    keymat = pool.scatter_reduce(1, cand, cand_key, "amin")
    keymat = keymat.scatter(1, prev.long(), torch.inf)
    new = torch.sort(keymat, dim=1, stable=True).indices[:, :Knew]
    return torch.sort(torch.cat([prev, new.to(which.dtype)], 1), dim=1).values


def read_confidence_device(hap_dos, u_pad, lpr, lpa, nl: int, minrp: float = 0.95):
    """Which reads confidently belong to one latent haplotype, from the final
    per-chain haplotype dosages hap_dos [B, nl, S] and per-row reads
    u_pad/lpr/lpa [B, R, J] (reference:
    assess_ability_of_reads_to_be_confident, functions.R:1615-1660).
    Returns [B, R] bool."""
    B, R, J = u_pad.shape
    idx = u_pad.reshape(B, 1, R * J).long().expand(B, nl, R * J)
    e = hap_dos.gather(2, idx).reshape(B, nl, R, J)
    pR = torch.exp(lpr)[:, None]
    pA = torch.exp(lpa)[:, None]
    logp = torch.log(torch.clamp(e * pA + (1.0 - e) * pR, min=1e-30)).sum(3)
    em = torch.exp(logp - logp.amax(1, keepdim=True))
    p = em / torch.clamp(em.sum(1, keepdim=True), min=1e-30)
    return p.amax(1) > minrp


def consensus_read_labels(labels_all: np.ndarray, conf_all: np.ndarray) -> np.ndarray:
    """Cross-chain read-label consensus via confident-read flip detection
    (port of determine_best_read_label_so_far, reference:
    QUILT/R/functions.R:1680-1784): align chains at confident reads; where
    a minority of chains flips relative to the canonical chain, flip their
    suffix back; where a majority flips, flip the canonical chain's suffix.
    labels_all / conf_all [R, C]; labels are 0/1."""
    R, C = labels_all.shape
    can_hap = C - 1
    out = labels_all[:, can_hap].astype(np.int64).copy()
    idx = np.flatnonzero(conf_all.all(axis=1))
    if len(idx) < 10:
        return out
    a = labels_all[idx].astype(np.int64)
    can = a[:, can_hap].copy()
    d = a - can[:, None]
    rows_change = np.flatnonzero(np.diff(np.abs(d).sum(axis=1)) != 0)
    if len(rows_change) == 0:
        return out
    labels_work = labels_all.astype(np.int64).copy()
    starts = np.concatenate([[0], rows_change + 1])
    flip_cols_per_seg = []
    for i in range(1, len(starts)):
        s = starts[i]
        cur = d[s]
        changed = np.flatnonzero(cur != 0)
        w = slice(s, len(idx))
        if len(changed) == 0:
            flip_cols_per_seg.append((s, []))
            continue
        if len(changed) <= C / 2:
            # trust canonical: revert changed chains' suffixes
            for c1 in changed:
                reverted = 1 - (d[w, c1] + can[w])
                d[w, c1] = reverted - can[w]
            flip_cols_per_seg.append((s, changed.tolist()))
        else:
            changed = np.flatnonzero(cur == 0)
            for c1 in changed:
                reverted = 1 - (d[w, c1] + can[w])
                d[w, c1] = reverted - can[w]
            reverted_all = d[w] + can[w, None]
            can[w] = 1 - can[w]
            d[w] = reverted_all - can[w, None]
            flip_cols_per_seg.append((s, changed.tolist()))
    # apply flips to the full label matrix from each segment start onwards
    for s, cols in flip_cols_per_seg:
        full_start = idx[s]
        for c1 in cols:
            labels_work[full_start:, c1] = 1 - labels_work[full_start:, c1]
    return labels_work[:, can_hap]


def recast_haps(hd1: np.ndarray, hd2: np.ndarray, gp: np.ndarray):
    """Force phased haplotype dosages to agree with the genotype posterior
    argmax (reference: recast_haps, functions.R:3180-3209); gp [3, nSNPs]."""
    hd1 = hd1.copy()
    hd2 = hd2.copy()
    gt1 = np.round(hd1) + np.round(hd2)
    gt3 = gp.argmax(axis=0)
    ch = gt3 != gt1
    w0 = ch & (gt3 == 0)
    hd1[w0] = 0.0
    hd2[w0] = 0.0
    w2 = ch & (gt3 == 2)
    hd1[w2] = 1.0
    hd2[w2] = 1.0
    w1 = ch & (gt3 == 1)
    gtr = hd1[w1] > hd2[w1]
    hd1[w1] = np.where(gtr, 1.0, 0.0)
    hd2[w1] = np.where(gtr, 0.0, 1.0)
    return hd1, hd2


def recast_nipt_haps(hap1: np.ndarray, hap2: np.ndarray, hap3: np.ndarray,
                     mat_gp: np.ndarray, fet_gp: np.ndarray):
    """NIPT variant: make the 3 phased haplotypes agree with the maternal and
    fetal genotype posteriors (reference: recast_nipt_haps,
    functions.R:3214-3288)."""
    hap1, hap2, hap3 = hap1.copy(), hap2.copy(), hap3.copy()
    gtM = mat_gp.argmax(axis=0)
    gtF = fet_gp.argmax(axis=0)
    conv = [
        (0, 0, 0, 0, 0), (0, 1, 0, 0, 1), (0, 2, 0, 0, 1), (1, 0, 0, 1, 0),
        (1, 2, 1, 0, 1), (2, 0, 1, 1, 0), (2, 1, 1, 1, 0), (2, 2, 1, 1, 1),
    ]
    for m, f, h1, h2, h3 in conv:
        w = (gtM == m) & (gtF == f)
        hap1[w] = h1
        hap2[w] = h2
        hap3[w] = h3
    w1 = (gtM == 1) & (gtF == 1)
    r1 = np.round(hap1[w1])
    r2 = np.round(hap2[w1])
    r3 = np.round(hap3[w1])
    case_a = (r1 == 1) & (r2 == 0) & (r3 == 0)
    case_b = (r1 == 0) & (r2 == 1) & (r3 == 1)
    other = ~case_a & ~case_b
    h1n = np.where(case_a, 1, np.where(case_b, 0, r1))
    h2n = np.where(case_a, 0, np.where(case_b, 1, r2))
    h3n = np.where(case_a, 0, np.where(case_b, 1, 1 - h1n))
    h3n = np.where(other, 1 - h1n, h3n)
    hap1[w1] = h1n
    hap2[w1] = h2n
    hap3[w1] = h3n
    return np.round(hap1), np.round(hap2), np.round(hap3)
