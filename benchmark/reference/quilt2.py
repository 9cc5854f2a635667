"""Plain reference of what QUILT2 adds to a batch: the msPBWT selection of
the haplotype subsets and the Gibbs haplotype dosages that its output is
made of, written from the method (Li, Albrechtsen, Davies, bioRxiv 2024,
doi:10.1101/2024.07.18.604149; QUILT's R sources mspbwt.R:230-474,
select_new_haps_mspbwt_v3, and rare_common.R) in NumPy and plain PyTorch,
with the precision as a parameter: float64 is the reference, bfloat16 the
control. It imports nothing of the program; hmm.py gives the read tables,
read emissions and transitions QUILT1 shares.

- `common_tables`: a sample's all-SNP reads as the seek calls see them,
  the rare bases dropped (rare_common.R: the seek loop runs on the common
  SNPs).
- `DistinctHaps`: the distinct-haplotype table of each 32-SNP grid of the
  common panel and each haplotype's symbol there (QUILT's hapMatcher).
- `symbols`: (a) each grid's symbol of a rounded haplotype dosage.
- `false_matches`: (b) the reported long matches that are not matches of
  their stated length, at least mspbwtL grids, ending at their stated end.
- `approach_a`, `missed_checkpoints`: (c) the matches approach A
  reports at the indices' checkpoint columns, by brute force (the PBWT
  order, the query's insertion point, its neighbours), the longest match
  ending at each checkpoint, and the checkpoints where the scan reported
  none as long.
- `select_rows`: (d) the ranking, interleave and random fill from the
  reported matches, the retained subsets and the generator's state.
- `gibbs_hap_dosages`: (e) the haplotype dosages of a Gibbs call:
  forward-backward over the call's subset with its final labels.

Departures from the R sources, each the program's documented choice:
- a rounded word that no distinct haplotype of the grid carries takes the
  symbol of the Hamming-nearest row of the grid's table (first row on
  ties), where the R code gives it a symbol of its own; the table has
  nMaxDH rows, the ranked distinct words then words of 0 (rows no
  haplotype carries);
- haplotypes whose word is not among the grid's nMaxDH most frequent carry
  symbol 0 (QUILT's escapes);
- matches are looked for at the indices' checkpoint columns alone
  (approach A), among max(mspbwtM, 4) neighbours a side of the insertion
  point (panel/mspbwt.py's "at least M");
- the ranking visits matches longest first, ties in the order reported
  (R's `order` is stable too).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import hmm

SNPS_PER_GRID = 32
N_MAX_DH = 255


def no_tf32() -> None:
    """Matrix products in the precision asked for: TF32 off (it would
    round float32 operands to 10 bits of mantissa on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Reads on the common SNPs
# ---------------------------------------------------------------------------

def common_tables(u: np.ndarray, bq: np.ndarray, offsets: np.ndarray,
                  snp_is_common: np.ndarray, ref_error: float) -> hmm.SampleTables:
    """The read tables of a sample's all-SNP reads (u, bq, offsets) on the
    common axis: each read keeps its bases at common SNPs, renumbered among
    the common SNPs; a read with none is dropped; the reads are then
    ordered by their new central grid, stably."""
    common_index = np.cumsum(snp_is_common) - 1
    keep = snp_is_common[u]
    lens = np.diff(offsets)
    read_of = np.repeat(np.arange(len(lens)), lens)
    kept_len = np.bincount(read_of[keep], minlength=len(lens))
    reads = np.flatnonzero(kept_len > 0)
    cu = common_index[u[keep]]
    cbq = bq[keep]
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(kept_len, out=off[1:])
    mid = cu[off[reads] + (kept_len[reads] - 1) // 2]
    order = reads[np.argsort(mid // SNPS_PER_GRID, kind="stable")]
    new_u = np.concatenate([cu[off[r]:off[r + 1]] for r in order]) if len(order) else cu[:0]
    new_bq = np.concatenate([cbq[off[r]:off[r + 1]] for r in order]) if len(order) else cbq[:0]
    new_off = np.zeros(len(order) + 1, np.int64)
    np.cumsum(kept_len[order], out=new_off[1:])
    return hmm.sample_tables(new_u, new_bq, new_off, ref_error)


# ---------------------------------------------------------------------------
# Distinct haplotypes and symbols
# ---------------------------------------------------------------------------

class DistinctHaps:
    """Per grid of the packed common panel rhb [K, G] (uint32): the
    distinct words ranked by how many haplotypes carry them (ties by the
    word's value), the first n_max kept as the table [n_max, G] (int64,
    word 0 in the rows past the grid's distinct words), and each
    haplotype's symbol `hap` [K, G] uint8 on `device`: 1 + its word's rank,
    0 where the word is not kept."""

    def __init__(self, rhb: np.ndarray, device="cpu", n_max: int = N_MAX_DH):
        dev = torch.device(device)
        K, G = rhb.shape
        w = torch.as_tensor(rhb.astype(np.int64), device=dev)
        self.table = torch.zeros((n_max, G), dtype=torch.int64, device=dev)
        self.hap = torch.zeros((K, G), dtype=torch.uint8, device=dev)
        for g in range(G):
            uniq, inv, counts = torch.unique(w[:, g], return_inverse=True, return_counts=True)
            order = torch.sort(-counts, stable=True).indices       # uniq is ascending
            keep = order[:n_max]
            rank = torch.zeros(len(uniq), dtype=torch.int64, device=dev)
            rank[keep] = torch.arange(1, len(keep) + 1, device=dev)
            self.hap[:, g] = rank[inv].to(torch.uint8)
            self.table[:len(keep), g] = uniq[keep]


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit word (the sums of bit pairs,
    nibbles and bytes, then the bytes added by one product)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def symbols(hap_dos: np.ndarray, table: torch.Tensor, nSNPs: int) -> np.ndarray:
    """(a) [..., G] uint8 symbols of haplotype dosages [..., >= nSNPs]: per
    grid, the alleles with dosage above 0.5 as a word, then 1 + the row of
    the grid's table nearest it in Hamming distance, the first on ties."""
    dev = table.device
    n_max, G = table.shape
    lead = hap_dos.shape[:-1]
    a = np.zeros(lead + (G * SNPS_PER_GRID,), np.int64)
    a[..., :nSNPs] = np.asarray(hap_dos)[..., :nSNPs] > 0.5
    words = (a.reshape(lead + (G, SNPS_PER_GRID)) << np.arange(SNPS_PER_GRID)).sum(-1)
    wt = torch.as_tensor(words.reshape(-1, G), device=dev)              # [R, G]
    ham = _popcount(wt[:, None, :] ^ table[None, :, :])                 # [R, n_max, G]
    z = ham.argmin(1) + 1                                               # first minimum
    return z.to(torch.uint8).cpu().numpy().reshape(lead + (G,))


# ---------------------------------------------------------------------------
# Long matches
# ---------------------------------------------------------------------------

def false_matches(z: np.ndarray, matches: Sequence[Tuple[int, int, int]], hap_idx: np.ndarray,
                  min_length: int) -> int:
    """(b) How many reported matches (hap, end column, length) of the query
    symbols z [T] are not matches: shorter than min_length, or the hap's
    symbols hap_idx [K, T] differ from z somewhere in the stated span, or
    agree one column before it (the match is longer than stated)."""
    bad = 0
    for k, end, L in matches:
        s = end - L + 1
        if L < min_length or s < 0 or end >= len(z):
            bad += 1
            continue
        if not np.array_equal(hap_idx[k, s:end + 1], z[s:end + 1]):
            bad += 1
        elif s > 0 and hap_idx[k, s - 1] == z[s - 1]:
            bad += 1
    return bad


def approach_a(Z: np.ndarray, hap_idx: torch.Tensor, cp_cols: Sequence[int], min_length: int,
               scan: int) -> Tuple[List[List[Tuple[int, int, int]]], np.ndarray]:
    """(c) What approach A reports for the queries Z [Q, T] against the
    haplotypes' symbols hap_idx [K, T] (on the device), by brute force,
    and the longest match ending at each checkpoint column over every
    haplotype ([Q, len(cp_cols)]). At checkpoint column t the haplotypes
    stand in PBWT order: sorted by their symbols at t, t - 1, ..., 0, then
    by index. The query's insertion point p is the number of haplotypes
    whose symbols, read backward from t, sort below the query's (at the
    last column where they differ, the haplotype's symbol is the smaller).
    The haplotypes at positions p - scan .. p + scan - 1 are reported,
    with their backward match at t, where it is at least min_length. A
    haplotype's matches from one start are kept once, at their longest, as
    (hap, end, length). The longest match at t sits next to p, so it is
    among them."""
    dev = hap_idx.device
    Zt = torch.as_tensor(np.asarray(Z, np.uint8), device=dev)
    Q, T = Zt.shape
    K = hap_idx.shape[0]
    cps = [int(c) for c in cp_cols]
    order = torch.arange(K, device=dev)
    run = torch.zeros((Q, K), dtype=torch.int32, device=dev)
    below = torch.zeros((Q, K), dtype=torch.bool, device=dev)
    offs = torch.arange(-scan, scan, device=dev)
    found: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(Q)]
    longest = np.zeros((Q, len(cps)), np.int64)
    for t in range(T):
        col = hap_idx[:, t]
        order = order[torch.sort(col[order].to(torch.int32), stable=True).indices]
        eq = col[None, :] == Zt[:, t, None]
        run = torch.where(eq, run + 1, 0)
        below = torch.where(eq, below, col[None, :] < Zt[:, t, None])
        if t not in cps:
            continue
        longest[:, cps.index(t)] = run.amax(1).cpu().numpy()
        pos = below.sum(1, dtype=torch.int64)[:, None] + offs              # [Q, 2 scan]
        ok = (pos >= 0) & (pos < K)
        hap = order[pos.clamp(0, K - 1)]
        length = run.gather(1, hap).tolist()
        hap, ok = hap.tolist(), ok.tolist()
        for q in range(Q):
            for k, L, o in zip(hap[q], length[q], ok[q]):
                if o and L >= min_length:
                    key = (k, t - L + 1)
                    found[q][key] = max(found[q].get(key, 0), L)
    return [[(k, s + L - 1, L) for (k, s), L in f.items()] for f in found], longest


def missed_checkpoints(longest: np.ndarray, cp_cols: Sequence[int],
                       matches: Sequence[Sequence[Tuple[int, int, int]]], min_length: int
                       ) -> Tuple[int, int]:
    """(c) (columns, missed): over every query q and checkpoint column
    cp_cols[j] where the longest match ending there, longest[q, j]
    (approach_a), is at least min_length, how many there are, and at how
    many of them no reported match (hap, end, length) of q starts where
    that longest match starts and runs through the column (it ends there,
    or at a later checkpoint where the same match runs on)."""
    cols = missed = 0
    for q, lst in enumerate(matches):
        spans = [(e - L + 1, e) for _, e, L in lst]
        for j, t in enumerate(cp_cols):
            ell = int(longest[q, j])
            if ell < min_length:
                continue
            cols += 1
            s = int(t) - ell + 1
            missed += not any(a == s and e >= t for a, e in spans)
    return cols, missed


# ---------------------------------------------------------------------------
# Ranking, interleave and fill
# ---------------------------------------------------------------------------

def rank_by_coverage(matches: Sequence[Tuple[int, int, int, int]], T: int) -> List[int]:
    """mspbwt.R:414-441: the matches (hap, start, end, length), longest
    first, each weighted by its length over the sum of a coverage count
    over its span (1 at first, one more for each match visited over it);
    the haps by weight, largest first (ties in visiting order)."""
    visit = sorted(range(len(matches)), key=lambda i: -matches[i][3])
    cover = np.ones(T + 1)
    weight = []
    for i in visit:
        hap, s, e, L = matches[i]
        weight.append(L / cover[s:e + 1].sum())
        cover[s:e + 1] += 1
    by = sorted(range(len(visit)), key=lambda j: -weight[j])
    return [matches[visit[j]][0] for j in by]


def interleave(ranked: Sequence[Sequence[int]], Knew: int, K: int, retained,
               rng: np.random.Generator) -> np.ndarray:
    """mspbwt.R:443-473: the latent haps' ranked lists taken in turn, one
    new hap from each list a turn (not chosen yet, not retained), until
    Knew are chosen or a whole turn adds none; then the rest drawn at
    random, without replacement, from the haps neither chosen nor
    retained."""
    chosen: List[int] = []
    taken = set(int(k) for k in np.asarray(retained).tolist())
    pos = [0] * len(ranked)
    while len(chosen) < Knew:
        added = False
        for h, lst in enumerate(ranked):
            if len(chosen) >= Knew:
                break
            while pos[h] < len(lst):
                k = int(lst[pos[h]])
                pos[h] += 1
                if k not in taken:
                    chosen.append(k)
                    taken.add(k)
                    added = True
                    break
        if not added:
            break
    if len(chosen) < Knew:
        pool = np.setdiff1d(np.arange(K), np.array(sorted(taken), dtype=np.int64))
        chosen += rng.choice(pool, size=Knew - len(chosen), replace=False).tolist()
    return np.asarray(chosen, dtype=np.int64)


def select_rows(matches: Sequence[Sequence[Tuple[int, int, int]]], n_latent: int, T: int,
                Knew: int, K: int, retained: Sequence[np.ndarray], rng_state: Dict
                ) -> List[np.ndarray]:
    """(d) Each row's new haps: matches[q] the reported (hap, end, length)
    of query q = row * n_latent + latent hap, over every index in turn;
    the rows in order share one generator, started from rng_state."""
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    out = []
    for r in range(len(retained)):
        ranked = [rank_by_coverage([(k, e - L + 1, e, L) for k, e, L in matches[r * n_latent + h]],
                                   T) for h in range(n_latent)]
        out.append(interleave(ranked, Knew, K, retained[r], rng))
    return out


# ---------------------------------------------------------------------------
# The Gibbs haplotype dosages
# ---------------------------------------------------------------------------

def gibbs_hap_dosages(tables: Sequence[hmm.SampleTables], rhb: np.ndarray, haps: np.ndarray,
                      labels: Sequence[np.ndarray], stay: np.ndarray, jump: np.ndarray,
                      max_diff: float, ref_error: float, nSNPs: int, nl: int = 2,
                      dtype=torch.float64, device="cpu") -> np.ndarray:
    """(e) [N, nl, nSNPs] haplotype dosages of N chains after a Gibbs call,
    chain i over its own sample's reads tables[i], its subset haps[i] [K]
    (panel indices into the packed panel rhb) and its final labels
    labels[i] [nReads]: latent haplotype h copies a path through the K
    haplotypes, grid g emitting the product of the emissions of the reads
    of grid g labelled h; gamma = alpha beta normalised (the jump into grid
    g lands on any haplotype alike, stay_g keeps the path); the dosage of
    SNP s is eps + (1 - 2 eps) sum_k gamma_k allele_k(s), eps = ref_error."""
    no_tf32()
    dev = torch.device(device)
    N, K = haps.shape
    G = len(stay)
    lemg = torch.zeros((N, nl, G, K), dtype=dtype, device=dev)
    for i, t in enumerate(tables):
        le, _ = hmm.read_log_emissions(t, rhb, haps[i], max_diff, dev, as_numpy=False)
        lab = torch.as_tensor(np.asarray(labels[i], np.int64)[:t.n_reads], device=dev)
        grid = torch.as_tensor(t.grid, device=dev)
        for h in range(nl):
            w = (lab == h).to(torch.float64)
            acc = torch.zeros((G, K), dtype=torch.float64, device=dev)
            acc.index_add_(0, grid, (le * w[None, :]).T)
            lemg[i, h] = acc.to(dtype)
    st = torch.as_tensor(stay, dtype=dtype, device=dev)
    jp = torch.as_tensor(jump, dtype=dtype, device=dev)

    def e(g):
        x = lemg[:, :, g]
        return torch.exp(x - x.amax(-1, keepdim=True))

    alphas = torch.empty((G, N, nl, K), dtype=dtype, device=dev)
    alpha = None
    for g in range(G):
        a = e(g) / K if g == 0 else e(g) * (st[g] * alpha + jp[g] / K)
        alpha = a / a.sum(-1, keepdim=True)
        alphas[g] = alpha
    words = torch.as_tensor(rhb[haps].view(np.int32), device=dev)            # [N, K, G]
    sh = torch.arange(SNPS_PER_GRID, device=dev, dtype=torch.int32)
    out = torch.empty((N, nl, G * SNPS_PER_GRID), dtype=torch.float64, device=dev)
    beta = torch.ones((N, nl, K), dtype=dtype, device=dev)
    for g in range(G - 1, -1, -1):
        gam = alphas[g] * beta
        gam = gam / gam.sum(-1, keepdim=True)
        bits = ((words[:, :, g, None] >> sh) & 1).to(dtype)                  # [N, K, 32]
        out[:, :, g * SNPS_PER_GRID:(g + 1) * SNPS_PER_GRID] = (
            ref_error + (1 - 2 * ref_error) * torch.bmm(gam, bits)).to(torch.float64)
        if g:
            eb = e(g) * beta
            beta = st[g] * eb + jp[g] / K * eb.sum(-1, keepdim=True)
            beta = beta / beta.amax(-1, keepdim=True)
    return out[:, :, :nSNPs].cpu().numpy()
