"""Multi-symbol PBWT over the distinct-haplotype symbol matrix.

Functional equivalent of the mspbwt package's index build + long-match query
used by QUILT2 (reference call sites: QUILT/R/mspbwt.R:29,106,159,284,297,323;
selection logic select_new_haps_mspbwt_v3, mspbwt.R:230-474).

Scalable design (round 2, replacing the O(T·K) full prefix matrices and
the O(T²)-cumprod query of round 1):

- The index stores, per column t of the interleaved grid subsequence:
  * `Y[t]`   — the symbol sequence in PBWT (prefix-sorted) order, uint8
               [T, K]: the rank structure. One count_nonzero over a slice
               gives the query's next insertion position in O(K) bytes
               scanned (vectorized), no prefix matrix needed.
  * `C[t]`   — exclusive per-symbol bucket offsets [T, 257] int32.
  * checkpoint columns every `egs` steps keep the full positional prefix
    array A (int32 [n_cp, K]) for haplotype-identity recovery — the
    reference's `list_of_columns_of_A` RAM trick (build_mspbwt_indices,
    mspbwt.R:38-52; the reference likewise drops its divergence arrays,
    `out[["d"]] <- matrix(1L,1,1)`, mspbwt.R:37).
  Memory per index ≈ K·T·(1 + 4/egs) bytes vs round 1's 4·K·T.

- Query (`match_z`): one forward scan tracks the insertion point p[t]
  (C-offset + one masked count per column). At each checkpoint the up/down
  neighbours of p in A are candidate long matches (the reference's
  approach-A reporting at strided structure points / approach-B up-down
  scan, Rcpp_find_good_matches_without_a / Rcpp_ms_MatchZ_Algorithm5);
  their backward match lengths come from one vectorized suffix-run
  comparison over ≤ 2·scan candidate rows — O(scan·t) per checkpoint,
  never O(T²) in the panel.

- Selection (`select_new_haps_mspbwt`) reproduces the reference's
  coverage-weighted ranking: matches per latent hap are visited in
  length-descending order and weighted len/Σ cur_sum[start..end] with
  cur_sum incremented over the covered span (mspbwt.R:414-441), then the
  per-hap ranked lists interleave round-robin and dedupe (mspbwt.R:443-473).

- `mspbwtM` sets the number of neighbours scanned on each side of the
  insertion point (≥M match candidates per side per checkpoint);
  `mspbwtL` is the minimum match length in index grids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import unpack_bits_32


@dataclass
class MsIndex:
    grids: np.ndarray        # int32 [T] grid indices covered by this index
    Y: np.ndarray            # uint8 [T, K] symbols in PBWT order
    C: np.ndarray            # int32 [T, 257] exclusive bucket offsets
    cp_cols: np.ndarray      # int32 [n_cp] columns t with A checkpoint AFTER t
    A_cp: np.ndarray         # int32 [n_cp, K] prefix arrays at checkpoints
    egs: int = 32
    # occurrence lists: occ[t, C[t,s]:C[t,s+1]] = increasing positions of
    # symbol s in Y[t]. Gives the O(log K) insertion-point update of the
    # reference's Algorithm-5 occurrence structures (mspbwt
    # Rcpp_ms_BuildIndices_Algorithm5, used at mspbwt.R:29,106) instead of
    # an O(K) per-column count. None => rank via `planes` (large K) or the
    # O(K) scan.
    occ: Optional[np.ndarray] = None     # int32 [T, K]
    # bit-plane rank structure for UKB-scale K (replaces the r3
    # withhold-past-2GB occ gate): the uint8 symbol column packed as 8 bit
    # planes of 64-bit words, PLUS a x32-subsampled occurrence list (every
    # 32nd occurrence of each symbol, with per-symbol offsets C32). rank =
    # searchsorted over the subsample (locates the 32-occurrence window)
    # + popcount of the planes over the bounded window — O(log) + ~128
    # expected words, at (1 + 1/8) * T * K bytes vs occ's 4 * T * K.
    planes: Optional[np.ndarray] = None  # uint64 [T, 8, ceil(K/64)]
    occ32: Optional[np.ndarray] = None   # int32 [T, K//32 + 257]
    C32: Optional[np.ndarray] = None     # int32 [T, 257]


def _pack_planes(Y: np.ndarray) -> np.ndarray:
    """uint8 symbol columns [T, K] -> bit planes uint64 [T, 8, ceil(K/64)]
    (little-endian bit order: position k lives at word k//64, bit k%64)."""
    T, K = Y.shape
    W8 = (K + 63) // 64 * 8                        # bytes, 64-bit aligned
    planes = np.zeros((T, 8, W8), dtype=np.uint8)
    for b in range(8):
        bits = (Y >> b) & 1
        packed = np.packbits(bits, axis=1, bitorder="little")
        planes[:, b, : packed.shape[1]] = packed
    return planes.view(np.uint64).reshape(T, 8, W8 // 8)


def _rank_planes(planes_t: np.ndarray, s: int, p: int, a: int = 0) -> int:
    """#positions in [a, p) with symbol == s, from one column's planes."""
    if p <= a:
        return 0
    W0 = a >> 6
    W = p >> 6
    rem = p & 63
    nw = W + (1 if rem else 0)
    m = None
    for b in range(8):
        pb = planes_t[b, W0:nw]
        v = pb if (s >> b) & 1 else ~pb
        m = v if m is None else (m & v)
    m = m.copy()
    rem0 = a & 63
    if rem0:
        m[0] &= ~((np.uint64(1) << np.uint64(rem0)) - np.uint64(1))
    if rem:
        m[-1] &= (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
    return int(np.bitwise_count(m).sum())


def _subsampled_occ(Y: np.ndarray, C: np.ndarray, every: int = 32):
    """(occ32 [T, K//every + 257], C32 [T, 257]): positions of every
    `every`-th occurrence of each symbol per column, with per-symbol
    exclusive offsets into the row."""
    T, K = Y.shape
    cap = K // every + 257
    occ32 = np.zeros((T, cap), dtype=np.int32)
    C32 = np.zeros((T, 257), dtype=np.int32)
    ar = np.arange(K, dtype=np.int64)
    for t in range(T):
        order = np.argsort(Y[t], kind="stable")
        ys = Y[t][order]
        j_rel = ar - C[t][ys]
        mask = (j_rel % every) == 0
        vals = order[mask]
        cnt = np.bincount(ys[mask], minlength=256)
        C32[t, 1:] = np.cumsum(cnt)
        occ32[t, : len(vals)] = vals
    return occ32, C32


def build_mspbwt_indices(
    hapMatcher: np.ndarray, n_indices: int = 4, egs: Optional[int] = None,
    rank_mode: str = "auto",
) -> List[MsIndex]:
    """Build `n_indices` interleaved-grid msPBWT indices (index i covers
    grids i, i+n, i+2n, ... — reference build_mspbwt_indices,
    mspbwt.R:22-55). egs auto-selects like the reference (:17-21).

    rank_mode: "auto" = occurrence lists while they fit ~2 GB/index, bit
    planes past that (UKB-scale K keeps O(K/64)-word rank queries instead
    of the r3 O(K) scan fallback); "occ" / "planes" / "scan" force one.
    """
    K, nGrids = hapMatcher.shape
    n_indices = max(1, min(n_indices, nGrids))
    if egs is None:
        egs = 32 if K <= 100_000 else 100
    from ..io.native import native_available
    use_native = native_available()
    out = []
    for i in range(n_indices):
        grids = np.arange(i, nGrids, n_indices, dtype=np.int32)
        T = len(grids)
        # occ quadruples the index memory; past ~2 GB/index switch to the
        # bit-plane rank structure (T*K bytes)
        want_occ = rank_mode == "occ" or (
            rank_mode == "auto" and int(T) * int(K) * 4 <= 2 << 30
        )
        want_planes = rank_mode == "planes" or (
            rank_mode == "auto" and not want_occ
        )
        if use_native:
            # C++ build (quilt_io.cpp:qio_mspbwt_build): blocked subset
            # transpose + counting-sort loop — seconds at K=100k x 10k grids
            from ..io.native import mspbwt_build_native
            Y, C, cp_cols, A_cp, occ = mspbwt_build_native(
                hapMatcher, grids, egs, want_occ=want_occ
            )
            o32, C32 = _subsampled_occ(Y, C) if want_planes else (None, None)
            out.append(MsIndex(
                grids=grids, Y=Y, C=C, cp_cols=cp_cols,
                A_cp=A_cp, egs=egs, occ=occ,
                planes=_pack_planes(Y) if want_planes else None,
                occ32=o32, C32=C32,
            ))
            continue
        # NumPy fallback (identical outputs; tests/test_mspbwt.py asserts)
        X = np.asfortranarray(hapMatcher[:, grids])
        Y = np.empty((T, K), dtype=np.uint8)
        C = np.zeros((T, 257), dtype=np.int32)
        cp_cols = []
        A_cp = []
        A = np.arange(K, dtype=np.int32)
        occ = np.empty((T, K), dtype=np.int32) if want_occ else None
        for t in range(T):
            y = X[A, t]
            Y[t] = y
            C[t, 1:] = np.cumsum(np.bincount(y, minlength=256))
            order = np.argsort(y, kind="stable")     # radix for uint8
            if occ is not None:
                occ[t] = order
            A = A[order]
            if (t + 1) % egs == 0 or t == T - 1:
                cp_cols.append(t)
                A_cp.append(A.copy())
        o32, C32 = _subsampled_occ(Y, C) if want_planes else (None, None)
        out.append(MsIndex(
            grids=grids, Y=Y, C=C,
            cp_cols=np.asarray(cp_cols, dtype=np.int32),
            A_cp=np.stack(A_cp) if A_cp else np.zeros((0, K), np.int32),
            egs=egs, occ=occ,
            planes=_pack_planes(Y) if want_planes else None,
            occ32=o32, C32=C32,
        ))
    return out


def match_z(
    index: MsIndex,
    z: np.ndarray,
    X_rows,                       # callable (cands, upto) -> [n_c, upto]
    min_length: int = 3,
    scan: int = 4,
    every_column: bool = False,
) -> List[Tuple[int, int, int]]:
    """Long matches of query symbols z [T] against the indexed panel.

    Returns (hap, end_t, length) tuples with length >= min_length (index
    grids). Candidates are the up/down neighbours of the query's insertion
    point at checkpoint columns (approach A; `every_column=True` gives the
    reference's approach-B scan at every column — O(K) argsort per column,
    for small panels / validation). `scan` = neighbours per side.
    """
    Y, C, grids = index.Y, index.C, index.grids
    T, K = Y.shape
    cp_set = {int(c): i for i, c in enumerate(index.cp_cols)}
    matches: Dict[Tuple[int, int], int] = {}

    def report(cands: np.ndarray, t: int):
        """Backward suffix-run lengths of candidate rows ending at t."""
        if len(cands) == 0:
            return
        # symbols of candidates over columns 0..t — bounded rows
        sym = X_rows(cands, t + 1)                     # [n_c, t+1]
        eq = sym == z[None, : t + 1]
        run = np.cumprod(eq[:, ::-1], axis=1)
        lens = run.sum(axis=1)
        keep = lens >= min_length
        for k, L in zip(cands[keep].tolist(), lens[keep].tolist()):
            key = (int(k), int(t - L + 1))
            if matches.get(key, 0) < L:
                matches[key] = int(L)

    p = 0
    occ = index.occ
    A_run = np.arange(K, dtype=np.int32) if every_column else None
    for t in range(T):
        y = Y[t]
        zt = int(z[t])
        if occ is not None:
            # O(log K) rank via the occurrence lists (Algorithm-5 style)
            lo, hi_b = int(C[t, zt]), int(C[t, zt + 1])
            p = lo + int(np.searchsorted(occ[t, lo:hi_b], p))
        elif index.planes is not None:
            # subsampled-occ + bit-plane popcount rank (UKB-scale
            # replacement for occ; see MsIndex.planes): the subsample
            # locates the 32-occurrence window, the planes count within it
            lo32, hi32 = int(index.C32[t, zt]), int(index.C32[t, zt + 1])
            row32 = index.occ32[t]
            j = int(np.searchsorted(row32[lo32:hi32], p))
            if j == 0:
                rank = 0
            else:
                o = int(row32[lo32 + j - 1])
                rank = 32 * (j - 1) + _rank_planes(
                    index.planes[t], zt, p, a=o
                )
            p = int(C[t, zt]) + rank
        else:
            p = int(C[t, zt]) + int(np.count_nonzero(y[:p] == zt))
        if every_column:
            A_run = A_run[np.argsort(y, kind="stable")]
            lo, hi = max(p - scan, 0), min(p + scan, K)
            report(A_run[lo:hi], t)
        elif t in cp_set:
            A = index.A_cp[cp_set[t]]
            lo, hi = max(p - scan, 0), min(p + scan, K)
            report(A[lo:hi], t)
    out = []
    for (k, start), L in matches.items():
        out.append((k, start + L - 1, L))
    return out


def match_z_batch(
    index: MsIndex,
    Z: np.ndarray,                # [Q, T] uint8 query symbols
    X_rows,                       # callable (cands, upto) -> [n_c, upto]
    min_length: int = 3,
    scan: int = 4,
) -> List[List[Tuple[int, int, int]]]:
    """match_z for a BATCH of queries: the per-column insertion-point
    update vectorizes over queries (grouped by symbol per column), so the
    batched engine's {rows x latent haps} selection pays one Python
    column loop instead of one per query. Approach A only (checkpoint
    reporting); identical results to per-query match_z (tested)."""
    Y, C, grids = index.Y, index.C, index.grids
    T, K = Y.shape
    Q = Z.shape[0]
    occ = index.occ
    planes = index.planes
    cp_set = {int(c): i for i, c in enumerate(index.cp_cols)}
    if occ is None and planes is None:
        # plain-scan rank structure: per-query path
        return [
            match_z(index, Z[q], X_rows, min_length=min_length, scan=scan)
            for q in range(Q)
        ]
    matches: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(Q)]

    def report(q, cands, t):
        if len(cands) == 0:
            return
        sym = X_rows(cands, t + 1)
        eq = sym == Z[q, None, : t + 1]
        run = np.cumprod(eq[:, ::-1], axis=1)
        lens = run.sum(axis=1)
        keep = lens >= min_length
        mq = matches[q]
        for k, L in zip(cands[keep].tolist(), lens[keep].tolist()):
            key = (int(k), int(t - L + 1))
            if mq.get(key, 0) < L:
                mq[key] = int(L)

    p = np.zeros(Q, dtype=np.int64)
    Ct = C
    for t in range(T):
        zt = Z[:, t]
        if occ is not None:
            row = occ[t]
            for s in np.unique(zt):
                m = zt == s
                si = int(s)              # uint8 s+1 would wrap at 255
                lo, hi = int(Ct[t, si]), int(Ct[t, si + 1])
                p[m] = lo + np.searchsorted(row[lo:hi], p[m])
        else:
            # UKB-scale rank structure (planes + subsampled occ): the
            # subsample searchsorted vectorizes over same-symbol queries;
            # the bounded popcount window refines each
            row32 = index.occ32[t]
            for s in np.unique(zt):
                m = np.flatnonzero(zt == s)
                si = int(s)
                lo32, hi32 = int(index.C32[t, si]), int(index.C32[t, si + 1])
                sub32 = row32[lo32:hi32]
                js = np.searchsorted(sub32, p[m])
                for q, j in zip(m, js):
                    if j == 0:
                        rank = 0
                    else:
                        o = int(sub32[j - 1])
                        rank = 32 * (j - 1) + _rank_planes(
                            planes[t], si, int(p[q]), a=o
                        )
                    p[q] = int(Ct[t, si]) + rank
        if t in cp_set:
            A = index.A_cp[cp_set[t]]
            for q in range(Q):
                lo_q, hi_q = max(int(p[q]) - scan, 0), min(
                    int(p[q]) + scan, K
                )
                report(q, A[lo_q:hi_q], t)
    out: List[List[Tuple[int, int, int]]] = []
    for q in range(Q):
        out.append([
            (k, start + L - 1, L) for (k, start), L in matches[q].items()
        ])
    return out


def symbols_from_hap_dosage(
    hap_dosage: np.ndarray,          # [nSNPs] imputed haploid dosage
    distinctHapsB: np.ndarray,       # uint32 [nMaxDH, nGrids]
    nSNPs: int,
) -> np.ndarray:
    """Round a haploid dosage vector to per-grid distinct-hap symbols.

    Equivalent of rcpp_int_contract + map_Z_to_all_symbols (mspbwt.R:284-297):
    pack rounded alleles to 32-bit words, then match each word to the grid's
    distinct-hap table. Words not in the table map to the Hamming-nearest
    distinct hap (the reference maps them to special symbols; nearest-match
    keeps the query dense and is at least as informative).
    """
    nMaxDH, nGrids = distinctHapsB.shape
    alleles = (np.asarray(hap_dosage) > 0.5).astype(np.uint8)
    S = nGrids * 32
    pad = np.zeros(S, dtype=np.uint8)
    pad[:nSNPs] = alleles[:nSNPs]
    bits = pad.reshape(nGrids, 4, 8)
    byte_vals = (bits << np.arange(8, dtype=np.uint8)).sum(axis=-1).astype(np.uint8)
    words = (
        byte_vals[:, 0].astype(np.uint32)
        | (byte_vals[:, 1].astype(np.uint32) << 8)
        | (byte_vals[:, 2].astype(np.uint32) << 16)
        | (byte_vals[:, 3].astype(np.uint32) << 24)
    )
    # vectorized over grids: exact word match, else Hamming-nearest
    ham = np.bitwise_count(distinctHapsB ^ words[None, :])   # [nMaxDH, G]
    z = (ham.argmin(axis=0) + 1).astype(np.uint8)
    return z


def _coverage_weight_rank(
    mtm: List[Tuple[int, int, int, int]],    # (hap, start, end, len)
    T: int,
) -> List[int]:
    """The reference's coverage-weighted ranking (mspbwt.R:414-441):
    visit matches longest-first; weight = len / Σ cur_sum[start..end] with
    cur_sum starting at 1 and incremented over each visited span; return
    hap indices ordered by weight descending."""
    if not mtm:
        return []
    mtm = sorted(mtm, key=lambda m: -m[3])
    cur_sum = np.ones(T + 1, dtype=np.float64)
    weights = np.empty(len(mtm))
    for i, (hap, s, e, L) in enumerate(mtm):
        weights[i] = L / cur_sum[s:e + 1].sum()
        cur_sum[s:e + 1] += 1.0
    order = np.argsort(-weights, kind="stable")
    return [mtm[i][0] for i in order]


def distinct_hap_bits(panel, device) -> torch.Tensor:
    """The panel's distinct-haplotype words unpacked to {0,1} float32
    [nMaxDH, nGrids*32] on `device` (uploaded once per region)."""
    bits = unpack_bits_32(panel.distinctHapsB, panel.nGrids * 32)
    return torch.as_tensor(bits.astype(np.float32), device=device)


def symbols_device(hap_dos: torch.Tensor, dh_bits: torch.Tensor, nSNPs: int) -> torch.Tensor:
    """[..., >= nSNPs] haploid dosages -> [..., nGrids] uint8 symbols on the
    device: per grid, 1 + the index of the Hamming-nearest distinct
    haplotype to the rounded alleles (dosage > 0.5), the first index on
    ties (as np.argmin in symbols_from_hap_dosage). Only the small symbol
    matrix then crosses to the host match scan.

    The Hamming distances are |a| + |d| - 2 a.d with a.d a float32 product
    of {0,1} operands: every partial sum is an integer <= 32, exact in
    float32 (and in TF32, whose inputs here are exact too)."""
    lead = hap_dos.shape[:-1]
    D, S = dh_bits.shape
    G = S // 32
    a = (hap_dos[..., :nSNPs] > 0.5).to(torch.float32).reshape(-1, nSNPs)
    if nSNPs < S:
        a = torch.nn.functional.pad(a, (0, S - nSNPs))
    av = a.reshape(-1, G, 32).transpose(0, 1)                     # [G, R, 32]
    dv = dh_bits.reshape(D, G, 32).transpose(0, 1)               # [G, D, 32]
    ham = (av.sum(-1)[:, :, None] + dv.sum(-1)[:, None, :]
           - 2.0 * torch.bmm(av, dv.transpose(1, 2)))             # [G, R, D]
    z = (ham.argmin(-1) + 1).to(torch.uint8)                      # [G, R]
    return z.T.reshape(lead + (G,))


def select_new_haps_mspbwt(
    ms_indices: List[MsIndex],
    panel,                            # CompressedPanel
    hap_dosages: Optional[np.ndarray],   # [n_latent, nSNPs] (or None)
    Knew: int,
    K: int,
    previously_selected: np.ndarray,
    rng: np.random.Generator,
    mspbwtL: int = 3,
    mspbwtM: int = 1,
    heuristic_approach: str = "A",
    hapMatcher: Optional[np.ndarray] = None,
    symbols: Optional[np.ndarray] = None,   # [n_latent, nGrids] uint8
) -> np.ndarray:
    """Select Knew haplotypes via long-match discovery + coverage-weighted
    ranking + cross-latent-hap interleaving (select_new_haps_mspbwt_v3,
    mspbwt.R:230-474). `symbols` (precomputed, e.g. on device via
    symbols_device) skips the per-row host symbol build."""
    nSNPs = panel.nSNPs
    n_latent = (symbols if symbols is not None else hap_dosages).shape[0]
    hm = hapMatcher if hapMatcher is not None else panel.hapMatcher
    scan = max(int(mspbwtM), 4)
    per_hap_ranked: List[List[int]] = []
    all_haps: set = set()
    for h in range(n_latent):
        z_full = symbols[h] if symbols is not None else \
            symbols_from_hap_dosage(
                hap_dosages[h], panel.distinctHapsB, nSNPs
            )
        mtm: List[Tuple[int, int, int, int]] = []
        T_max = 0
        for idx in ms_indices:
            z = z_full[idx.grids]
            T_max = max(T_max, len(idx.grids))

            def X_rows(cands, upto, idx=idx):
                return hm[np.asarray(cands)[:, None],
                          idx.grids[None, :upto]]

            for k, end_t, L in match_z(
                idx, z, X_rows, min_length=mspbwtL, scan=scan,
                every_column=heuristic_approach == "B",
            ):
                mtm.append((k, end_t - L + 1, end_t, L))
                all_haps.add(k)
        per_hap_ranked.append(_coverage_weight_rank(mtm, T_max))
    return _interleave_pick(
        per_hap_ranked, Knew, K, previously_selected, rng
    )


def _interleave_pick(per_hap_ranked, Knew, K, previously_selected, rng):
    """Round-robin interleave of per-hap ranked lists, dedupe, exclude the
    retained subset, random fill on shortage (mspbwt.R:443-473)."""
    n_latent = len(per_hap_ranked)
    chosen: List[int] = []
    prev = set(np.asarray(previously_selected).tolist())
    seen = set()
    ptrs = [0] * n_latent
    while len(chosen) < Knew:
        progressed = False
        for h in range(n_latent):
            while ptrs[h] < len(per_hap_ranked[h]):
                k = per_hap_ranked[h][ptrs[h]]
                ptrs[h] += 1
                if k in seen or k in prev:
                    continue
                chosen.append(k)
                seen.add(k)
                progressed = True
                break
            if len(chosen) >= Knew:
                break
        if not progressed:
            break
    if len(chosen) < Knew:
        pool = np.setdiff1d(np.arange(K), np.asarray(sorted(seen | prev)))
        fill = rng.choice(pool, size=Knew - len(chosen), replace=False)
        chosen.extend(fill.tolist())
    return np.asarray(chosen[:Knew], dtype=np.int64)


def select_new_haps_mspbwt_batch(
    ms_indices: List[MsIndex],
    panel,
    symbols_all: np.ndarray,          # [n_rows, n_latent, nGrids] uint8
    Knew: int,
    K: int,
    prev_list,                        # per row: retained hap indices
    rng: np.random.Generator,
    mspbwtL: int = 3,
    mspbwtM: int = 1,
    heuristic_approach: str = "A",
    hapMatcher: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Batched selection for the {samples x chains} engine: ONE
    vectorized insertion scan per index (match_z_batch) replaces a
    per-row Python query loop; ranking/interleave then runs per row.
    Same matches as per-row select_new_haps_mspbwt (tested)."""
    n_rows, n_latent, G = symbols_all.shape
    hm = hapMatcher if hapMatcher is not None else panel.hapMatcher
    scan = max(int(mspbwtM), 4)
    Q = n_rows * n_latent
    Zf = symbols_all.reshape(Q, G)
    per_query_mtm: List[List[Tuple[int, int, int, int]]] = [
        [] for _ in range(Q)
    ]
    T_max = 0
    for idx in ms_indices:
        Z = np.ascontiguousarray(Zf[:, idx.grids])
        T_max = max(T_max, len(idx.grids))

        def X_rows(cands, upto, idx=idx):
            return hm[np.asarray(cands)[:, None], idx.grids[None, :upto]]

        if heuristic_approach == "B":
            res = [
                match_z(idx, Z[q], X_rows, min_length=mspbwtL, scan=scan,
                        every_column=True)
                for q in range(Q)
            ]
        else:
            res = match_z_batch(
                idx, Z, X_rows, min_length=mspbwtL, scan=scan
            )
        for q, lst in enumerate(res):
            mq = per_query_mtm[q]
            for k, end_t, L in lst:
                mq.append((k, end_t - L + 1, end_t, L))
    out = []
    for r in range(n_rows):
        ranked = [
            _coverage_weight_rank(per_query_mtm[r * n_latent + h], T_max)
            for h in range(n_latent)
        ]
        out.append(_interleave_pick(ranked, Knew, K, prev_list[r], rng))
    return out


# ---------------------------------------------------------------------------
# (De)serialization into the PreparedReference npz
# ---------------------------------------------------------------------------

def save_ms_indices_into(d: dict, ms_indices: List[MsIndex]) -> None:
    d["msi_n"] = np.array(len(ms_indices))
    d["msi_v"] = np.array(2)                    # format version
    for i, idx in enumerate(ms_indices):
        d[f"msi_{i}_grids"] = idx.grids
        d[f"msi_{i}_Y"] = idx.Y
        d[f"msi_{i}_C"] = idx.C
        d[f"msi_{i}_cp_cols"] = idx.cp_cols
        d[f"msi_{i}_A_cp"] = idx.A_cp
        d[f"msi_{i}_egs"] = np.array(idx.egs)
        if idx.planes is not None:
            d[f"msi_{i}_planes"] = idx.planes
            d[f"msi_{i}_occ32"] = idx.occ32
            d[f"msi_{i}_C32"] = idx.C32
        if idx.occ is not None:
            d[f"msi_{i}_occ"] = idx.occ


def load_ms_indices_from(z) -> List[MsIndex]:
    n = int(z["msi_n"])
    if "msi_v" not in z:
        raise ValueError(
            "prepared reference holds a round-1 (v1) mspbwt index; re-run "
            "`python -m quilt_tpu_torch prepare2` to rebuild it"
        )
    return [
        MsIndex(
            grids=z[f"msi_{i}_grids"],
            Y=z[f"msi_{i}_Y"],
            C=z[f"msi_{i}_C"],
            cp_cols=z[f"msi_{i}_cp_cols"],
            A_cp=z[f"msi_{i}_A_cp"],
            egs=int(z[f"msi_{i}_egs"]),
            occ=z[f"msi_{i}_occ"] if f"msi_{i}_occ" in z else None,
            planes=(z[f"msi_{i}_planes"]
                    if f"msi_{i}_planes" in z else None),
            occ32=(z[f"msi_{i}_occ32"]
                   if f"msi_{i}_occ32" in z else None),
            C32=(z[f"msi_{i}_C32"]
                 if f"msi_{i}_C32" in z else None),
        )
        for i in range(n)
    ]
