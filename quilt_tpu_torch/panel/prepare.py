"""Reference-panel preparation: grids, recombination rates, distinct-haplotype
compression, and the single-file prepared-reference checkpoint.

Functional equivalent of QUILT_prepare_reference() (reference:
QUILT/R/quilt-prepare-reference.R:35-530) plus the STITCH helpers it imports
(`assign_positions_to_grid`, `make_rhb_t_equality`, `get_sigmaCurrent_m` at
QUILT/R/prepare_reference_functions.R:89-114). Pure NumPy — this runs once per
region on the host; the products are the device-side inputs of the kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import pack_bits_32, print_message, unpack_bits_32


# ---------------------------------------------------------------------------
# Grids
# ---------------------------------------------------------------------------

def assign_positions_to_grid(L: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Assign SNPs to 32-SNP grids (grid32 semantics).

    Returns (grid [nSNPs] int32, L_grid [nGrids] int32, nGrids). grid is the
    0-based grid index of each SNP; L_grid is a representative physical
    position per grid (midpoint of first/last member SNP), used for
    recombination-distance bookkeeping.
    Reference: quilt-prepare-reference.R:376-384.
    """
    nSNPs = len(L)
    grid = (np.arange(nSNPs) // 32).astype(np.int32)
    nGrids = int(grid[-1]) + 1 if nSNPs else 0
    L = np.asarray(L, dtype=np.int64)
    starts = np.arange(nGrids) * 32
    ends = np.minimum(starts + 32, nSNPs) - 1
    L_grid = ((L[starts] + L[ends]) // 2).astype(np.int64)
    return grid, L_grid, nGrids


# ---------------------------------------------------------------------------
# Genetic map / recombination
# ---------------------------------------------------------------------------

def interpolate_genetic_map(
    gmap_pos: np.ndarray,
    gmap_cm: np.ndarray,
    L: np.ndarray,
    expRate: float = 1.0,
) -> np.ndarray:
    """Interpolate cumulative genetic distance (cM) at physical positions L.

    Linear interpolation within the map; constant-rate (expRate cM/Mb)
    extrapolation outside it. Equivalent of STITCH's match_genetic_map_to_L
    (used at quilt-prepare-reference.R:400-404).
    """
    L = np.asarray(L, dtype=np.float64)
    if gmap_pos is None or len(gmap_pos) == 0:
        return (L - L[0]) * expRate / 1e6
    cm = np.interp(L, gmap_pos, gmap_cm)
    below = L < gmap_pos[0]
    cm[below] = gmap_cm[0] - (gmap_pos[0] - L[below]) * expRate / 1e6
    above = L > gmap_pos[-1]
    cm[above] = gmap_cm[-1] + (L[above] - gmap_pos[-1]) * expRate / 1e6
    return cm


def sigma_from_cm_grid(
    nGen: float,
    cM_grid: np.ndarray,
    L_grid: np.ndarray,
    expRate: float,
    minRate: float,
    maxRate: float,
) -> np.ndarray:
    """Per-grid-gap no-recombination probability sigma = exp(-rate).

    rate = nGen * d_cM / 100, clamped between nGen*dL*minRate/100/1e6 and
    nGen*dL*maxRate/100/1e6. Reference: prepare_reference_functions.R:89-108.
    """
    dL = np.diff(np.asarray(L_grid, dtype=np.float64))
    rate = nGen * np.diff(cM_grid) / 100.0
    min_rate = nGen * dL / 1e6 * (minRate / 100.0)
    max_rate = nGen * dL / 1e6 * (maxRate / 100.0)
    rate = np.clip(rate, min_rate, max_rate)
    return np.exp(-rate)


def trans_rates(sigma: np.ndarray) -> np.ndarray:
    """Haploid transition pair per grid gap: row 0 = stay, row 1 = jump.

    [2, nGrids-1] float64. Equivalent of STITCH get_transMatRate_m
    ("pseudoHaploid") used at prepare_reference_functions.R:152-157.
    """
    return np.stack([sigma, 1.0 - sigma]).astype(np.float64)


def make_smoothed_rate(
    sigma: np.ndarray, L_grid: np.ndarray, shuffle_bin_radius: int = 5000
) -> np.ndarray:
    """Physically smoothed recombination rate per grid gap, normalized to max 1.

    For each gap, averages the per-bp rate over a +/- shuffle_bin_radius bp
    window centred on the gap midpoint. Semantics of rcpp_make_smoothed_rate
    (reference: QUILT/src/copied-from-stitch.cpp:446-518) +
    get_transMatRate_tc_H_and_smooth_cm (prepare_reference_functions.R:152-168).
    """
    L_grid = np.asarray(L_grid, dtype=np.int64)
    nGrids = len(L_grid)
    rate = -np.log(np.asarray(sigma, dtype=np.float64)) * 100.0
    smoothed = np.zeros(nGrids - 1)
    for i in range(nGrids - 1):
        focal = (L_grid[i] + L_grid[i + 1]) // 2
        total_bp = 0.0
        acc = 0.0
        # left
        j = i
        bp_remaining = shuffle_bin_radius
        bp_prev = focal
        while bp_remaining > 0 and j >= 0:
            bp_to_add = bp_prev - L_grid[j]
            if bp_remaining - bp_to_add < 0:
                bp_to_add = bp_remaining
                bp_remaining = 0
            else:
                bp_remaining -= bp_to_add
            acc += bp_to_add * rate[j]
            total_bp += bp_to_add
            bp_prev = L_grid[j]
            j -= 1
        # right
        j = i + 1
        bp_remaining = shuffle_bin_radius
        bp_prev = focal
        while bp_remaining > 0 and j < nGrids:
            bp_to_add = L_grid[j] - bp_prev
            if bp_remaining - bp_to_add < 0:
                bp_to_add = bp_remaining
                bp_remaining = 0
            else:
                bp_remaining -= bp_to_add
            acc += bp_to_add * rate[j - 1]
            total_bp += bp_to_add
            bp_prev = L_grid[j]
            j += 1
        smoothed[i] = acc / max(total_bp, 1.0)
    m = smoothed.max()
    if m > 0:
        smoothed = smoothed / m
    return smoothed


def smoothing_band(
    L_grid: np.ndarray, shuffle_bin_radius: int = 5000
) -> Tuple[np.ndarray, np.ndarray]:
    """BANDED linear-operator form of rcpp_make_smoothed_rate (reference:
    QUILT/src/copied-from-stitch.cpp:446-518): smoothed[i] =
    sum_j band[i, j] * rate[idx0[i] + j], with band row i holding the
    bp-overlap weights of the gaps inside the +/- shuffle_bin_radius
    window around gap i's midpoint, normalized by the total bp added.

    Returns (band [Gm, bw] float32, idx0 [Gm] int32). The window spans
    only the gaps within the radius, so memory is O(Gm * band) — a dense
    [Gm, Gm] operator would need gigabytes at whole-chromosome Gm.
    Built once per region so the on-the-fly block-Gibbs boundary
    detection (Rcpp_define_blocked_snps_using_gamma_on_the_fly,
    QUILT/src/gibbs-nipt-block.cpp:311-527) can smooth its live FB jump
    rate on device as one banded gather-reduce.
    """
    L_grid = np.asarray(L_grid, dtype=np.int64)
    nGrids = len(L_grid)
    Gm = nGrids - 1
    rows: list = []
    lo_js = np.zeros(Gm, dtype=np.int32)
    for i in range(Gm):
        focal = (L_grid[i] + L_grid[i + 1]) // 2
        w: dict = {}
        total_bp = 0.0
        # left
        j = i
        bp_remaining = shuffle_bin_radius
        bp_prev = focal
        while bp_remaining > 0 and j >= 0:
            bp_to_add = bp_prev - L_grid[j]
            if bp_remaining - bp_to_add < 0:
                bp_to_add = bp_remaining
                bp_remaining = 0
            else:
                bp_remaining -= bp_to_add
            w[j] = w.get(j, 0.0) + bp_to_add
            total_bp += bp_to_add
            bp_prev = L_grid[j]
            j -= 1
        # right
        j = i + 1
        bp_remaining = shuffle_bin_radius
        bp_prev = focal
        while bp_remaining > 0 and j < nGrids:
            bp_to_add = L_grid[j] - bp_prev
            if bp_remaining - bp_to_add < 0:
                bp_to_add = bp_remaining
                bp_remaining = 0
            else:
                bp_remaining -= bp_to_add
            w[j - 1] = w.get(j - 1, 0.0) + bp_to_add
            total_bp += bp_to_add
            bp_prev = L_grid[j]
            j += 1
        lo = min(w)
        lo_js[i] = lo
        rows.append(
            np.array([w.get(lo + k, 0.0) for k in range(max(w) - lo + 1)])
            / max(total_bp, 1.0)
        )
    bw = max(len(r) for r in rows)
    band = np.zeros((Gm, bw), dtype=np.float32)
    for i, r in enumerate(rows):
        band[i, : len(r)] = r
    return band, lo_js


# ---------------------------------------------------------------------------
# Distinct-haplotype compression
# ---------------------------------------------------------------------------

@dataclass
class CompressedPanel:
    """Distinct-haplotype-compressed panel, the device-side panel format.

    Equivalent to the products of STITCH::make_rhb_t_equality (consumed at
    quilt-prepare-reference.R:416-428): hapMatcher (uint8, 0 = escape),
    distinctHapsB (packed alleles of the top nMaxDH local haps per grid),
    distinctHapsIE (inflated expected dosages), and an escape-COO replacing
    the reference's binary-searched special matrix
    (QUILT/src/gibbs-small.cpp:26-114) with a static-shape, device-friendly
    padded coordinate list.
    """

    hapMatcher: np.ndarray       # uint8 [K, nGrids]; value d>0 => distinctHapsB[d-1]
    distinctHapsB: np.ndarray    # uint32 [nMaxDH, nGrids]
    distinctHapsIE: np.ndarray   # float32 [nMaxDH, nSNPs]
    # Escape entries (haps whose grid-word is not among the top nMaxDH):
    esc_grid: np.ndarray         # int32 [nnz] grid index, sorted
    esc_k: np.ndarray            # int32 [nnz] hap index
    esc_word: np.ndarray         # uint32 [nnz] packed alleles
    nMaxDH: int
    K: int
    nGrids: int
    nSNPs: int

    def escape_padded(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Per-grid padded escape arrays (k, word, mask) of shape
        [nGrids, M] with M = max escapes in any grid."""
        counts = np.bincount(self.esc_grid, minlength=self.nGrids)
        M = int(counts.max()) if len(counts) else 0
        k_pad = np.zeros((self.nGrids, max(M, 1)), dtype=np.int32)
        w_pad = np.zeros((self.nGrids, max(M, 1)), dtype=np.uint32)
        mask = np.zeros((self.nGrids, max(M, 1)), dtype=bool)
        offsets = np.zeros(self.nGrids + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        for g in range(self.nGrids):
            s, e = offsets[g], offsets[g + 1]
            n = e - s
            k_pad[g, :n] = self.esc_k[s:e]
            w_pad[g, :n] = self.esc_word[s:e]
            mask[g, :n] = True
        return k_pad, w_pad, mask, M


def compress_panel(
    rhb_t: np.ndarray,
    nSNPs: int,
    ref_error: float = 0.001,
    nMaxDH: Optional[int] = None,
) -> CompressedPanel:
    """Build the distinct-haplotype compression of a packed panel.

    Per grid: rank the distinct 32-bit words by frequency, keep the top
    nMaxDH; haps carrying other words become escape entries.
    """
    K, nGrids = rhb_t.shape
    if nMaxDH is None:
        nMaxDH = 255
    assert nMaxDH <= 255, "hapMatcher is uint8; nMaxDH must be <= 255"
    from ..io.native import native_available
    if native_available() and K * nGrids >= 1 << 20:
        # threaded C++ compression (quilt_io.cpp:qio_compress_panel) —
        # identical ranking/tie-breaking; minutes -> seconds at UKB scale
        from ..io.native import compress_panel_native
        hapMatcher, distinctHapsB = compress_panel_native(rhb_t, nMaxDH)
    else:
        hapMatcher = np.zeros((K, nGrids), dtype=np.uint8)
        distinctHapsB = np.zeros((nMaxDH, nGrids), dtype=np.uint32)
        for g in range(nGrids):
            words = rhb_t[:, g]
            uniq, inv, counts = np.unique(
                words, return_inverse=True, return_counts=True
            )
            # ranking: by count desc, ties by word value (np.unique order)
            order = np.argsort(-counts, kind="stable")
            nkeep = min(len(uniq), nMaxDH)
            kept = order[:nkeep]
            rank_of_uniq = np.zeros(len(uniq), dtype=np.int32)  # 0 => escape
            rank_of_uniq[kept] = np.arange(1, nkeep + 1)
            hapMatcher[:, g] = rank_of_uniq[inv].astype(np.uint8)
            distinctHapsB[:nkeep, g] = uniq[kept]
    # escape COO from the rank-0 entries, sorted by (grid, k)
    esc_grid_a, esc_k_a = [
        a.astype(np.int32) for a in np.nonzero(hapMatcher.T == 0)
    ]
    esc_word_a = rhb_t[esc_k_a, esc_grid_a].astype(np.uint32)
    # inflated expected dosages of the distinct haps: allele -> ref_error /
    # 1 - ref_error (reference: distinctHapsIE, quilt-prepare-reference.R:423)
    bits = unpack_bits_32(distinctHapsB, nSNPs)
    distinctHapsIE = np.where(bits == 1, 1.0 - ref_error, ref_error).astype(np.float32)
    return CompressedPanel(
        hapMatcher=hapMatcher,
        distinctHapsB=distinctHapsB,
        distinctHapsIE=distinctHapsIE,
        esc_grid=esc_grid_a,
        esc_k=esc_k_a,
        esc_word=esc_word_a,
        nMaxDH=nMaxDH,
        K=K,
        nGrids=nGrids,
        nSNPs=nSNPs,
    )


# ---------------------------------------------------------------------------
# Prepared reference checkpoint
# ---------------------------------------------------------------------------

@dataclass
class PreparedReference:
    """Single-file checkpoint of everything the impute step needs.

    Equivalent of the prepared-reference RData (reference:
    quilt-prepare-reference.R:484-525); serialized as .npz.
    """

    chrom: str
    pos: np.ndarray              # int64 [nSNPs] physical positions (common SNPs)
    ref_allele: np.ndarray       # str [nSNPs]
    alt_allele: np.ndarray       # str [nSNPs]
    rhb_t: np.ndarray            # uint32 [K, nGrids]
    af: np.ndarray               # float64 [nSNPs] panel alt-allele frequency
    grid: np.ndarray             # int32 [nSNPs]
    L_grid: np.ndarray           # int64 [nGrids]
    cM_grid: np.ndarray          # float64 [nGrids]
    sigma: np.ndarray            # float64 [nGrids-1]
    panel: CompressedPanel
    regionStart: Optional[int]
    regionEnd: Optional[int]
    buffer: int
    nGen: float
    ref_error: float
    # rare/common split (QUILT2): all-SNP objects
    snp_is_common: Optional[np.ndarray] = None       # bool [nSNPs_all]
    pos_all: Optional[np.ndarray] = None             # int64 [nSNPs_all]
    ref_allele_all: Optional[np.ndarray] = None
    alt_allele_all: Optional[np.ndarray] = None
    af_all: Optional[np.ndarray] = None
    rare_per_hap_info: Optional[list] = None         # per hap: rare SNP idx carried
    ms_indices: Optional[list] = None                # mspbwt indices
    # all-SNP HMM geometry (rare/common mode; reference:
    # prepare_full_objects_for_rare_common, prepare_reference_functions.R:172-249)
    grid_all: Optional[np.ndarray] = None            # int32 [nSNPs_all]
    L_grid_all: Optional[np.ndarray] = None
    sigma_all: Optional[np.ndarray] = None
    # panel sample names (hap 2i, 2i+1 belong to sample i); kept for the
    # HLA phasing step (reference: reference_samples in
    # hla_prepare_phase_functions.R:266-268)
    sample_names: Optional[np.ndarray] = None        # str [K//2]

    @property
    def K(self) -> int:
        return self.rhb_t.shape[0]

    @property
    def nSNPs(self) -> int:
        return len(self.pos)

    @property
    def nGrids(self) -> int:
        return len(self.L_grid)

    def in_region(self) -> np.ndarray:
        if self.regionStart is None:
            return np.ones(self.nSNPs, dtype=bool)
        return (self.pos >= self.regionStart) & (self.pos <= self.regionEnd)

    def in_region_all(self) -> np.ndarray:
        pos_all = self.pos_all if self.pos_all is not None else self.pos
        if self.regionStart is None:
            return np.ones(len(pos_all), dtype=bool)
        return (pos_all >= self.regionStart) & (pos_all <= self.regionEnd)

    def save(self, path: str) -> None:
        d: Dict[str, np.ndarray] = {}
        p = self.panel
        d.update(
            chrom=np.array(self.chrom),
            pos=self.pos,
            ref_allele=np.asarray(self.ref_allele),
            alt_allele=np.asarray(self.alt_allele),
            rhb_t=self.rhb_t,
            af=self.af,
            grid=self.grid,
            L_grid=self.L_grid,
            cM_grid=self.cM_grid,
            sigma=self.sigma,
            hapMatcher=p.hapMatcher,
            distinctHapsB=p.distinctHapsB,
            distinctHapsIE=p.distinctHapsIE,
            esc_grid=p.esc_grid,
            esc_k=p.esc_k,
            esc_word=p.esc_word,
            nMaxDH=np.array(p.nMaxDH),
            meta=np.array(
                [
                    -1 if self.regionStart is None else self.regionStart,
                    -1 if self.regionEnd is None else self.regionEnd,
                    self.buffer,
                ],
                dtype=np.int64,
            ),
            nGen=np.array(self.nGen),
            ref_error=np.array(self.ref_error),
        )
        if self.snp_is_common is not None:
            d["snp_is_common"] = self.snp_is_common
            d["pos_all"] = self.pos_all
            d["ref_allele_all"] = np.asarray(self.ref_allele_all)
            d["alt_allele_all"] = np.asarray(self.alt_allele_all)
            d["af_all"] = self.af_all
            d["grid_all"] = self.grid_all
            d["L_grid_all"] = self.L_grid_all
            d["sigma_all"] = self.sigma_all
        if self.sample_names is not None:
            d["sample_names"] = np.asarray(self.sample_names, dtype=str)
        if self.rare_per_hap_info is not None:
            flat = np.concatenate([np.asarray(x, dtype=np.int64)
                                   for x in self.rare_per_hap_info]) \
                if self.rare_per_hap_info else np.zeros(0, np.int64)
            lens = np.array([len(x) for x in self.rare_per_hap_info], dtype=np.int64)
            d["rare_per_hap_flat"] = flat
            d["rare_per_hap_lens"] = lens
        if self.ms_indices is not None:
            from .mspbwt import save_ms_indices_into
            save_ms_indices_into(d, self.ms_indices)
        np.savez_compressed(path, **d)

    @classmethod
    def load(cls, path: str) -> "PreparedReference":
        z = np.load(path, allow_pickle=False)
        meta = z["meta"]
        panel = CompressedPanel(
            hapMatcher=z["hapMatcher"],
            distinctHapsB=z["distinctHapsB"],
            distinctHapsIE=z["distinctHapsIE"],
            esc_grid=z["esc_grid"],
            esc_k=z["esc_k"],
            esc_word=z["esc_word"],
            nMaxDH=int(z["nMaxDH"]),
            K=z["hapMatcher"].shape[0],
            nGrids=z["hapMatcher"].shape[1],
            nSNPs=len(z["pos"]),
        )
        rare_per_hap_info = None
        if "rare_per_hap_lens" in z:
            lens = z["rare_per_hap_lens"]
            flat = z["rare_per_hap_flat"]
            offs = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            rare_per_hap_info = [flat[offs[i]:offs[i + 1]] for i in range(len(lens))]
        ms_indices = None
        if "msi_n" in z:
            from .mspbwt import load_ms_indices_from
            ms_indices = load_ms_indices_from(z)
        return cls(
            chrom=str(z["chrom"]),
            pos=z["pos"],
            ref_allele=z["ref_allele"],
            alt_allele=z["alt_allele"],
            rhb_t=z["rhb_t"],
            af=z["af"],
            grid=z["grid"],
            L_grid=z["L_grid"],
            cM_grid=z["cM_grid"],
            sigma=z["sigma"],
            panel=panel,
            regionStart=None if meta[0] < 0 else int(meta[0]),
            regionEnd=None if meta[1] < 0 else int(meta[1]),
            buffer=int(meta[2]),
            nGen=float(z["nGen"]),
            ref_error=float(z["ref_error"]),
            snp_is_common=z.get("snp_is_common"),
            pos_all=z.get("pos_all"),
            ref_allele_all=z.get("ref_allele_all"),
            alt_allele_all=z.get("alt_allele_all"),
            af_all=z.get("af_all"),
            rare_per_hap_info=rare_per_hap_info,
            ms_indices=ms_indices,
            grid_all=z.get("grid_all"),
            L_grid_all=z.get("L_grid_all"),
            sigma_all=z.get("sigma_all"),
            sample_names=z.get("sample_names"),
        )


def prepare_panel(
    chrom: str,
    pos: np.ndarray,
    ref_allele: np.ndarray,
    alt_allele: np.ndarray,
    haps: Optional[np.ndarray] = None,
    rhb_t: Optional[np.ndarray] = None,
    gmap_pos: Optional[np.ndarray] = None,
    gmap_cm: Optional[np.ndarray] = None,
    nGen: float = 100.0,
    expRate: float = 1.0,
    minRate: float = 0.1,
    maxRate: float = 100.0,
    ref_error: float = 0.001,
    nMaxDH: Optional[int] = None,
    regionStart: Optional[int] = None,
    regionEnd: Optional[int] = None,
    buffer: int = 0,
    impute_rare_common: bool = False,
    rare_af_threshold: float = 0.001,
    use_mspbwt: bool = False,
    mspbwt_nindices: int = 4,
    sample_names: Optional[np.ndarray] = None,
    presplit: Optional[dict] = None,
) -> PreparedReference:
    """Build a PreparedReference from an allele matrix or packed panel.

    `haps` is [K, nSNPs] 0/1; alternatively pass `rhb_t` pre-packed. With
    impute_rare_common, SNPs with panel MAF < rare_af_threshold are held out
    of the HMM (grids/compression are built on common SNPs only) and carried
    as sparse per-hap rare carrier lists (reference:
    quilt-prepare-reference.R:228-262, rare_common.R:313-322).

    `presplit` takes the streaming native ingest result
    (io.native.read_panel_vcf_packed): packed common-SNP words, allele
    frequencies, and the rare-carrier CSR — the [K, nSNPs] allele matrix is
    then never inflated on host (the reference equally streams the split in
    C++, quilt-prepare-reference.R:228-246).
    """
    pos = np.asarray(pos, dtype=np.int64)
    snp_is_common = None
    pos_all = ref_all = alt_all = None
    rare_per_hap_info = None
    if presplit is not None:
        K = int(presplit["K"])
        af_all = np.asarray(presplit["af_all"], dtype=np.float64)
        rhb_t_common = presplit["rhb_t"]
        if impute_rare_common:
            snp_is_common = np.asarray(presplit["snp_is_common"], dtype=bool)
            rare_flat = np.asarray(presplit["rare_flat"], dtype=np.int64)
            rare_offsets = np.asarray(presplit["rare_offsets"], dtype=np.int64)
            rare_idx = np.flatnonzero(~snp_is_common)
            # per-SNP carrier CSR -> per-hap rare-SNP lists
            snp_of = np.repeat(rare_idx, np.diff(rare_offsets))
            order = np.argsort(rare_flat, kind="stable")
            hap_sorted = rare_flat[order]
            snp_sorted = snp_of[order]
            bounds = np.searchsorted(hap_sorted, np.arange(K + 1))
            rare_per_hap_info = [
                snp_sorted[bounds[k]:bounds[k + 1]] for k in range(K)
            ]
            pos_all, ref_all, alt_all = pos, ref_allele, alt_allele
            pos = pos[snp_is_common]
            ref_allele = np.asarray(ref_allele)[snp_is_common]
            alt_allele = np.asarray(alt_allele)[snp_is_common]
            af = af_all[snp_is_common]
        else:
            af = af_all
        nSNPs = len(pos)
    else:
        if haps is None:
            assert rhb_t is not None
            haps = unpack_bits_32(rhb_t, len(pos))
        K = haps.shape[0]
        af_all = haps.mean(axis=0).astype(np.float64)

        if impute_rare_common:
            maf = np.minimum(af_all, 1 - af_all)
            snp_is_common = maf >= rare_af_threshold
            # rare carriers, per haplotype, as indices into the ALL-SNP axis
            rare_idx = np.flatnonzero(~snp_is_common)
            rare_per_hap_info = [
                rare_idx[haps[k, rare_idx] == 1].astype(np.int64)
                for k in range(K)
            ]
            pos_all, ref_all, alt_all = pos, ref_allele, alt_allele
            af_full = af_all
            pos = pos[snp_is_common]
            ref_allele = np.asarray(ref_allele)[snp_is_common]
            alt_allele = np.asarray(alt_allele)[snp_is_common]
            haps = haps[:, snp_is_common]
            af = af_full[snp_is_common]
        else:
            af = af_all

        nSNPs = haps.shape[1]
        rhb_t_common = pack_bits_32(haps)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    cM_grid = interpolate_genetic_map(gmap_pos, gmap_cm, L_grid, expRate)
    sigma = sigma_from_cm_grid(nGen, cM_grid, L_grid, expRate, minRate, maxRate)
    grid_all = L_grid_all = sigma_all = None
    if impute_rare_common:
        grid_all, L_grid_all, _ = assign_positions_to_grid(pos_all)
        cM_grid_all = interpolate_genetic_map(
            gmap_pos, gmap_cm, L_grid_all, expRate
        )
        sigma_all = sigma_from_cm_grid(
            nGen, cM_grid_all, L_grid_all, expRate, minRate, maxRate
        )
    panel = compress_panel(rhb_t_common, nSNPs, ref_error=ref_error, nMaxDH=nMaxDH)
    ms_indices = None
    if use_mspbwt:
        from .mspbwt import build_mspbwt_indices
        ms_indices = build_mspbwt_indices(panel.hapMatcher, mspbwt_nindices)
    print_message(
        f"Prepared panel: K={K}, nSNPs={nSNPs}, nGrids={nGrids}, "
        f"escapes={len(panel.esc_k)}"
    )
    return PreparedReference(
        chrom=chrom,
        pos=pos,
        ref_allele=np.asarray(ref_allele),
        alt_allele=np.asarray(alt_allele),
        rhb_t=rhb_t_common,
        af=af,
        grid=grid,
        L_grid=L_grid,
        cM_grid=cM_grid,
        sigma=sigma,
        panel=panel,
        regionStart=regionStart,
        regionEnd=regionEnd,
        buffer=buffer,
        nGen=nGen,
        ref_error=ref_error,
        snp_is_common=snp_is_common,
        pos_all=pos_all,
        ref_allele_all=ref_all,
        alt_allele_all=alt_all,
        af_all=af_all if impute_rare_common else None,
        rare_per_hap_info=rare_per_hap_info,
        ms_indices=ms_indices,
        grid_all=grid_all,
        L_grid_all=L_grid_all,
        sigma_all=sigma_all,
        sample_names=None if sample_names is None
        else np.asarray(sample_names, dtype=str),
    )


def truncate_panel(prep: PreparedReference, panel_size: int) -> PreparedReference:
    """Use only the first panel_size reference haplotypes (reference:
    quilt.R:544-549 slices rhb_t and reference_samples after loading the
    prepared reference). The distinct-hap compression is rebuilt on the
    truncated panel; allele frequencies are recomputed; mspbwt indices (if
    present) are rebuilt since their prefix orderings cover all K haps."""
    from dataclasses import replace

    rhb_t = prep.rhb_t[:panel_size]
    panel = compress_panel(
        rhb_t, prep.nSNPs, ref_error=prep.ref_error, nMaxDH=prep.panel.nMaxDH
    )
    bits = unpack_bits_32(rhb_t, prep.nSNPs)
    af = bits.mean(axis=0)
    ms_indices = None
    if prep.ms_indices is not None:
        from .mspbwt import build_mspbwt_indices
        ms_indices = build_mspbwt_indices(
            panel.hapMatcher, n_indices=len(prep.ms_indices)
        )
    rare_info = (
        prep.rare_per_hap_info[:panel_size]
        if prep.rare_per_hap_info is not None else None
    )
    names = (
        prep.sample_names[: panel_size // 2]
        if prep.sample_names is not None else None
    )
    return replace(
        prep, rhb_t=rhb_t, panel=panel, af=af, ms_indices=ms_indices,
        rare_per_hap_info=rare_info, sample_names=names,
    )
