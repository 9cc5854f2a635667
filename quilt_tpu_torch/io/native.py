"""ctypes bindings for the native IO engine (quilt_tpu_torch/native/quilt_io.cpp).

Builds libquilt_io.so with g++ on first use (cached next to the source);
every entry point has a pure-Python fallback (io/vcf.py, io/bam.py), so the
framework degrades gracefully where no compiler exists. Parity between the
two implementations is enforced by tests/test_torch_hostcopy.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from ..utils import print_message

_LIB = None
_TRIED = False


def _build_lib() -> Optional[str]:
    src_dir = os.path.join(os.path.dirname(__file__), "..", "native")
    src = os.path.abspath(os.path.join(src_dir, "quilt_io.cpp"))
    out = os.path.abspath(os.path.join(src_dir, "libquilt_io.so"))
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             src, "-o", out, "-lz"],
            check=True, capture_output=True, timeout=120,
        )
        print_message(f"Built native IO library {out}")
        return out
    except Exception as e:  # no compiler / failed build -> Python fallback
        print_message(f"Native IO build unavailable ({e}); using Python IO")
        return None


def get_lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build_lib()
        if path:
            lib = ctypes.CDLL(path)
            lib.qio_read_gzip.restype = ctypes.c_void_p
            lib.qio_read_gzip.argtypes = [ctypes.c_char_p]
            lib.qio_buffer_size.restype = ctypes.c_int64
            lib.qio_buffer_size.argtypes = [ctypes.c_void_p]
            lib.qio_buffer_data.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.qio_buffer_data.argtypes = [ctypes.c_void_p]
            lib.qio_buffer_free.argtypes = [ctypes.c_void_p]
            lib.qio_vcf_panel.restype = ctypes.c_void_p
            lib.qio_vcf_panel.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64,
            ]
            for fn in ("qio_panel_n_snps", "qio_panel_n_haps",
                       "qio_panel_n_skipped", "qio_panel_n_samples"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.qio_panel_fill.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.qio_panel_sample_name.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.qio_panel_free.argtypes = [ctypes.c_void_p]
            lib.qio_panel_used_index.restype = ctypes.c_int
            lib.qio_panel_used_index.argtypes = [ctypes.c_void_p]
            lib.qio_panel_sites.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_char_p,
            ]
            lib.qio_panel_alt_counts.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.qio_panel_pack.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.qio_panel_rare_carriers.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.qio_bam_extract.restype = ctypes.c_void_p
            lib.qio_bam_extract.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.qio_reads_used_index.restype = ctypes.c_int
            lib.qio_reads_used_index.argtypes = [ctypes.c_void_p]
            lib.qio_reads_n.restype = ctypes.c_int
            lib.qio_reads_n.argtypes = [ctypes.c_void_p]
            lib.qio_reads_n_bases.restype = ctypes.c_int64
            lib.qio_reads_n_bases.argtypes = [ctypes.c_void_p]
            lib.qio_reads_n_records.restype = ctypes.c_int
            lib.qio_reads_n_records.argtypes = [ctypes.c_void_p]
            lib.qio_reads_fill.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.qio_reads_free.argtypes = [ctypes.c_void_p]
            lib.qio_mspbwt_build.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.qio_compress_panel.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            # stale-binary guard: the committed .so may predate these
            # bindings when no compiler is available to rebuild it
            try:
                lib.qio_abi_version.restype = ctypes.c_int64
                if lib.qio_abi_version() < 3:
                    raise OSError("abi too old")
            except (AttributeError, OSError):
                print_message(
                    "Native IO library predates these bindings and no "
                    "rebuild happened; using Python IO"
                )
                return None
            _LIB = lib
    return _LIB


def mspbwt_build_native(hm: np.ndarray, grids: np.ndarray, egs: int,
                        want_occ: bool = True):
    """Native fast path of panel.mspbwt.build_mspbwt_indices's per-index
    loop. Returns (Y, C, cp_cols, A_cp, occ); occ is the per-column stable
    argsort (occurrence lists per symbol bucket) used for O(log K) rank
    queries, or None when not requested."""
    lib = get_lib()
    assert lib is not None
    hm = np.ascontiguousarray(hm, dtype=np.uint8)
    grids = np.ascontiguousarray(grids, dtype=np.int32)
    K, nGrids = hm.shape
    T = len(grids)
    cp_cols = np.array(
        sorted({t for t in range(egs - 1, T, egs)} | {T - 1}),
        dtype=np.int32,
    )
    Y = np.empty((T, K), dtype=np.uint8)
    C = np.zeros((T, 257), dtype=np.int32)
    A_cp = np.empty((len(cp_cols), K), dtype=np.int32)
    occ = np.empty((T, K), dtype=np.int32) if want_occ else None
    lib.qio_mspbwt_build(
        hm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        K, nGrids,
        grids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        T, egs,
        Y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        C.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        A_cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cp_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(cp_cols),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if occ is not None else None,
    )
    return Y, C, cp_cols, A_cp, occ


def compress_panel_native(rhb_t: np.ndarray, nMaxDH: int, n_threads: int = 0):
    """Native distinct-haplotype compression (qio_compress_panel).
    Returns (hapMatcher uint8 [K, nGrids], distinctB uint32 [nMaxDH, nGrids])
    identical to the NumPy per-grid np.unique path."""
    lib = get_lib()
    assert lib is not None
    rhb_t = np.ascontiguousarray(rhb_t, dtype=np.uint32)
    K, nGrids = rhb_t.shape
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    hapMatcher = np.zeros((K, nGrids), dtype=np.uint8)
    distinctB = np.zeros((nMaxDH, nGrids), dtype=np.uint32)
    lib.qio_compress_panel(
        rhb_t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        K, nGrids, nMaxDH, n_threads,
        hapMatcher.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        distinctB.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return hapMatcher, distinctB


def native_available() -> bool:
    return get_lib() is not None


def read_panel_vcf_native(
    path: str,
    region_chrom: Optional[str] = None,
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
):
    """Native fast path of io.vcf.read_panel_vcf (no sample selection;
    the caller subsets haplotype rows afterwards if needed)."""
    lib = get_lib()
    assert lib is not None
    h = lib.qio_vcf_panel(
        path.encode(),
        (region_chrom or "").encode(),
        -1 if region_start is None else region_start,
        -1 if region_end is None else region_end,
    )
    if not h:
        raise IOError(f"native VCF parse failed for {path}")
    try:
        n_snps = lib.qio_panel_n_snps(h)
        n_haps = lib.qio_panel_n_haps(h)
        n_skipped = lib.qio_panel_n_skipped(h)
        n_samples = lib.qio_panel_n_samples(h)
        if n_snps == 0:
            raise ValueError(f"No usable variants found in {path}")
        n_grids = (n_snps + 31) // 32
        pos = np.zeros(n_snps, dtype=np.int64)
        ref = np.zeros(n_snps, dtype="S1")
        alt = np.zeros(n_snps, dtype="S1")
        rhb_t = np.zeros((n_haps, n_grids), dtype=np.uint32)
        lib.qio_panel_fill(
            h,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ref.ctypes.data_as(ctypes.c_char_p),
            alt.ctypes.data_as(ctypes.c_char_p),
            rhb_t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        names: List[str] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(n_samples):
            lib.qio_panel_sample_name(h, i, buf, 256)
            names.append(buf.value.decode())
        return (
            pos, ref.astype("U1"), alt.astype("U1"), rhb_t, names, n_skipped
        )
    finally:
        lib.qio_panel_free(h)


SEQ_DECODE = "=ACMGRSVTWYHKDBN"


def load_bam_reads_native(
    path: str,
    chrom: str,
    snp_pos: np.ndarray,
    ref_allele: np.ndarray,
    alt_allele: np.ndarray,
    bqFilter: int = 17,
    iSizeUpperLimit: int = 600,
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
    use_bx_tag: bool = True,
    bxTagUpperLimit: int = 50000,
    useSoftClippedBases: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Native fast path of io.bam.load_bam_reads: returns flat
    (u, bq, offsets, used_index); grid snapping / downsampling happen in
    Python. With region bounds and a .bai/.csi index present, only the
    overlapping BGZF chunks of the BAM are read (htslib-equivalent region
    query; reference relies on STITCH/htslib, QUILT/R/quilt.R:237-238)."""
    lib = get_lib()
    assert lib is not None
    snp_pos = np.ascontiguousarray(snp_pos, dtype=np.int64)
    ref_code = np.array(
        [SEQ_DECODE.index(str(a)) for a in ref_allele], dtype=np.uint8
    )
    alt_code = np.array(
        [SEQ_DECODE.index(str(a)) for a in alt_allele], dtype=np.uint8
    )
    h = lib.qio_bam_extract(
        path.encode(), chrom.encode(),
        -1 if region_start is None else int(region_start),
        -1 if region_end is None else int(region_end),
        snp_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        alt_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(snp_pos), bqFilter, iSizeUpperLimit,
        1 if use_bx_tag else 0, bxTagUpperLimit,
        1 if useSoftClippedBases else 0,
    )
    if not h:
        raise IOError(f"native BAM parse failed for {path}")
    try:
        n_reads = lib.qio_reads_n(h)
        n_bases = lib.qio_reads_n_bases(h)
        used_index = bool(lib.qio_reads_used_index(h))
        u = np.zeros(n_bases, dtype=np.int32)
        bq = np.zeros(n_bases, dtype=np.int16)
        offsets = np.zeros(n_reads + 1, dtype=np.int64)
        if n_bases:
            lib.qio_reads_fill(
                h,
                u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                bq.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        return u, bq, offsets, used_index
    finally:
        lib.qio_reads_free(h)


def read_panel_vcf_packed(
    path: str,
    region_chrom: Optional[str] = None,
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
    rare_af_threshold: Optional[float] = None,
):
    """Streaming packed panel ingest: the [K, nSNPs] allele matrix is never
    inflated on host. Returns a dict with all-SNP sites + allele frequencies
    and the packed common-SNP words; with rare_af_threshold set, also the
    rare/common split (snp_is_common mask + per-rare-SNP carrier CSR), the
    streaming equivalent of the reference's two-stage prepare
    (quilt-prepare-reference.R:228-262).
    """
    lib = get_lib()
    assert lib is not None
    h = lib.qio_vcf_panel(
        path.encode(),
        (region_chrom or "").encode(),
        -1 if region_start is None else region_start,
        -1 if region_end is None else region_end,
    )
    if not h:
        raise IOError(f"native VCF parse failed for {path}")
    try:
        n_snps = lib.qio_panel_n_snps(h)
        n_haps = lib.qio_panel_n_haps(h)
        n_skipped = lib.qio_panel_n_skipped(h)
        n_samples = lib.qio_panel_n_samples(h)
        used_index = bool(lib.qio_panel_used_index(h))
        if n_snps == 0:
            raise ValueError(f"No usable variants found in {path}")
        pos = np.zeros(n_snps, dtype=np.int64)
        ref = np.zeros(n_snps, dtype="S1")
        alt = np.zeros(n_snps, dtype="S1")
        lib.qio_panel_sites(
            h,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ref.ctypes.data_as(ctypes.c_char_p),
            alt.ctypes.data_as(ctypes.c_char_p),
        )
        alt_cnt = np.zeros(n_snps, dtype=np.int32)
        lib.qio_panel_alt_counts(
            h, alt_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        af_all = alt_cnt.astype(np.float64) / n_haps
        snp_is_common = None
        rare_flat = rare_offsets = None
        if rare_af_threshold is not None:
            maf = np.minimum(af_all, 1.0 - af_all)
            snp_is_common = (maf >= rare_af_threshold)
            keep = np.ascontiguousarray(snp_is_common, dtype=np.uint8)
            n_common = int(snp_is_common.sum())
            rare_cnt = alt_cnt[~snp_is_common].astype(np.int64)
            rare_offsets = np.zeros(len(rare_cnt) + 1, dtype=np.int64)
            np.cumsum(rare_cnt, out=rare_offsets[1:])
            rare_flat = np.zeros(int(rare_offsets[-1]), dtype=np.int32)
            lib.qio_panel_rare_carriers(
                h,
                keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                rare_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        else:
            keep = None
            n_common = n_snps
        n_grids = (n_common + 31) // 32
        rhb_t = np.zeros((n_haps, n_grids), dtype=np.uint32)
        lib.qio_panel_pack(
            h,
            None if keep is None
            else keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rhb_t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        names: List[str] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(n_samples):
            lib.qio_panel_sample_name(h, i, buf, 256)
            names.append(buf.value.decode())
        return {
            "pos": pos,
            "ref_allele": ref.astype("U1"),
            "alt_allele": alt.astype("U1"),
            "af_all": af_all,
            "rhb_t": rhb_t,
            "snp_is_common": snp_is_common,
            "rare_flat": rare_flat,
            "rare_offsets": rare_offsets,
            "sample_names": names,
            "n_skipped": n_skipped,
            "used_index": used_index,
            "K": n_haps,
        }
    finally:
        lib.qio_panel_free(h)
