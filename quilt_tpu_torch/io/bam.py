"""BAM ingestion: aligned reads -> per-read (SNP index, signed BQ) arrays.

Functional equivalent of STITCH's loadBamAndConvert (C++/htslib; behavior
described at QUILT/R/functions.R:243-272 and the QUILT.R flag docs):
- walk each alignment's CIGAR, intersect aligned bases with the target SNP
  positions, emit signed phred quality (positive = base matches ALT,
  negative = matches REF; other bases dropped);
- drop bases with quality < bqFilter; cap base quality at mapping quality;
- skip unmapped/secondary/supplementary/duplicate/qc-fail records and
  fragments with |isize| > iSizeUpperLimit;
- merge mate pairs (same qname) into one logical read; optionally merge
  linked reads by BX tag within bxTagUpperLimit;
- downsample whole reads where coverage exceeds downsampleToCov.

Pure-Python BGZF/BAM parsing (this image has no htslib); throughput is
adequate for low-coverage inputs and will move to the C++ extension.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..out.bgzf import iter_bgzf_blocks
from ..utils import print_message
from .reads import SampleReads, downsample_reads, snap_reads_to_grid

SEQ_DECODE = "=ACMGRSVTWYHKDBN"
FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPP = 0x800
CIGAR_OPS = "MIDNSHP=X"


@dataclass
class BamRead:
    qname: str
    u: List[int]
    bq: List[int]
    bx: Optional[str] = None
    pos: int = 0


def _read_bam_stream(path: str):
    """Yield raw alignment records (bytes) from a BAM file + header refs."""
    with open(path, "rb") as fh:
        data = bytearray()
        blocks = iter_bgzf_blocks(fh)
        for b in blocks:
            data.extend(b)
            if len(data) > 1 << 16:
                break
        if data[:4] != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        off = 4
        l_text = struct.unpack_from("<i", data, off)[0]
        off += 4
        header_text = bytes(data[off:off + l_text]).decode(errors="replace")
        off += l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        refs = []
        # may need more blocks to finish header
        def ensure(n):
            nonlocal data
            while len(data) < n:
                try:
                    data.extend(next(blocks))
                except StopIteration:
                    raise ValueError("truncated BAM header")
        for _ in range(n_ref):
            ensure(off + 4)
            l_name = struct.unpack_from("<i", data, off)[0]
            off += 4
            ensure(off + l_name + 4)
            name = bytes(data[off:off + l_name - 1]).decode()
            off += l_name
            l_ref = struct.unpack_from("<i", data, off)[0]
            off += 4
            refs.append((name, l_ref))
        del data[:off]
        # alignment records
        while True:
            while len(data) < 4:
                try:
                    data.extend(next(blocks))
                except StopIteration:
                    return
            block_size = struct.unpack_from("<i", data, 0)[0]
            while len(data) < 4 + block_size:
                try:
                    data.extend(next(blocks))
                except StopIteration:
                    raise ValueError("truncated BAM record")
            yield header_text, refs, bytes(data[4:4 + block_size])
            del data[:4 + block_size]


def _iter_alignments(path: str, cram_fasta: Optional[str] = None,
                     region=None):
    """Yield (header_text, refs, parsed_record) for BAM or CRAM input;
    parsed_record matches _parse_record's tuple shape. CRAM decoding is
    native (io/cram.py); `cram_fasta` supplies the reference FASTA for
    reference-based CRAM slices (the reference's `reference` parameter,
    QUILT/R/quilt.R:14). `region` = (chrom, start1, end1) enables .crai
    container seeks for CRAM inputs (candidates; caller still filters)."""
    if path.endswith(".cram"):
        from .cram import read_cram

        header_text, refs, records = read_cram(
            path, fasta=cram_fasta or None, region=region
        )
        for r in records:
            yield header_text, refs, (
                r.ref_id, r.pos0, r.mapq, r.flag, r.l_seq, r.tlen, r.qname,
                r.cigar, r.seq_packed, r.qual, r.tags,
            )
    else:
        for header_text, refs, rec in _read_bam_stream(path):
            yield header_text, refs, _parse_record(rec)


def bam_sample_name(path: str) -> Optional[str]:
    """SM tag from the first @RG line (reference: get_sample_names)."""
    if path.endswith(".cram"):
        from .cram import read_cram

        header_text, _refs, _recs = read_cram(path, header_only=True)
        headers = [header_text]
    else:
        headers = (h for h, _refs, _rec in _read_bam_stream(path))
    for header_text in headers:
        for line in header_text.splitlines():
            if line.startswith("@RG"):
                for fieldx in line.split("\t"):
                    if fieldx.startswith("SM:"):
                        return fieldx[3:]
        return None
    return None


def _parse_record(rec: bytes):
    (refID, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
    off = 32
    qname = rec[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigar = struct.unpack_from(f"<{n_cigar}I", rec, off)
    off += 4 * n_cigar
    nseq = (l_seq + 1) // 2
    seq_bytes = rec[off:off + nseq]
    off += nseq
    qual = rec[off:off + l_seq]
    off += l_seq
    tags = rec[off:]
    return (refID, pos, mapq, flag, l_seq, tlen, qname, cigar, seq_bytes,
            qual, tags)


def _get_tag(tags: bytes, want: bytes) -> Optional[str]:
    i = 0
    n = len(tags)
    while i + 3 <= n:
        tag = tags[i:i + 2]
        typ = chr(tags[i + 2])
        i += 3
        if typ in "cC":
            val, sz = tags[i], 1
        elif typ in "sS":
            val, sz = struct.unpack_from("<H", tags, i)[0], 2
        elif typ in "iIf":
            val, sz = struct.unpack_from("<I", tags, i)[0], 4
        elif typ == "A":
            val, sz = chr(tags[i]), 1
        elif typ in "ZH":
            end = tags.index(0, i)
            val, sz = tags[i:end].decode(), end - i + 1
        elif typ == "B":
            sub = chr(tags[i])
            cnt = struct.unpack_from("<I", tags, i + 1)[0]
            szmap = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
            val, sz = None, 5 + cnt * szmap[sub]
        else:
            return None
        if tag == want and isinstance(val, str):
            return val
        i += sz
    return None


def _get_bx_tag(tags: bytes) -> Optional[str]:
    return _get_tag(tags, b"BX")


def load_bam_reads(
    path: str,
    chrom: str,
    snp_pos: np.ndarray,         # int64, sorted, 1-based
    ref_allele: np.ndarray,
    alt_allele: np.ndarray,
    grid: np.ndarray,
    bqFilter: int = 17,
    iSizeUpperLimit: int = 600,
    downsampleToCov: float = 30.0,
    use_bx_tag: bool = True,
    bxTagUpperLimit: int = 50000,
    seed: int = 1,
    cram_fasta: Optional[str] = None,
    useSoftClippedBases: bool = False,
    use_native: bool = True,
) -> SampleReads:
    nSNPs = len(snp_pos)
    # native streaming extractor (index-aware; quilt_io.cpp) for BAM inputs;
    # CRAM and no-compiler hosts use the pure-Python reader below
    if use_native and not path.endswith(".cram"):
        try:
            from .native import native_available, load_bam_reads_native
            if native_available():
                u, bq, offsets, used_index = load_bam_reads_native(
                    path, chrom, snp_pos, ref_allele, alt_allele,
                    bqFilter=bqFilter, iSizeUpperLimit=iSizeUpperLimit,
                    region_start=int(snp_pos[0]) if nSNPs else None,
                    region_end=int(snp_pos[-1]) if nSNPs else None,
                    use_bx_tag=use_bx_tag, bxTagUpperLimit=bxTagUpperLimit,
                    useSoftClippedBases=useSoftClippedBases,
                )
                us_list = [
                    u[offsets[i]:offsets[i + 1]]
                    for i in range(len(offsets) - 1)
                ]
                bq_list = [
                    bq[offsets[i]:offsets[i + 1]]
                    for i in range(len(offsets) - 1)
                ]
                reads = SampleReads.from_lists(us_list, bq_list, grid)
                rng = np.random.default_rng(seed)
                if downsampleToCov and downsampleToCov > 0:
                    reads = downsample_reads(reads, nSNPs, downsampleToCov, rng)
                snap_reads_to_grid(reads, grid)
                reads = reads.sorted_by_grid()
                print_message(
                    f"{path}: {reads.nReads} reads covering SNPs "
                    f"(native{', indexed' if used_index else ''})"
                )
                return reads
        except Exception as e:
            print_message(f"Native BAM path failed ({e}); using Python reader")
    ref_code = np.array([SEQ_DECODE.index(a) for a in ref_allele], dtype=np.uint8)
    alt_code = np.array([SEQ_DECODE.index(a) for a in alt_allele], dtype=np.uint8)
    groups: Dict[str, BamRead] = {}
    target_tid = None
    n_rec = 0
    read_region = (
        (chrom, int(snp_pos[0]), int(snp_pos[-1])) if nSNPs else None
    )
    for header_text, refs, parsed in _iter_alignments(
        path, cram_fasta, region=read_region
    ):
        if target_tid is None:
            target_tid = next(
                (i for i, (name, _l) in enumerate(refs) if name == chrom), -1
            )
        (refID, pos0, mapq, flag, l_seq, tlen, qname, cigar, seq_bytes,
         qual, tags) = parsed
        n_rec += 1
        if refID != target_tid or flag & (
            FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP | FLAG_SUPP
        ):
            continue
        if iSizeUpperLimit and tlen != 0 and abs(tlen) > iSizeUpperLimit:
            continue
        # CIGAR walk: collect (snp_index, signed bq)
        rpos = pos0          # 0-based reference position
        qpos = 0
        us: List[int] = []
        bqs: List[int] = []
        if useSoftClippedBases and cigar:
            # treat soft-clipped bases as continuing the alignment: a leading
            # S of length L aligns to [pos0 - L, pos0) (reference: STITCH
            # loadBamAndConvert's useSoftClippedBases semantics, exposed via
            # QUILT.R's useSoftClippedBases flag)
            if CIGAR_OPS[cigar[0] & 0xF] == "S":
                rpos -= cigar[0] >> 4
            cigar = tuple(
                (c & ~0xF) | CIGAR_OPS.index("M")
                if CIGAR_OPS[c & 0xF] == "S" else c
                for c in cigar
            )
        for c in cigar:
            op = c & 0xF
            ln = c >> 4
            opc = CIGAR_OPS[op]
            if opc in "M=X":
                lo = np.searchsorted(snp_pos, rpos + 1)
                hi = np.searchsorted(snp_pos, rpos + ln, side="right")
                for si in range(lo, hi):
                    offset = int(snp_pos[si] - 1 - rpos)
                    qi = qpos + offset
                    nib = seq_bytes[qi >> 1]
                    base = (nib >> 4) if qi % 2 == 0 else (nib & 0xF)
                    q = min(qual[qi], mapq)
                    if q < bqFilter:
                        continue
                    if base == alt_code[si]:
                        us.append(si)
                        bqs.append(q)
                    elif base == ref_code[si]:
                        us.append(si)
                        bqs.append(-q)
                rpos += ln
                qpos += ln
            elif opc in "DN":
                rpos += ln
            elif opc in "IS":
                qpos += ln
            # H, P consume nothing
        if not us:
            continue
        bx = _get_bx_tag(tags) if use_bx_tag else None
        key = bx if bx else qname
        g = groups.get(key)
        if g is None:
            groups[key] = BamRead(qname=key, u=us, bq=bqs, bx=bx, pos=pos0)
        else:
            if bx and abs(pos0 - g.pos) > bxTagUpperLimit:
                groups[key + f"#{pos0}"] = BamRead(
                    qname=key, u=us, bq=bqs, bx=bx, pos=pos0
                )
            else:
                g.u.extend(us)
                g.bq.extend(bqs)
    # finalize: sort bases within reads, dedupe per SNP keeping max |bq|
    us_list, bq_list = [], []
    for g in groups.values():
        u = np.asarray(g.u, dtype=np.int32)
        bq = np.asarray(g.bq, dtype=np.int16)
        order = np.argsort(u, kind="stable")
        u, bq = u[order], bq[order]
        keep = np.ones(len(u), dtype=bool)
        for i in range(1, len(u)):
            if u[i] == u[i - 1]:
                if abs(bq[i]) <= abs(bq[i - 1]):
                    keep[i] = False
                else:
                    keep[i - 1] = False
        us_list.append(u[keep])
        bq_list.append(bq[keep])
    reads = SampleReads.from_lists(us_list, bq_list, grid)
    rng = np.random.default_rng(seed)
    if downsampleToCov and downsampleToCov > 0:
        reads = downsample_reads(reads, nSNPs, downsampleToCov, rng)
    snap_reads_to_grid(reads, grid)
    reads = reads.sorted_by_grid()
    print_message(
        f"{path}: {n_rec} alignments -> {reads.nReads} reads covering SNPs"
    )
    return reads


def load_bam_sequences(
    path: str,
    chrom: str,
    start: int,
    end: int,
    min_mapq: int = 0,
):
    """Raw read sequences overlapping [start, end] (1-based), for HLA
    direct read mapping (equivalent of the samtools view extraction at
    hla_functions.R:450,544). Returns list of (qname, pos0, seq_codes,
    quals) with seq codes 0..3 = ACGT, 4 = other."""
    decode_code = {1: 0, 2: 1, 4: 2, 8: 3}
    out = []
    target_tid = None
    for header_text, refs, parsed in _iter_alignments(
        path, region=(chrom, start, end)
    ):
        if target_tid is None:
            target_tid = next(
                (i for i, (name, _l) in enumerate(refs) if name == chrom), -1
            )
        (refID, pos0, mapq, flag, l_seq, tlen, qname, cigar, seq_bytes,
         qual, tags) = parsed
        if refID != target_tid or flag & (
            FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP | FLAG_SUPP
        ):
            continue
        if mapq < min_mapq:
            continue
        if pos0 + l_seq < start - 1 or pos0 > end - 1:
            continue
        seq = np.empty(l_seq, dtype=np.uint8)
        for qi in range(l_seq):
            nib = seq_bytes[qi >> 1]
            base = (nib >> 4) if qi % 2 == 0 else (nib & 0xF)
            seq[qi] = decode_code.get(base, 4)
        out.append((qname, pos0, seq, np.frombuffer(qual, dtype=np.uint8)))
    return out


_PRIMARY_CHROM_NAMES = frozenset(
    [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY", "chrM"]
    + [str(i) for i in range(1, 23)] + ["X", "Y", "MT", "M"]
)


def _xa_outside_region(xa: str, chrom: str, regstart: int, regend: int,
                       l_seq: int) -> bool:
    """True when any XA alternative mapping points to another primary
    chromosome or to `chrom` outside the region (filter_that2,
    hla_functions.R:647-661)."""
    for entry in xa.rstrip(";").split(";"):
        fields = entry.split(",")
        if len(fields) < 2:
            continue
        xchrom = fields[0]
        try:
            xpos = abs(int(fields[1]))
        except ValueError:
            continue
        if xchrom in _PRIMARY_CHROM_NAMES and xchrom != chrom:
            return True
        if xchrom == chrom and (xpos < regstart - l_seq or xpos > regend):
            return True
    return False


def load_hla_alt_contig_reads(
    path: str,
    gene_name: str,
    chrom: str,
    regstart: int,
    regend: int,
    contig_names: Optional[Sequence[str]] = None,
):
    """Second HLA read source: reads mapped to the HLA alt contigs of the
    gene (GRCh38 ALT contigs named HLA-<allele>), filtered so that reads
    whose mate or alternative mapping points elsewhere in the genome are
    dropped.

    Functional equivalent of get_that2 (hla_functions.R:544-612: samtools
    view over the "HLA-<gene>" contigs listed in the refseq file) +
    filter_that2 (:614-669: drop reads whose mate maps to another primary
    chromosome, whose mate maps to `chrom` outside [regstart-1000,
    regend+1000], or whose XA alternative mappings point outside the gene
    region). These reads carry no usable genomic position — typing places
    them on the allele alignment by kmer seeding (hla/typing.py).

    Returns list of (qname, seq_codes uint8 0..4, quals uint8)."""
    decode_code = {1: 0, 2: 1, 4: 2, 8: 3}
    prefix = f"HLA-{gene_name}"
    want: Optional[set] = set(contig_names) if contig_names else None
    out = []
    if path.endswith(".cram"):
        # CRAM source: header pass resolves the alt-contig names, then a
        # .crai-indexed (or container-skipping) pass decodes only those
        # containers; mate/XA filters mirror the BAM branch below
        from .cram import read_cram

        _h, refs, _r = read_cram(path, header_only=True)
        names = {
            nm for nm, _l in refs
            if (nm in want if want is not None else nm.startswith(prefix))
        }
        if not names:
            return []
        tid_ok = {i for i, (nm, _l) in enumerate(refs) if nm in names}
        _h, refs, records = read_cram(path, ref_filter=names)
        for r in records:
            if r.ref_id not in tid_ok:
                continue
            if r.flag & (FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL
                         | FLAG_DUP | FLAG_SUPP):
                continue
            if 0 <= r.next_ref < len(refs):
                mate_name = refs[r.next_ref][0]
                if mate_name in _PRIMARY_CHROM_NAMES and mate_name != chrom:
                    continue
                if mate_name == chrom and (
                    r.next_pos + 1 + r.l_seq + 1000 <= regstart
                    or r.next_pos + 1 - 1000 >= regend
                ):
                    continue
            xa = _get_tag(bytes(r.tags), b"XA")
            if xa and _xa_outside_region(xa, chrom, regstart, regend,
                                         r.l_seq):
                continue
            seq = np.empty(r.l_seq, dtype=np.uint8)
            for qi in range(r.l_seq):
                nib = r.seq_packed[qi >> 1]
                base = (nib >> 4) if qi % 2 == 0 else (nib & 0xF)
                seq[qi] = decode_code.get(base, 4)
            out.append((r.qname, seq,
                        np.frombuffer(bytes(r.qual), dtype=np.uint8)))
        return out
    match_tids = None
    refs_cache = None
    for header_text, refs, rec in _read_bam_stream(path):
        if match_tids is None or refs is not refs_cache:
            refs_cache = refs
            match_tids = {
                i for i, (name, _l) in enumerate(refs)
                if (name in want if want is not None
                    else name.startswith(prefix))
            }
            if not match_tids:
                return []
        (refID, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        if refID not in match_tids:
            continue
        if flag & (FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL
                   | FLAG_DUP | FLAG_SUPP):
            continue
        # mate filters (filter_that2 :634-646)
        if 0 <= next_ref < len(refs):
            mate_name = refs[next_ref][0]
            if mate_name in _PRIMARY_CHROM_NAMES and mate_name != chrom:
                continue
            if mate_name == chrom and (
                next_pos + 1 + l_seq + 1000 <= regstart
                or next_pos + 1 - 1000 >= regend
            ):
                continue
        off = 32
        qname = rec[off:off + l_read_name - 1].decode()
        off += l_read_name + 4 * n_cigar
        nseq = (l_seq + 1) // 2
        seq_bytes = rec[off:off + nseq]
        off += nseq
        qual = rec[off:off + l_seq]
        tags = rec[off + l_seq:]
        # alternative-mapping filter (filter_that2 :647-661): XA entries on
        # another primary chromosome, or on `chrom` outside the region
        xa = _get_tag(bytes(tags), b"XA")
        if xa and _xa_outside_region(xa, chrom, regstart, regend, l_seq):
            continue
        seq = np.empty(l_seq, dtype=np.uint8)
        for qi in range(l_seq):
            nib = seq_bytes[qi >> 1]
            base = (nib >> 4) if qi % 2 == 0 else (nib & 0xF)
            seq[qi] = decode_code.get(base, 4)
        out.append((qname, seq, np.frombuffer(bytes(qual), dtype=np.uint8)))
    return out


def bam_chromosome_length(path: str, chrom: str) -> Optional[int]:
    """Chromosome length from the BAM/CRAM header @SQ lines (equivalent of
    quilt_get_chromosome_length, copied_from_stitch.R:49-69; used at
    quilt.R:646 to clamp the buffered region end)."""
    if path.endswith(".cram"):
        from .cram import read_cram
        _header, refs, _recs = read_cram(path, header_only=True)
    else:
        refs = None
        for _h, r, _rec in _read_bam_stream(path):
            refs = r
            break
        if refs is None:  # header-only BAM (no alignments)
            import struct as _struct
            with open(path, "rb") as fh:
                from ..out.bgzf import iter_bgzf_blocks
                data = bytearray()
                for b in iter_bgzf_blocks(fh):
                    data.extend(b)
                    if len(data) > (1 << 20):
                        break
            if data[:4] != b"BAM\x01":
                return None
            off = 4
            l_text = _struct.unpack_from("<i", data, off)[0]
            off += 4 + l_text
            n_ref = _struct.unpack_from("<i", data, off)[0]
            off += 4
            refs = []
            for _ in range(n_ref):
                l_name = _struct.unpack_from("<i", data, off)[0]
                off += 4
                name = bytes(data[off:off + l_name - 1]).decode()
                off += l_name
                l_ref = _struct.unpack_from("<i", data, off)[0]
                off += 4
                refs.append((name, l_ref))
    for name, length in refs or []:
        if name == chrom:
            return int(length)
    return None
