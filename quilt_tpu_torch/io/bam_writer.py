"""Minimal BAM writer for tests and simulators.

Fills the role of STITCH::make_acceptance_test_data_package's BAM
fabrication (used by the reference's acceptance tests,
test-acceptance-one.R:18-37): write simple fully-matching alignments so the
BAM ingestion path can be exercised without htslib.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from ..out.bgzf import BgzfWriter

SEQ_ENCODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


class BamWriter:
    def __init__(self, path: str, chrom: str, chrom_len: int,
                 sample_name: str = "SAMPLE", index: bool = False,
                 extra_contigs: Optional[Sequence[Tuple[str, int]]] = None):
        """`extra_contigs` adds further reference sequences (e.g. HLA alt
        contigs) after the primary chrom; target them in write_read with
        tid >= 1."""
        self._path = path
        contigs = [(chrom, chrom_len)] + list(extra_contigs or [])
        self._idx = None
        if index:
            from ..out.tabix import BaiIndexer
            self._idx = BaiIndexer(len(contigs))
        self._w = BgzfWriter(path)
        sq_lines = "".join(
            f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in contigs
        )
        header_text = (
            f"@HD\tVN:1.6\tSO:coordinate\n"
            f"{sq_lines}"
            f"@RG\tID:rg1\tSM:{sample_name}\n"
        ).encode()
        buf = b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
        buf += struct.pack("<i", len(contigs))
        for name, ln in contigs:
            name_b = name.encode() + b"\x00"
            buf += struct.pack("<i", len(name_b)) + name_b
            buf += struct.pack("<i", ln)
        self._w.write(buf)

    def write_read(
        self,
        qname: str,
        pos0: int,                 # 0-based leftmost position
        seq: str,
        quals: Sequence[int],
        mapq: int = 60,
        flag: int = 0,
        tlen: int = 0,
        bx: Optional[str] = None,
        cigar_ops: Optional[Sequence] = None,   # [(op_char, length)]
        tid: int = 0,
        next_tid: int = -1,
        next_pos: int = -1,
        xa: Optional[str] = None,               # XA:Z alt-mapping string
    ) -> None:
        l_seq = len(seq)
        name_b = qname.encode() + b"\x00"
        if cigar_ops is None:
            cigar = struct.pack("<I", (l_seq << 4) | 0)     # "{l}M"
        else:
            OPS = "MIDNSHP=X"
            cigar = b"".join(
                struct.pack("<I", (ln << 4) | OPS.index(op))
                for op, ln in cigar_ops
            )
        seq_b = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq):
            nib = SEQ_ENCODE.get(c, 15)
            if i % 2 == 0:
                seq_b[i >> 1] |= nib << 4
            else:
                seq_b[i >> 1] |= nib
        qual_b = bytes(min(int(q), 93) for q in quals)
        tags = b""
        if bx is not None:
            tags += b"BXZ" + bx.encode() + b"\x00"
        if xa is not None:
            tags += b"XAZ" + xa.encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHiiii",
            tid, pos0, len(name_b), mapq,
            4680, len(cigar) // 4, flag, l_seq,
            next_tid, next_pos, tlen,
        ) + name_b + cigar + bytes(seq_b) + qual_b + tags
        vbeg = self._w.tell_virtual()
        self._w.write(struct.pack("<i", len(rec)) + rec)
        if self._idx is not None:
            # reference span from the cigar (M/D/N/=/X consume reference)
            if cigar_ops is None:
                span = l_seq
            else:
                span = sum(ln for op, ln in cigar_ops if op in "MDN=X")
            self._idx.add(tid, pos0, pos0 + max(span, 1),
                          vbeg, self._w.tell_virtual())

    def close(self):
        self._w.close()
        if self._idx is not None:
            self._idx.write(self._path + ".bai")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_panel_vcf(
    path: str,
    chrom: str,
    pos,
    ref_allele,
    alt_allele,
    haps,                        # [K, nSNPs], K even (pairs of haplotypes)
    sample_prefix: str = "REF",
    sample_names=None,
    index: bool = False,
) -> None:
    """Write a phased reference-panel VCF (bgzipped); with index=True also
    emit a tabix .tbi so the native indexed region reader can seek."""
    idx = None
    if index:
        from ..out.tabix import TabixIndexer
        idx = TabixIndexer()
    K, nSNPs = haps.shape
    assert K % 2 == 0
    n_samp = K // 2
    names = (list(sample_names) if sample_names is not None
             else [f"{sample_prefix}{i}" for i in range(n_samp)])
    assert len(names) == n_samp
    with BgzfWriter(path) as w:
        w.write("##fileformat=VCFv4.2\n")
        w.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        w.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(names) + "\n"
        )
        for s in range(nSNPs):
            gts = "\t".join(
                f"{haps[2 * i, s]}|{haps[2 * i + 1, s]}" for i in range(n_samp)
            )
            vbeg = w.tell_virtual()
            w.write(
                f"{chrom}\t{pos[s]}\t.\t{ref_allele[s]}\t{alt_allele[s]}"
                f"\t.\tPASS\t.\tGT\t{gts}\n"
            )
            if idx is not None:
                idx.add(str(chrom), int(pos[s]), vbeg, w.tell_virtual())
    if idx is not None:
        idx.write(path + ".tbi")
