"""Tabix (.tbi) index writer for the bgzipped output VCF.

Replaces the reference's `tabix -f` shell-out (QUILT/R/writers.R:123-127).
Implements the TBI format from the htslib tabix spec: R-tree binning
(identical to BAM's reg2bin) over virtual file offsets
((compressed_block_offset << 16) | within_block_offset).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .bgzf import BgzfWriter


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class TabixIndexer:
    """Collects (chrom, pos, virtual_start, virtual_end) while a VCF is
    written, then emits the .tbi file."""

    def __init__(self):
        self.names: List[str] = []
        self._name_id: Dict[str, int] = {}
        # per ref: bin -> list of (vbeg, vend)
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        # per ref: linear 16kb-interval index: min virtual offset
        self.linear: List[Dict[int, int]] = []

    def add(self, chrom: str, pos1: int, vbeg: int, vend: int) -> None:
        if chrom not in self._name_id:
            self._name_id[chrom] = len(self.names)
            self.names.append(chrom)
            self.bins.append({})
            self.linear.append({})
        rid = self._name_id[chrom]
        beg0 = pos1 - 1
        b = reg2bin(beg0, pos1)
        chunks = self.bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        win = beg0 >> 14
        cur = self.linear[rid].get(win)
        if cur is None or vbeg < cur:
            self.linear[rid][win] = vbeg

    def write(self, path: str, col_seq: int = 1, col_beg: int = 2,
              col_end: int = 0, meta_char: str = "#", skip: int = 0) -> None:
        payload = bytearray()
        payload += b"TBI\x01"
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        payload += struct.pack(
            "<8i", len(self.names), 2, col_seq, col_beg, col_end,
            ord(meta_char), skip, len(names_blob),
        )
        payload += names_blob
        for rid in range(len(self.names)):
            bins = self.bins[rid]
            payload += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                payload += struct.pack("<Ii", b, len(chunks))
                for vbeg, vend in chunks:
                    payload += struct.pack("<QQ", vbeg, vend)
            lin = self.linear[rid]
            n_intv = (max(lin) + 1) if lin else 0
            payload += struct.pack("<i", n_intv)
            prev = 0
            for i in range(n_intv):
                v = lin.get(i, prev)
                prev = v
                payload += struct.pack("<Q", v)
        with BgzfWriter(path) as w:
            w.write(bytes(payload))


class BaiIndexer:
    """BAI (.bai) index writer: identical binning to tabix over BAM
    records, stored as a raw (non-bgzipped) file (SAM spec section 5.2).
    Lets fabricated test/simulation BAMs exercise the native indexed
    region reader (quilt_io.cpp) the way real htslib-indexed BAMs do."""

    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(n_ref)
        ]
        self.linear: List[Dict[int, int]] = [{} for _ in range(n_ref)]

    def add(self, tid: int, beg0: int, end0: int, vbeg: int, vend: int):
        b = reg2bin(beg0, end0)
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        for win in range(beg0 >> 14, (max(beg0, end0 - 1) >> 14) + 1):
            cur = self.linear[tid].get(win)
            if cur is None or vbeg < cur:
                self.linear[tid][win] = vbeg

    def write(self, path: str) -> None:
        payload = bytearray()
        payload += b"BAI\x01"
        payload += struct.pack("<i", self.n_ref)
        for tid in range(self.n_ref):
            bins = self.bins[tid]
            payload += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                payload += struct.pack("<Ii", b, len(chunks))
                for vbeg, vend in chunks:
                    payload += struct.pack("<QQ", vbeg, vend)
            lin = self.linear[tid]
            n_intv = (max(lin) + 1) if lin else 0
            payload += struct.pack("<i", n_intv)
            prev = 0
            for i in range(n_intv):
                v = lin.get(i, prev)
                prev = v
                payload += struct.pack("<Q", v)
        with open(path, "wb") as fh:
            fh.write(bytes(payload))
