"""Native CRAM 3.0 reader/writer (no htslib dependency).

Replaces the reference's CRAM ingestion, which it inherits from htslib via
STITCH::loadBamAndConvert (SURVEY §2.9; exercised by
QUILT/tests/testthat/test-acceptance-cram.R). Scope (documented):

- Container / block layer: full CRAM 3.0 framing (ITF-8 / LTF-8 integers,
  gzip and rANS4x8 order-0/1 block codecs, raw blocks).
- Record layer: the standard data series (BF CF RI RL AP RG RN MF NS NP TS
  NF TL FN FC FP BS IN DL BA BB QQ QS SC HC PD RS MQ) with EXTERNAL,
  HUFFMAN (canonical, incl. 0-bit constants), BETA, BYTE_ARRAY_LEN and
  BYTE_ARRAY_STOP encodings; core-block bit stream for the non-external
  codecs.
- Sequence reconstruction against a reference FASTA (`fasta=` argument, as
  samtools requires for CRAM), an embedded-reference block, or
  referenceless slices (RR=false) whose bases are carried by features.
- The writer (`CramWriter`) emits referenceless single-slice containers
  with detached mate info — enough to round-trip the simulator's reads and
  drive the CRAM acceptance path end-to-end (mirror of
  test-acceptance-cram.R, which builds CRAMs with samtools).

bzip2/lzma blocks decode via the stdlib. Unsupported (raise): CRAM 2.x and
the 3.1 codecs (rANS Nx16, name tokenizer, fqzcomp); MD5 / CRC verification
is skipped on read.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# varint codecs
# ---------------------------------------------------------------------------


def read_itf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        v, off = b0, off + 1
    elif b0 < 0xC0:
        v = (b0 & 0x3F) << 8 | buf[off + 1]
        off += 2
    elif b0 < 0xE0:
        v = (b0 & 0x1F) << 16 | buf[off + 1] << 8 | buf[off + 2]
        off += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24 | buf[off + 1] << 16 | buf[off + 2] << 8
             | buf[off + 3])
        off += 4
    else:
        v = ((b0 & 0x0F) << 28 | buf[off + 1] << 20 | buf[off + 2] << 12
             | buf[off + 3] << 4 | (buf[off + 4] & 0x0F))
        off += 5
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | v >> 8, v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | v >> 16, v >> 8 & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | v >> 24, v >> 16 & 0xFF, v >> 8 & 0xFF, v & 0xFF])
    return bytes([0xF0 | v >> 28 & 0x0F, v >> 20 & 0xFF, v >> 12 & 0xFF,
                  v >> 4 & 0xFF, v & 0x0F])


def read_ltf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    n = 0
    while n < 8 and b0 & (0x80 >> n):
        n += 1
    if n == 0:
        return b0, off + 1
    if n < 8:
        v = b0 & (0xFF >> n)
        for i in range(n):
            v = v << 8 | buf[off + 1 + i]
    else:
        v = 0
        for i in range(8):
            v = v << 8 | buf[off + 1 + i]
    if v >= 1 << 63:
        v -= 1 << 64
    return v, off + 1 + n


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    # n extra bytes encode values below 2^(7*(n+1)) for n in 1..7
    for n in range(1, 8):
        if v < 1 << (7 - n + 8 * n):
            body = v.to_bytes(n + 1, "big")
            first = body[0] | (0xFF << (8 - n) & 0xFF)
            return bytes([first]) + body[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8 decoder (block method 4; spec section 13 of CRAM 3.0)
# ---------------------------------------------------------------------------

_RANS_LOW = 1 << 23


def _rans_freq_table(buf, off):
    """Order-0 frequency table -> (cumfreq, freq, lookup), new offset."""
    freqs = [0] * 256
    sym = buf[off]
    off += 1
    rle = 0
    while True:
        f, off = read_itf8(buf, off)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = buf[off]
            off += 1
            if nxt == sym + 1:
                rle = buf[off]
                off += 1
            if nxt == 0:
                break
            sym = nxt
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    lookup = bytearray(4096)
    for i in range(256):
        for j in range(cum[i], cum[i + 1]):
            lookup[j] = i
    return cum, freqs, bytes(lookup), off


def rans_encode0(data: bytes) -> bytes:
    """Order-0 rANS 4x8 encoder (counterpart of rans_decode order 0)."""
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    # normalize to total 4096, keeping every present symbol >= 1
    present = [i for i in range(256) if counts[i]]
    freqs = [0] * 256
    total = sum(counts)
    acc = 0
    for i in present:
        f = max(1, counts[i] * 4096 // total)
        freqs[i] = f
        acc += f
    # fix rounding drift on the most frequent symbol
    freqs[max(present, key=lambda i: freqs[i])] += 4096 - acc
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    # frequency table serialization (the RLE grammar the decoder reads:
    # symbol byte, ITF-8 freq; a following byte equal to symbol+1 starts a
    # run whose length byte covers that many consecutive symbols)
    tbl = bytearray()
    idx = 0
    while idx < len(present):
        sym = present[idx]
        run = 0
        while (idx + 1 + run < len(present)
               and present[idx + 1 + run] == sym + 1 + run):
            run += 1
        tbl.append(sym)
        tbl += write_itf8(freqs[sym])
        if run:
            # run byte counts the symbols after the first run symbol
            tbl.append(sym + 1)
            tbl.append(run - 1)
            for j in range(run):
                tbl += write_itf8(freqs[sym + 1 + j])
        idx += 1 + run
    tbl.append(0)
    # encode in reverse; stream j handles indices i with i % 4 == j
    states = [_RANS_LOW] * 4
    out_rev = bytearray()
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = data[i]
        f = freqs[s]
        x = states[j]
        x_max = ((_RANS_LOW >> 12) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = (x // f << 12) + cum[s] + x % f
    body = bytes(tbl) + struct.pack("<4I", *states) + bytes(out_rev[::-1])
    return (bytes([0]) + struct.pack("<i", len(body))
            + struct.pack("<i", n) + body)


def rans_decode(data: bytes) -> bytes:
    order = data[0]
    # int32 compressed size, int32 raw size
    n_out = struct.unpack_from("<i", data, 5)[0]
    off = 9
    out = bytearray(n_out)
    if order == 0:
        cum, freqs, lookup, off = _rans_freq_table(data, off)
        states = list(struct.unpack_from("<4I", data, off))
        off += 16
        for i in range(n_out):
            j = i & 3
            x = states[j]
            f = x & 0xFFF
            s = lookup[f]
            out[i] = s
            x = freqs[s] * (x >> 12) + f - cum[s]
            while x < _RANS_LOW:
                x = (x << 8) | data[off]
                off += 1
            states[j] = x
    elif order == 1:
        # per-context tables
        cums: Dict[int, list] = {}
        freqs1: Dict[int, list] = {}
        lookups: Dict[int, bytes] = {}
        sym = data[off]
        off += 1
        rle_i = 0
        while True:
            c, f, lk, off = _rans_freq_table(data, off)
            cums[sym], freqs1[sym], lookups[sym] = c, f, lk
            if rle_i > 0:
                rle_i -= 1
                sym += 1
            else:
                nxt = data[off]
                off += 1
                if nxt == sym + 1:
                    rle_i = data[off]
                    off += 1
                if nxt == 0:
                    break
                sym = nxt
        states = list(struct.unpack_from("<4I", data, off))
        off += 16
        q = n_out // 4
        last = [0, 0, 0, 0]
        ptr = [q * k for k in range(4)]
        # interleaved streams each decode a quarter (last takes remainder)
        lens = [q, q, q, n_out - 3 * q]
        for i in range(max(lens)):
            for j in range(4):
                if i >= lens[j]:
                    continue
                x = states[j]
                ctx = last[j]
                f = x & 0xFFF
                s = lookups[ctx][f]
                out[ptr[j] + i] = s
                x = freqs1[ctx][s] * (x >> 12) + f - cums[ctx][s]
                while x < _RANS_LOW:
                    x = (x << 8) | data[off]
                    off += 1
                states[j] = x
                last[j] = s
    else:
        raise ValueError(f"unsupported rANS order {order}")
    return bytes(out)


# ---------------------------------------------------------------------------
# block / container framing
# ---------------------------------------------------------------------------

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_RANS = 4

def _eof_container() -> bytes:
    """Terminal sentinel container (ref id -1, zero records/bases), as the
    reader detects it; real htslib EOF containers match the same predicate."""
    blk = _emit_block(METHOD_RAW, CT_COMPRESSION_HEADER, 0,
                      _emit_compression_header(CompressionHeader()))
    return _emit_container(-1, 4542278, 0, 0, 0, 0, [blk])


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes


def _parse_block(buf: bytes, off: int) -> Tuple[Block, int]:
    method = buf[off]
    ctype = buf[off + 1]
    off += 2
    cid, off = read_itf8(buf, off)
    csize, off = read_itf8(buf, off)
    rsize, off = read_itf8(buf, off)
    raw = buf[off:off + csize]
    off += csize
    off += 4  # CRC32
    if method == METHOD_RAW:
        data = raw
    elif method == METHOD_GZIP:
        data = zlib.decompress(raw, 31)
    elif method == METHOD_RANS:
        data = rans_decode(raw)
    elif method == 2:
        import bz2
        data = bz2.decompress(raw)
    elif method == 3:
        import lzma
        data = lzma.decompress(raw)
    elif method in (5, 6, 7, 8):
        names = {5: "rANS Nx16", 6: "adaptive arithmetic",
                 7: "fqzcomp", 8: "name tokenizer"}
        raise ValueError(
            f"CRAM 3.1 block codec {names[method]} is not supported "
            f"(supported: raw/gzip/bzip2/lzma/rANS4x8, i.e. CRAM 3.0). "
            f"Recode the file with `samtools view -O cram,version=3.0`."
        )
    else:
        raise ValueError(f"unsupported CRAM block method {method}")
    if len(data) != rsize:
        raise ValueError("CRAM block raw size mismatch")
    return Block(method, ctype, cid, data), off


def _emit_block(method: int, ctype: int, cid: int, data: bytes) -> bytes:
    if method == METHOD_GZIP:
        comp = zlib.compressobj(6, zlib.DEFLATED, 31)
        raw = comp.compress(data) + comp.flush()
    else:
        raw = data
    out = bytes([method, ctype]) + write_itf8(cid)
    out += write_itf8(len(raw)) + write_itf8(len(data)) + raw
    out += struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF)
    return out


@dataclass
class ContainerHeader:
    length: int
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_bases: int
    n_blocks: int
    landmarks: List[int]


def _parse_container_header(fh) -> Optional[ContainerHeader]:
    head = fh.read(4)
    if len(head) < 4:
        return None
    length = struct.unpack("<i", head)[0]
    # read enough bytes for the rest of the header (bounded)
    buf = fh.read(1024)
    off = 0
    rid, off = read_itf8(buf, off)
    start, off = read_itf8(buf, off)
    span, off = read_itf8(buf, off)
    nrec, off = read_itf8(buf, off)
    counter, off = read_ltf8(buf, off)
    nbases, off = read_ltf8(buf, off)
    nblocks, off = read_itf8(buf, off)
    nl, off = read_itf8(buf, off)
    lm = []
    for _ in range(nl):
        v, off = read_itf8(buf, off)
        lm.append(v)
    off += 4  # CRC
    fh.seek(off - len(buf), 1)
    return ContainerHeader(length, rid, start, span, nrec, counter, nbases,
                           nblocks, lm)


def _emit_container(rid, start, span, nrec, counter, nbases,
                    blocks: List[bytes]) -> bytes:
    body = b"".join(blocks)
    landmarks = []
    pos = 0
    for b in blocks:
        landmarks.append(pos)
        pos += len(b)
    hdr = (write_itf8(rid) + write_itf8(start) + write_itf8(span)
           + write_itf8(nrec) + write_ltf8(counter) + write_ltf8(nbases)
           + write_itf8(len(blocks)) + write_itf8(len(landmarks))
           + b"".join(write_itf8(x) for x in landmarks))
    hdr += struct.pack("<I", zlib.crc32(hdr) & 0xFFFFFFFF)
    return struct.pack("<i", len(body)) + hdr + body


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------


@dataclass
class Encoding:
    codec: int
    # EXTERNAL
    content_id: int = -1
    # HUFFMAN
    symbols: List[int] = field(default_factory=list)
    lengths: List[int] = field(default_factory=list)
    # BETA
    offset: int = 0
    nbits: int = 0
    # BYTE_ARRAY_LEN / STOP
    len_enc: Optional["Encoding"] = None
    val_enc: Optional["Encoding"] = None
    stop_byte: int = 0
    _huff: Optional[dict] = None

    def huff_table(self):
        """Canonical Huffman code table {(len, code): symbol}."""
        if self._huff is None:
            pairs = sorted(zip(self.lengths, self.symbols))
            code = 0
            prev_len = 0
            table = {}
            for ln, sym in pairs:
                code <<= ln - prev_len
                prev_len = ln
                table[(ln, code)] = sym
                code += 1
            self._huff = table
        return self._huff


def _parse_encoding(buf: bytes, off: int) -> Tuple[Encoding, int]:
    codec, off = read_itf8(buf, off)
    plen, off = read_itf8(buf, off)
    end = off + plen
    e = Encoding(codec)
    if codec == 1:      # EXTERNAL
        e.content_id, off = read_itf8(buf, off)
    elif codec == 3:    # HUFFMAN
        n, off = read_itf8(buf, off)
        for _ in range(n):
            v, off = read_itf8(buf, off)
            e.symbols.append(v)
        n2, off = read_itf8(buf, off)
        for _ in range(n2):
            v, off = read_itf8(buf, off)
            e.lengths.append(v)
    elif codec == 4:    # BYTE_ARRAY_LEN
        e.len_enc, off = _parse_encoding(buf, off)
        e.val_enc, off = _parse_encoding(buf, off)
    elif codec == 5:    # BYTE_ARRAY_STOP
        e.stop_byte = buf[off]
        off += 1
        e.content_id, off = read_itf8(buf, off)
    elif codec == 6:    # BETA
        e.offset, off = read_itf8(buf, off)
        e.nbits, off = read_itf8(buf, off)
    elif codec == 0:    # NULL
        pass
    else:
        raise ValueError(f"unsupported CRAM encoding codec {codec}")
    return e, end


def _emit_encoding(e: Encoding) -> bytes:
    if e.codec == 1:
        params = write_itf8(e.content_id)
    elif e.codec == 3:
        params = write_itf8(len(e.symbols))
        params += b"".join(write_itf8(s) for s in e.symbols)
        params += write_itf8(len(e.lengths))
        params += b"".join(write_itf8(x) for x in e.lengths)
    elif e.codec == 4:
        params = _emit_encoding(e.len_enc) + _emit_encoding(e.val_enc)
    elif e.codec == 5:
        params = bytes([e.stop_byte]) + write_itf8(e.content_id)
    elif e.codec == 6:
        params = write_itf8(e.offset) + write_itf8(e.nbits)
    else:
        params = b""
    return write_itf8(e.codec) + write_itf8(len(params)) + params


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------


@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    rr: bool = True
    sub_matrix: bytes = b"\x00" * 5
    tag_dict: List[List[Tuple[str, str]]] = field(default_factory=list)
    series: Dict[str, Encoding] = field(default_factory=dict)
    tags: Dict[int, Encoding] = field(default_factory=dict)


def _parse_compression_header(data: bytes) -> CompressionHeader:
    ch = CompressionHeader()
    off = 0
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key = data[off:off + 2].decode()
        off += 2
        if key == "RN":
            ch.rn_preserved = data[off] != 0
            off += 1
        elif key == "AP":
            ch.ap_delta = data[off] != 0
            off += 1
        elif key == "RR":
            ch.rr = data[off] != 0
            off += 1
        elif key == "SM":
            ch.sub_matrix = data[off:off + 5]
            off += 5
        elif key == "TD":
            ln, off = read_itf8(data, off)
            blob = data[off:off + ln]
            off += ln
            for line in blob.split(b"\x00")[:-1] if blob else []:
                entry = []
                for i in range(0, len(line), 3):
                    entry.append((line[i:i + 2].decode(),
                                  chr(line[i + 2])))
                ch.tag_dict.append(entry)
            if not blob:
                ch.tag_dict.append([])
        else:
            raise ValueError(f"unknown preservation key {key}")
    if not ch.tag_dict:
        ch.tag_dict.append([])
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key = data[off:off + 2].decode()
        off += 2
        enc, off = _parse_encoding(data, off)
        ch.series[key] = enc
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key, off = read_itf8(data, off)
        enc, off = _parse_encoding(data, off)
        ch.tags[key] = enc
    return ch


def _emit_compression_header(ch: CompressionHeader) -> bytes:
    pm = b""
    entries = [
        (b"RN", bytes([1 if ch.rn_preserved else 0])),
        (b"AP", bytes([1 if ch.ap_delta else 0])),
        (b"RR", bytes([1 if ch.rr else 0])),
        (b"SM", ch.sub_matrix),
    ]
    td_blob = b""
    for entry in ch.tag_dict:
        for (tag, typ) in entry:
            td_blob += tag.encode() + typ.encode()
        td_blob += b"\x00"
    entries.append((b"TD", write_itf8(len(td_blob)) + td_blob))
    pm = write_itf8(len(entries))
    for k, v in entries:
        pm += k + v
    pm = write_itf8(len(pm)) + pm
    dm = write_itf8(len(ch.series))
    for k, e in ch.series.items():
        dm += k.encode() + _emit_encoding(e)
    dm = write_itf8(len(dm)) + dm
    tm = write_itf8(len(ch.tags))
    for k, e in ch.tags.items():
        tm += write_itf8(k) + _emit_encoding(e)
    tm = write_itf8(len(tm)) + tm
    return pm + dm + tm


# ---------------------------------------------------------------------------
# record decoding
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = v << 1 | (byte >> (7 - self.bit)) & 1
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class _SliceDecoder:
    def __init__(self, ch: CompressionHeader, core: bytes,
                 ext: Dict[int, bytes]):
        self.ch = ch
        self.core = _BitReader(core)
        self.ext = ext
        self.ptr = {k: 0 for k in ext}

    def _take(self, cid: int, n: int) -> bytes:
        p = self.ptr[cid]
        self.ptr[cid] = p + n
        return self.ext[cid][p:p + n]

    def read_int(self, e: Encoding) -> int:
        if e.codec == 1:
            # EXTERNAL ints are ITF-8 in the block stream
            buf = self.ext[e.content_id]
            v, newoff = read_itf8(buf, self.ptr[e.content_id])
            self.ptr[e.content_id] = newoff
            return v
        if e.codec == 3:
            if len(e.symbols) == 1 and e.lengths[0] == 0:
                return e.symbols[0]
            table = e.huff_table()
            ln, code = 0, 0
            while True:
                code = code << 1 | self.core.read_bits(1)
                ln += 1
                if (ln, code) in table:
                    return table[(ln, code)]
                if ln > 31:
                    raise ValueError("bad huffman stream")
        if e.codec == 6:
            return self.core.read_bits(e.nbits) - e.offset
        raise ValueError(f"unsupported int codec {e.codec}")

    def read_byte(self, e: Encoding) -> int:
        if e.codec == 1:
            return self._take(e.content_id, 1)[0]
        return self.read_int(e)

    def read_bytes(self, e: Encoding, length: Optional[int] = None) -> bytes:
        if e.codec == 5:      # BYTE_ARRAY_STOP
            buf = self.ext[e.content_id]
            p = self.ptr[e.content_id]
            q = buf.index(bytes([e.stop_byte]), p)
            self.ptr[e.content_id] = q + 1
            return buf[p:q]
        if e.codec == 4:      # BYTE_ARRAY_LEN
            n = self.read_int(e.len_enc)
            return self.read_bytes(e.val_enc, n)
        if e.codec == 1:
            if length is None:
                raise ValueError("EXTERNAL byte array needs explicit length")
            return self._take(e.content_id, length)
        raise ValueError(f"unsupported byte-array codec {e.codec}")


_BASES = b"ACGTN"


def _sub_base(sm: bytes, ref_base: int, code: int) -> int:
    """Substitution matrix decode: ref base + 2-bit code -> new base."""
    try:
        ri = _BASES.index(ref_base)
    except ValueError:
        ri = 4
    byte = sm[ri]
    alts = [b for b in _BASES if b != _BASES[ri]]
    for j, alt in enumerate(alts):
        if (byte >> (6 - 2 * j)) & 0x3 == code:
            return alt
    return ord("N")


_CIGAR_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6}


def _pack_seq(seq: bytes) -> bytes:
    """ASCII bases -> BAM 4-bit packed."""
    dec = "=ACMGRSVTWYHKDBN"
    out = bytearray((len(seq) + 1) // 2)
    for i, b in enumerate(seq):
        code = dec.find(chr(b).upper())
        if code < 0:
            code = 15
        if i % 2 == 0:
            out[i >> 1] = code << 4
        else:
            out[i >> 1] |= code
    return bytes(out)


@dataclass
class CramRecord:
    """Decoded alignment in the shape io/bam.py's _parse_record returns."""
    ref_id: int
    pos0: int
    mapq: int
    flag: int
    l_seq: int
    tlen: int
    qname: str
    cigar: Tuple[int, ...]
    seq_packed: bytes
    qual: bytes
    tags: bytes
    next_ref: int = -1      # mate ref id (detached records; NS series)
    next_pos: int = -1      # mate 0-based position (NP series)


def _decode_slice(ch, sdec, slice_rid, slice_start, n_records, counter,
                  refseq: Optional[bytes], ref_offset: int):
    S = ch.series
    records = []
    prev_ap = slice_start
    for ir in range(n_records):
        bf = sdec.read_int(S["BF"])
        cf = sdec.read_int(S["CF"])
        rid = slice_rid
        if slice_rid == -2:
            rid = sdec.read_int(S["RI"])
        rl = sdec.read_int(S["RL"])
        ap = sdec.read_int(S["AP"])
        if ch.ap_delta:
            ap += prev_ap
            prev_ap = ap
        sdec.read_int(S["RG"])
        if ch.rn_preserved:
            qname = sdec.read_bytes(S["RN"]).decode()
        else:
            qname = f"q{counter + ir}"
        tlen = 0
        next_ref, next_pos = -1, -1
        if cf & 0x2:            # detached: explicit mate info
            sdec.read_int(S["MF"])
            if not ch.rn_preserved:
                qname = sdec.read_bytes(S["RN"]).decode()
            ns = sdec.read_int(S["NS"])
            next_ref = ns if ns < 0x7FFFFFFF else -1
            next_pos = sdec.read_int(S["NP"]) - 1
            tlen = sdec.read_int(S["TS"])
        elif cf & 0x4:
            sdec.read_int(S["NF"])
        tl = sdec.read_int(S["TL"])
        tags = b""
        for (tag, typ) in ch.tag_dict[tl]:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            blob = sdec.read_bytes(ch.tags[key])
            if tag == "BX":
                tags += b"BX" + b"Z" + blob + b"\x00"
        qual = b"\xff" * rl
        if not bf & 0x4:        # mapped
            fn = sdec.read_int(S["FN"])
            # reconstruct seq + cigar from features
            seq = bytearray(rl)
            quala = bytearray(qual)
            cig: List[Tuple[int, str]] = []
            qpos = 0            # 0-based in read
            rpos = ap - 1       # 0-based in reference
            fpos = 0
            def emit_match(n):
                nonlocal qpos, rpos
                if n <= 0:
                    return
                for t in range(n):
                    if refseq is not None:
                        idx = rpos + t - ref_offset
                        seq[qpos + t] = (
                            refseq[idx] if 0 <= idx < len(refseq)
                            else ord("N")
                        )
                    else:
                        seq[qpos + t] = ord("N")
                cig.append((n, "M"))
                qpos += n
                rpos += n
            for _ in range(fn):
                fc = chr(sdec.read_byte(S["FC"]))
                dfp = sdec.read_int(S["FP"])
                fpos += dfp
                emit_match(fpos - 1 - qpos)
                if fc == "X":
                    code = sdec.read_int(S["BS"])
                    rb = (refseq[rpos - ref_offset]
                          if refseq is not None else ord("N"))
                    seq[qpos] = _sub_base(ch.sub_matrix, rb, code)
                    cig.append((1, "M"))
                    qpos += 1
                    rpos += 1
                elif fc == "B":
                    seq[qpos] = sdec.read_byte(S["BA"])
                    quala[qpos] = sdec.read_byte(S["QS"])
                    cig.append((1, "M"))
                    qpos += 1
                    rpos += 1
                elif fc == "b":
                    blob = sdec.read_bytes(S["BB"])
                    seq[qpos:qpos + len(blob)] = blob
                    cig.append((len(blob), "M"))
                    qpos += len(blob)
                    rpos += len(blob)
                elif fc == "q":
                    blob = sdec.read_bytes(S["QQ"])
                    quala[qpos:qpos + len(blob)] = blob
                elif fc == "I":
                    blob = sdec.read_bytes(S["IN"])
                    seq[qpos:qpos + len(blob)] = blob
                    cig.append((len(blob), "I"))
                    qpos += len(blob)
                elif fc == "i":
                    seq[qpos] = sdec.read_byte(S["BA"])
                    cig.append((1, "I"))
                    qpos += 1
                elif fc == "D":
                    n = sdec.read_int(S["DL"])
                    cig.append((n, "D"))
                    rpos += n
                elif fc == "S":
                    blob = sdec.read_bytes(S["SC"])
                    seq[qpos:qpos + len(blob)] = blob
                    cig.append((len(blob), "S"))
                    qpos += len(blob)
                elif fc == "H":
                    n = sdec.read_int(S["HC"])
                    cig.append((n, "H"))
                elif fc == "P":
                    n = sdec.read_int(S["PD"])
                    cig.append((n, "P"))
                elif fc == "N":
                    n = sdec.read_int(S["RS"])
                    cig.append((n, "N"))
                    rpos += n
                elif fc == "Q":
                    quala[qpos] = sdec.read_byte(S["QS"])
                else:
                    raise ValueError(f"unsupported CRAM feature {fc!r}")
            emit_match(rl - qpos)
            mapq = sdec.read_int(S["MQ"])
            if cf & 0x1:
                quala = bytearray(sdec.read_bytes(S["QS"], rl))
            qual = bytes(quala)
            # merge adjacent same-op cigar
            merged: List[Tuple[int, str]] = []
            for n, op in cig:
                if merged and merged[-1][1] == op:
                    merged[-1] = (merged[-1][0] + n, op)
                else:
                    merged.append((n, op))
            cigar = tuple(n << 4 | _CIGAR_OP[op] for n, op in merged)
            records.append(CramRecord(
                rid, ap - 1, mapq, bf, rl, tlen, qname, cigar,
                _pack_seq(bytes(seq)), qual, tags, next_ref, next_pos,
            ))
        else:                   # unmapped
            seq = bytes(sdec.read_byte(S["BA"]) for _ in range(rl))
            if cf & 0x1:
                qual = sdec.read_bytes(S["QS"], rl)
            records.append(CramRecord(
                rid, ap - 1, 0, bf, rl, tlen, qname, (),
                _pack_seq(seq), qual, tags, next_ref, next_pos,
            ))
    return records


def _load_fasta(path: str) -> Dict[str, bytes]:
    seqs: Dict[str, bytes] = {}
    name = None
    chunks: List[bytes] = []
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(chunks).upper()
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = b"".join(chunks).upper()
    return seqs


def read_crai(path: str) -> List[Tuple[int, int, int, int, int, int]]:
    """Parse a .crai index: gzipped text lines of
    (seq_id, aln_start, aln_span, container_offset, slice_offset,
    slice_size) — htslib's CRAM index format (SAMv3 spec section 4)."""
    import gzip

    out = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            p = line.split()
            if len(p) >= 6:
                out.append(tuple(int(x) for x in p[:6]))
    return out


def read_cram(path: str, fasta: Optional[str] = None,
              header_only: bool = False,
              region: Optional[Tuple[str, int, int]] = None,
              ref_filter: Optional[set] = None):
    """Parse a CRAM file; returns (sam_header_text, refs, records) where
    refs is [(name, length)] from the SAM header and records is a list of
    CramRecord. `fasta` supplies the reference for reference-based slices
    (same requirement as samtools view of a CRAM).

    With `region` = (chrom, start1, end1) or `ref_filter` = {contig
    names}, a sibling .crai index (reference: htslib CRAI region queries,
    used by the reference via samtools/STITCH — SURVEY section 2.9) lets
    the reader seek straight to the overlapping containers; candidate
    records still need positional filtering downstream, exactly like the
    BAM linear-index chunk semantics. Without an index the whole file is
    scanned and records filtered by slice metadata."""
    ref_seqs = _load_fasta(fasta) if fasta else {}
    with open(path, "rb") as fh:
        magic = fh.read(6)
        if magic[:4] != b"CRAM":
            raise ValueError(f"{path} is not a CRAM file")
        if magic[4] != 3:
            raise ValueError(f"unsupported CRAM major version {magic[4]}")
        fh.read(20)             # file id
        # SAM header container
        hd = _parse_container_header(fh)
        body = fh.read(hd.length)
        blk, _ = _parse_block(body, 0)
        txt = blk.data
        if len(txt) >= 4:
            (ln,) = struct.unpack_from("<i", txt, 0)
            if 0 <= ln <= len(txt) - 4:
                txt = txt[4:4 + ln]
        header_text = txt.decode(errors="replace").rstrip("\x00")
        refs: List[Tuple[str, int]] = []
        for line in header_text.splitlines():
            if line.startswith("@SQ"):
                nm, ln2 = None, 0
                for f2 in line.split("\t"):
                    if f2.startswith("SN:"):
                        nm = f2[3:]
                    elif f2.startswith("LN:"):
                        ln2 = int(f2[3:])
                if nm:
                    refs.append((nm, ln2))
        records: List[CramRecord] = []
        if header_only:
            return header_text, refs, records

        def decode_container_body(body: bytes, counter: int) -> int:
            off = 0
            blk, off = _parse_block(body, off)
            if blk.content_type != CT_COMPRESSION_HEADER:
                raise ValueError("expected compression header block")
            ch = _parse_compression_header(blk.data)
            while off < len(body):
                sh_blk, off = _parse_block(body, off)
                if sh_blk.content_type != CT_SLICE_HEADER:
                    raise ValueError("expected slice header block")
                sh = sh_blk.data
                p = 0
                s_rid, p = read_itf8(sh, p)
                s_start, p = read_itf8(sh, p)
                s_span, p = read_itf8(sh, p)
                s_nrec, p = read_itf8(sh, p)
                s_counter, p = read_ltf8(sh, p)
                s_nblk, p = read_itf8(sh, p)
                n_ids, p = read_itf8(sh, p)
                for _ in range(n_ids):
                    _, p = read_itf8(sh, p)
                emb_ref, p = read_itf8(sh, p)
                core = b""
                ext: Dict[int, bytes] = {}
                for _ in range(s_nblk):
                    b2, off = _parse_block(body, off)
                    if b2.content_type == CT_CORE:
                        core = b2.data
                    else:
                        ext[b2.content_id] = b2.data
                refseq = None
                ref_offset = 0
                if emb_ref >= 0 and emb_ref in ext:
                    refseq = ext[emb_ref]
                    ref_offset = s_start - 1
                elif ch.rr and s_rid >= 0 and ref_seqs:
                    name = refs[s_rid][0] if s_rid < len(refs) else None
                    if name in ref_seqs:
                        refseq = ref_seqs[name]
                        ref_offset = 0
                elif ch.rr and s_rid >= 0 and fasta is None:
                    raise ValueError(
                        "CRAM slice requires the reference; pass fasta="
                    )
                sdec = _SliceDecoder(ch, core, ext)
                records.extend(_decode_slice(
                    ch, sdec, s_rid, s_start, s_nrec, counter, refseq,
                    ref_offset,
                ))
                counter += s_nrec
            return counter

        want_rids: Optional[set] = None
        if region is not None or ref_filter is not None:
            name_to_rid = {nm: i for i, (nm, _l) in enumerate(refs)}
            if region is not None:
                want_rids = {name_to_rid.get(region[0], -9)}
            else:
                want_rids = {
                    name_to_rid[n] for n in ref_filter if n in name_to_rid
                }
            crai_path = path + ".crai"
            if os.path.exists(crai_path):
                # index-driven container seeks (htslib CRAI semantics)
                sel = set()
                for (sid, st, span, coff, _soff, _ssz) in read_crai(
                    crai_path
                ):
                    if sid not in want_rids:
                        continue
                    if region is not None and not (
                        st <= region[2] and st + max(span, 1) > region[1]
                    ):
                        continue
                    sel.add(coff)
                counter = 0
                for coff in sorted(sel):
                    fh.seek(coff)
                    hd = _parse_container_header(fh)
                    if hd is None:
                        continue
                    body = fh.read(hd.length)
                    if (hd.ref_seq_id == -1 and hd.n_records == 0
                            and hd.n_bases == 0):
                        continue
                    counter = decode_container_body(body, counter)
                return header_text, refs, records

        counter = 0
        while True:
            hd = _parse_container_header(fh)
            if hd is None:
                break
            if (want_rids is not None and hd.ref_seq_id >= 0
                    and hd.ref_seq_id not in want_rids):
                fh.seek(hd.length, 1)       # unindexed scan: skip container
                continue
            if (region is not None and hd.ref_seq_id >= 0
                    and hd.start > 0 and not (
                        hd.start <= region[2]
                        and hd.start + max(hd.span, 1) > region[1])):
                fh.seek(hd.length, 1)
                continue
            body = fh.read(hd.length)
            if hd.ref_seq_id == -1 and hd.n_records == 0 and hd.n_bases == 0:
                continue        # EOF container
            counter = decode_container_body(body, counter)
    return header_text, refs, records


# ---------------------------------------------------------------------------
# writer (referenceless, single slice per container)
# ---------------------------------------------------------------------------


class CramWriter:
    """Minimal spec-conformant CRAM 3.0 writer: referenceless (RR=false)
    slices, detached mate records, bases carried as one 'b' (BB) feature,
    qualities via the QS series, every series EXTERNAL + gzip. Test-fixture
    mirror of samtools' BAM->CRAM conversion in test-acceptance-cram.R."""

    SERIES = ["BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
              "TL", "FN", "FC", "FP", "BB", "MQ", "QS"]

    def __init__(self, path: str, chrom: str, chrom_len: int,
                 sample: str = "S1", extra_header: str = "",
                 contigs: Optional[List[Tuple[str, int]]] = None,
                 write_index: bool = True,
                 max_container_records: int = 10000):
        """`contigs` adds further reference sequences after `chrom`
        (tid 0); write_read(..., tid=) targets them. A sibling .crai is
        written at close unless write_index=False; containers flush every
        `max_container_records` reads (htslib default 10k records)."""
        self.max_container_records = max_container_records
        self.path = path
        self.fh = open(path, "wb")
        self.chrom = chrom
        self.records: List[dict] = []
        self.counter = 0
        self.crai: List[Tuple[int, int, int, int, int, int]] = []
        self.write_index = write_index
        sq = f"@SQ\tSN:{chrom}\tLN:{chrom_len}\n"
        for nm, ln in (contigs or []):
            sq += f"@SQ\tSN:{nm}\tLN:{ln}\n"
        header = (
            "@HD\tVN:1.6\tSO:coordinate\n" + sq
            + f"@RG\tID:rg1\tSM:{sample}\n" + extra_header
        )
        self.fh.write(b"CRAM\x03\x00" + b"quilt_tpu".ljust(20, b"\x00"))
        txt = header.encode()
        blob = struct.pack("<i", len(txt)) + txt
        blk = _emit_block(METHOD_RAW, CT_FILE_HEADER, 0, blob)
        self.fh.write(_emit_container(0, 0, 0, 0, 0, 0, [blk]))

    def write_read(self, qname: str, pos1: int, seq: str, qual: List[int],
                   flag: int = 0x1 | 0x40, mapq: int = 60, tlen: int = 0,
                   mate_pos1: int = 0, tid: int = 0, mate_tid: int = -1):
        self.records.append(dict(
            qname=qname, pos=pos1, seq=seq.encode(),
            qual=bytes(qual), flag=flag, mapq=mapq, tlen=tlen,
            mate_pos=mate_pos1, tid=tid, mate_tid=mate_tid,
        ))
        if len(self.records) >= self.max_container_records:
            self._flush()

    def _flush(self):
        # one single-reference container per tid run (slices are
        # single-rid in this writer)
        all_recs = sorted(self.records, key=lambda r: (r["tid"], r["pos"]))
        self.records = []
        i = 0
        while i < len(all_recs):
            j = i
            while j < len(all_recs) and all_recs[j]["tid"] == all_recs[i]["tid"]:
                j += 1
            self._flush_one(all_recs[i]["tid"], all_recs[i:j])
            i = j

    def _flush_one(self, tid: int, recs: List[dict]):
        if not recs:
            return
        ids = {k: i + 1 for i, k in enumerate(self.SERIES)}
        streams: Dict[int, bytearray] = {i: bytearray() for i in ids.values()}

        def put_int(key, v):
            streams[ids[key]] += write_itf8(v)

        start = recs[0]["pos"]
        end = start
        nbases = 0
        for r in recs:
            rl = len(r["seq"])
            put_int("BF", r["flag"])
            put_int("CF", 0x1 | 0x2)          # quals stored + detached
            put_int("RL", rl)
            put_int("AP", r["pos"])           # AP delta = False
            put_int("RG", 0)
            streams[ids["RN"]] += r["qname"].encode() + b"\x00"
            put_int("MF", 0)
            put_int("NS", r["mate_tid"])
            put_int("NP", r["mate_pos"])
            put_int("TS", r["tlen"])
            put_int("TL", 0)
            put_int("FN", 1)
            streams[ids["FC"]] += b"b"
            put_int("FP", 1)
            put_int("BB", rl)                 # BYTE_ARRAY_LEN length
            streams[ids["BB"]] += r["seq"]
            put_int("MQ", r["mapq"])
            streams[ids["QS"]] += r["qual"]
            end = max(end, r["pos"] + rl - 1)
            nbases += rl
        ch = CompressionHeader(rn_preserved=True, ap_delta=False, rr=False)
        for k in self.SERIES:
            if k == "RN":
                ch.series[k] = Encoding(5, stop_byte=0, content_id=ids[k])
            elif k == "BB":
                ch.series[k] = Encoding(
                    4,
                    len_enc=Encoding(1, content_id=ids[k]),
                    val_enc=Encoding(1, content_id=ids[k]),
                )
            else:
                ch.series[k] = Encoding(1, content_id=ids[k])
        # QS is a byte series read with explicit length
        ch_blk = _emit_block(
            METHOD_GZIP, CT_COMPRESSION_HEADER, 0, _emit_compression_header(ch)
        )
        n = len(recs)
        span = end - start + 1
        content_ids = sorted(streams)
        sh = (write_itf8(tid) + write_itf8(start) + write_itf8(span)
              + write_itf8(n) + write_ltf8(self.counter)
              + write_itf8(len(content_ids) + 1)
              + write_itf8(len(content_ids))
              + b"".join(write_itf8(i) for i in content_ids)
              + write_itf8(-1) + b"\x00" * 16)
        blocks = [ch_blk, _emit_block(METHOD_RAW, CT_SLICE_HEADER, 0, sh)]
        blocks.append(_emit_block(METHOD_RAW, CT_CORE, 0, b""))
        for i in content_ids:
            blocks.append(
                _emit_block(METHOD_GZIP, CT_EXTERNAL, i, bytes(streams[i]))
            )
        container_off = self.fh.tell()
        self.fh.write(
            _emit_container(tid, start, span, n, self.counter, nbases,
                            blocks)
        )
        # .crai row: slice offset is from the end of the container header
        # (== start of the compression-header block), size spans the
        # slice's blocks
        self.crai.append((
            tid, start, span, container_off, len(ch_blk),
            sum(len(b) for b in blocks[1:]),
        ))
        self.counter += n

    def close(self):
        self._flush()
        self.fh.write(_eof_container())
        self.fh.close()
        if self.write_index:
            import gzip

            with gzip.open(self.path + ".crai", "wt") as fh:
                for row in self.crai:
                    fh.write("\t".join(str(x) for x in row) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
