"""BGZF (blocked gzip) reader/writer in pure Python.

The reference shells out to htslib's bgzip/tabix (QUILT/R/writers.R:119-128);
this environment has neither, so we implement the BGZF container directly:
a series of gzip members each carrying the BC extra field with the
compressed block size, ending with a 28-byte EOF marker block (SAM spec
section 4.1).
"""
from __future__ import annotations

import contextlib
import struct
import zlib
from typing import BinaryIO, Iterator, Union

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK = 65280  # uncompressed payload per block


def _compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    crc = zlib.crc32(data) & 0xFFFFFFFF
    # BSIZE = total block length - 1: 12 header + 6 extra + deflate + 8 tail
    bsize = len(comp) + 25
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00\x00\x00\x00" + b"\x00\xff"
        + struct.pack("<H", 6)
        + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize)
    )
    return header + comp + struct.pack("<II", crc, len(data) & 0xFFFFFFFF)


class BgzfWriter:
    """timed(name): a context manager around each block's deflate and
    write, the span "vcf.deflate" (the engine's SectionTimers.section)."""

    def __init__(self, path: str, level: int = 6, timed=None):
        self._fh: BinaryIO = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._coffset = 0     # compressed bytes written so far
        self._timed = timed or (lambda name: contextlib.nullcontext())

    def _write_block(self, block: bytes) -> None:
        with self._timed("vcf.deflate"):
            comp = _compress_block(block, self._level)
            self._fh.write(comp)
        self._coffset += len(comp)

    def tell_virtual(self) -> int:
        """Tabix virtual offset of the next byte to be written:
        (compressed_block_start << 16) | uncompressed_offset_in_block."""
        return (self._coffset << 16) | (len(self._buf) & 0xFFFF)

    def write(self, data: Union[bytes, str]) -> None:
        if isinstance(data, str):
            data = data.encode()
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK:
            block = bytes(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]
            self._write_block(block)

    def close(self) -> None:
        if self._buf:
            self._write_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def iter_bgzf_blocks(fh: BinaryIO) -> Iterator[bytes]:
    """Yield decompressed BGZF blocks from a file handle."""
    while True:
        header = fh.read(18)
        if len(header) < 18:
            return
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF block")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:12 + xlen] + fh.read(max(0, xlen - 6))
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4]
            )[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0]
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC field")
        comp_len = bsize + 1 - 12 - xlen - 8
        comp = fh.read(comp_len)
        fh.read(8)  # crc + isize
        data = zlib.decompress(comp, -15)
        if not data and comp_len <= 2:
            continue  # EOF block
        yield data


def bgzf_open(path: str) -> "BgzfTextReader":
    return BgzfTextReader(path)


class BgzfTextReader:
    """Line-oriented reader over BGZF or plain gzip or plain text files."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[str]:
        import gzip
        with open(self.path, "rb") as fh:
            magic = fh.read(2)
        if magic == b"\x1f\x8b":
            with gzip.open(self.path, "rt") as fh:
                yield from fh
        else:
            with open(self.path, "rt") as fh:
                yield from fh
