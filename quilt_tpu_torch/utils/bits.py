"""Bit-packing utilities for the 32-SNP-per-grid panel representation.

The packed layout matches the reference's rhb_t convention: bit b of word g is
the allele of SNP 32*g + b (reference: QUILT/src/copied-from-stitch.cpp:50-69
rcpp_int_expand). All functions are NumPy; device-side unpacking lives in
quilt_tpu_torch/kernels.
"""
from __future__ import annotations

import numpy as np


def pack_bits_32(alleles: np.ndarray) -> np.ndarray:
    """Pack a 0/1 allele matrix [K, nSNPs] into uint32 words [K, nGrids].

    SNP 32*g + b maps to bit b of word g (LSB first).
    """
    K, nSNPs = alleles.shape
    nGrids = (nSNPs + 31) // 32
    padded = np.zeros((K, nGrids * 32), dtype=np.uint8)
    padded[:, :nSNPs] = alleles.astype(np.uint8)
    bits = padded.reshape(K, nGrids, 4, 8)
    # little-endian bit order within each byte, little-endian bytes in word
    byte_vals = (bits << np.arange(8, dtype=np.uint8)).sum(axis=-1).astype(np.uint8)
    words = byte_vals.view(np.uint32) if byte_vals.flags.c_contiguous else None
    if words is None or words.shape != (K, nGrids):
        words = (
            byte_vals[..., 0].astype(np.uint32)
            | (byte_vals[..., 1].astype(np.uint32) << 8)
            | (byte_vals[..., 2].astype(np.uint32) << 16)
            | (byte_vals[..., 3].astype(np.uint32) << 24)
        )
    return np.ascontiguousarray(words.reshape(K, nGrids))


def unpack_bits_32(words: np.ndarray, nSNPs: int) -> np.ndarray:
    """Inverse of pack_bits_32: uint32 [K, nGrids] -> uint8 alleles [K, nSNPs]."""
    K, nGrids = words.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    return bits.reshape(K, nGrids * 32)[:, :nSNPs].astype(np.uint8)


def unpack_words(words: np.ndarray, width: int = 32) -> np.ndarray:
    """Unpack uint32 vector [...,] -> bits [..., width] (LSB first)."""
    shifts = np.arange(width, dtype=np.uint32)
    return ((words[..., None].astype(np.uint32) >> shifts) & np.uint32(1)).astype(
        np.uint8
    )
