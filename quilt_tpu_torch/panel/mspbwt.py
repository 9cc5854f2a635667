"""Distinct-haplotype symbols of imputed haplotype dosages, on the device:
the query side of the msPBWT haplotype selection.

symbols_device is the torch counterpart of
quilt_tpu/panel/mspbwt.py:symbols_device (:424-461). The host index, the
match scan and the ranking are reused from quilt_tpu.panel.mspbwt, whose
imports never reach jax (only its symbols_device imports jax, inside the
function, and the port does not call it).
"""
from __future__ import annotations

import numpy as np
import torch

from quilt_tpu.utils import unpack_bits_32


def distinct_hap_bits(panel, device) -> torch.Tensor:
    """The panel's distinct-haplotype words unpacked to {0,1} float32
    [nMaxDH, nGrids*32] on `device` (uploaded once per region)."""
    bits = unpack_bits_32(panel.distinctHapsB, panel.nGrids * 32)
    return torch.as_tensor(bits.astype(np.float32), device=device)


def symbols_device(hap_dos: torch.Tensor, dh_bits: torch.Tensor, nSNPs: int) -> torch.Tensor:
    """[..., >= nSNPs] haploid dosages -> [..., nGrids] uint8 symbols: per
    grid, 1 + the index of the Hamming-nearest distinct haplotype to the
    rounded alleles (dosage > 0.5), the first index on ties (as np.argmin
    in symbols_from_hap_dosage, mspbwt.py:372).

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
