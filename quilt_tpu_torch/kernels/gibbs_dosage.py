"""Gibbs haplotype dosages: the CUDA kernel and its plain version.

Counterpart of quilt_tpu/kernels/gibbs_pallas.py:_dosage_sweep (Pallas
kernel _make_dos_kernel), with its signature and layouts: alphas / beta
[G, nl*B, K] (state row h*B + b), words_T [G, B, K] packed subset words,
hd [G, nl*B, 32], for nl = 2 (diploid) and nl = 3 (NIPT), each with its own
launch count (`DOS_KERNELS[nl]`). The CUDA kernel is csrc/gibbs_dosage.cu
(one warp a (grid, chain) pair, the normalisation deferred: any K); the
plain PyTorch version serves the CPU (and the kernel checks). Its previous
form, csrc/gibbs_dosage_prev.cu, is kept for timings only (`_prev=True`,
its own launch counts; no path launches it).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check_tensor as _check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DOS_ARGS = [_P] * 4 + [_I] * 5 + [_F]
DOS_KERNELS = {2: Kernel("gibbs_dosage", "gibbs_dos", _DOS_ARGS),
               3: Kernel("gibbs_dosage", "gibbs_dos", _DOS_ARGS, name="gibbs_dos_nl3")}
DOS_KERNEL = DOS_KERNELS[2]
_PREV_DOS_KERNELS = {nl: Kernel("gibbs_dosage_prev", "gibbs_dos_prev", _DOS_ARGS,
                                name=f"gibbs_dos_prev{sfx}") for nl, sfx in ((2, ""), (3, "_nl3"))}
# bytes of the unpacked [grids, B, K, 32] float32 bits one step of the
# plain version may hold (unchunked, the full-width call would take 2.3 GB)
_PLAIN_CHUNK_BYTES = 1 << 27


def dosage_sweep(alphas, beta, words_T, nl, K_real, ref_error, _prev=False):
    """Per-grid haplotype dosages hd [G, nl*B, 32] f32: gamma = alpha*beta
    over the real haplotypes (k < K_real), normalised per row (floor
    1e-30), contracted with bit*(1-2*ref_error)+ref_error for each of the
    grid's 32 SNPs.

    Inputs on the CPU run the plain version; CUDA tensors launch the
    kernel (with _prev, timings only: the previous form, which refuses K
    beyond nl x K floats of a block's shared memory)."""
    G, BN, K = alphas.shape
    if nl not in (2, 3) or BN % nl:
        raise ValueError(f"nl must be 2 or 3 and divide the {BN} state rows, got {nl}")
    B = BN // nl
    dev = alphas.device
    _check(alphas, "alphas", torch.float32, (G, BN, K), dev)
    _check(beta, "beta", torch.float32, (G, BN, K), dev)
    _check(words_T, "words_T", torch.int32, (G, B, K), dev)
    if not 0 < K_real <= K:
        raise ValueError(f"bad K_real={K_real}")
    if dev.type == "cpu":
        return dosage_sweep_plain(alphas, beta, words_T, K_real, ref_error, nl)
    hd = torch.empty((G, BN, 32), dtype=torch.float32, device=dev)
    kernel = (_PREV_DOS_KERNELS if _prev else DOS_KERNELS)[nl]
    kernel.launch(alphas.data_ptr(), beta.data_ptr(), words_T.data_ptr(), hd.data_ptr(),
                  G, B, K, K_real, nl, float(ref_error))
    return hd


def dosage_sweep_plain(alphas, beta, words_T, K_real, ref_error, nl=2):
    """Plain PyTorch version of the dosage sweep (_make_dos_kernel), a few
    grids at a time so the unpacked bits stay small."""
    G, BN, K = alphas.shape
    B = BN // nl
    dev = alphas.device
    km = (torch.arange(K, device=dev) < K_real).to(torch.float32)
    sh = torch.arange(32, dtype=torch.int32, device=dev)
    hd = torch.empty((G, BN, 32), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_BYTES // (B * K * 32 * 4))
    for g0 in range(0, G, step):
        g1 = min(g0 + step, G)
        gam = alphas[g0:g1] * beta[g0:g1] * km
        gam = gam / torch.clamp(gam.sum(2, keepdim=True), min=1e-30)
        bits = ((words_T[g0:g1, :, :, None] >> sh) & 1).to(torch.float32)
        e = bits * (1.0 - 2.0 * ref_error) + ref_error            # [g, B, K, 32]
        hd[g0:g1] = torch.einsum("ghbk,gbkt->ghbt", gam.reshape(g1 - g0, nl, B, K),
                                 e).reshape(g1 - g0, BN, 32)
    return hd
