"""Forward bank of the NIPT within-block relabelling move: the CUDA kernel
and its plain version.

The grid scan of quilt_tpu/kernels/gibbs.py:nipt_block_within (`scan_step`,
an XLA scan there; no Pallas kernel): per chain, the forward recursion of
the 6 relabellings of the 3 latent rows, restarted at every block end of the
chain, where one relabelling is drawn from the in-block forward x stale-beta
junction plus the block's class-count term and the bank collapses to the
drawn rows. Row i of relabelling r runs under the emissions of row
INVS[r, i], so the 18 bank rows are 9 distinct ones, [3 (row i), 3
(emissions of row j)]. The CUDA kernel is csrc/nipt_bank.cu; the plain
PyTorch version, a Python loop over the grids, serves the CPU (and the
kernel checks). Layouts are nl-major: state row j*B + b of [G, 3B, K].
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check_tensor as _check
from . import nipt as nipt_tables

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BANK_KERNEL = Kernel("nipt_bank", "nipt_bank", [_P] * 9 + [_I] * 3 + [_F])


def bank_scan(e, bk, trans, ht, u, is_end, perm_mask, K_real):
    """The relabelling drawn at every block end of every chain.

    e [G, 3B, K] f32 grid emissions exp(lemg - row max), 0 at the pad
    haplotypes; bk [G, 3B, K] beta, 0 there too; trans [2, G] (stay, jump)
    into each grid; ht [G, B, 6] the class-count term of each relabelling
    for the block that holds grid g, counted up to g; u [G, B] that block's
    uniform; is_end [G, B] i32 whether the chain's block ends at g;
    perm_mask [6] the relabellings allowed. Returns (chosen [G, B] i32, 0
    where no block ends; probs [G, B, 6] f32 the relabellings' probabilities
    at the block ends, 0 elsewhere).

    Inputs on the CPU run the plain version; CUDA tensors launch the
    kernel."""
    G, BN, K = e.shape
    if BN % 3:
        raise ValueError(f"a NIPT state has 3 rows a chain, got {BN} rows")
    B = BN // 3
    dev, f32 = e.device, torch.float32
    _check(e, "e", f32, (G, BN, K), dev)
    _check(bk, "bk", f32, (G, BN, K), dev)
    _check(trans, "trans", f32, (2, G), dev)
    _check(ht, "ht", f32, (G, B, 6), dev)
    _check(u, "u", f32, (G, B), dev)
    _check(is_end, "is_end", torch.int32, (G, B), dev)
    _check(perm_mask, "perm_mask", f32, (6,), dev)
    if not 0 < K_real <= K:
        raise ValueError(f"bad K_real={K_real}")
    if dev.type == "cpu":
        return bank_scan_plain(e, bk, trans, ht, u, is_end, perm_mask, K_real)
    chosen = torch.empty((G, B), dtype=torch.int32, device=dev)
    probs = torch.empty((G, B, 6), dtype=f32, device=dev)
    BANK_KERNEL.launch(e.data_ptr(), bk.data_ptr(), trans.data_ptr(), ht.data_ptr(),
                       u.data_ptr(), is_end.data_ptr(), perm_mask.data_ptr(),
                       chosen.data_ptr(), probs.data_ptr(), G, B, K, 1.0 / K_real)
    return chosen, probs


def bank_scan_plain(e, bk, trans, ht, u, is_end, perm_mask, K_real):
    """Plain PyTorch version of the bank scan: the same operations at every
    grid (chains whose block does not end there are masked), so nothing is
    read back to the host inside the loop."""
    G, BN, K = e.shape
    B = BN // 3
    dev, f32 = e.device, torch.float32
    invs_t = torch.as_tensor(nipt_tables.INVS, dtype=torch.int64, device=dev)
    pick = invs_t + 3 * torch.arange(3, device=dev)          # [6, 3] index i*3 + INVS[r, i]
    rows_b = torch.arange(B, device=dev)
    jump = trans[1].clone()
    jump[0] += 1.0
    jump = (jump / K_real).tolist()
    stay = trans[0].tolist()
    ends = is_end != 0
    bank = torch.zeros((3, 3, B, K), dtype=f32, device=dev)  # [row i, emissions of row j]
    lg = torch.zeros((9, B), dtype=f32, device=dev)
    chosen_g = torch.zeros((G, B), dtype=torch.int32, device=dev)
    probs_g = torch.zeros((G, B, 6), dtype=f32, device=dev)
    for g in range(G):
        a = e[g].reshape(1, 3, B, K) * (stay[g] * bank + jump[g])
        s = a.sum(3, keepdim=True).clamp(min=1e-30)
        bank = a / s
        lg = lg + torch.log(s.reshape(9, B))
        junction = (bank * bk[g].reshape(3, 1, B, K)).sum(3).reshape(9, B)
        lw = (torch.log(junction.clamp(min=1e-30)) + lg)[pick].sum(1).T + ht[g]     # [B, 6]
        lw = lw - lw.amax(1, keepdim=True)
        w = torch.exp(lw.clamp(min=-100.0)) * perm_mask
        p = w / w.sum(1, keepdim=True)
        chosen = (torch.cumsum(p, 1) <= u[g][:, None]).sum(1).clamp(max=5)          # [B]
        end_b = ends[g]
        drawn = bank.reshape(9, B, K)[pick[chosen].T, rows_b]                       # [3, B, K]
        bank = torch.where(end_b[:, None], drawn[:, None], bank)
        lg = torch.where(end_b, 0.0, lg)
        chosen_g[g] = torch.where(end_b, chosen, 0)
        probs_g[g] = torch.where(end_b[:, None], p, 0.0)
    return chosen_g, probs_g
