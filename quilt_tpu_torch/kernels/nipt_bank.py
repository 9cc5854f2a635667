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

The kernel reads lemg and beta as the sweeps leave them: it exponentiates
lemg against each (grid, row) maximum over the real haplotypes and masks the
pad haplotypes itself. It keeps the bank raw and carries each row's
normaliser into the next step (a = e * ((stay * sc) * a + jump)); the plain
version does the same operations in the same order.

The forms and the K they take (bank_form; 512 grids):

    registers  K <= 1,024           128 threads x 2 / 5 / 8 columns
    general    K <= 6,257           the bank in shared memory
    cluster    K <= 16,384          16 blocks a chain, each a register form
                                    over its slice (at most 1,024 columns)
    global     any K                the bank in a scratch plane

The cluster form (one chain on a thread-block cluster; the blocks exchange
each grid's sums over distributed shared memory, csrc/cluster_xchg.cuh)
adds a step's sums in another order than the other forms, so it differs
from them by rounding; it counts apart (BANK_CLUSTER_KERNEL), as does the
global form (BANK_GLOBAL_KERNEL), which serves past the cluster form's K and
past the grids whose staged scalars fit shared memory (about 18,700).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check_tensor as _check
from . import nipt as nipt_tables
from .gibbs_sweep import CLUSTER, GENERAL, GLOBAL

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BANK_ARGS = [_P] * 9 + [_I] * 5 + [_F, _P]
BANK_KERNEL = Kernel("nipt_bank", "nipt_bank", _BANK_ARGS)
# the global form (the bank and the staged scalars in a scratch plane) and the
# cluster form count apart
BANK_GLOBAL_KERNEL = Kernel("nipt_bank", "nipt_bank", _BANK_ARGS, name="nipt_bank_global")
BANK_CLUSTER_KERNEL = Kernel("nipt_bank", "nipt_bank", _BANK_ARGS, name="nipt_bank_cluster")
FLOOR_KERNEL = Kernel("nipt_bank", "nipt_bank_floor", [_P] + [_I] * 2)
CLUSTER_FLOOR_KERNEL = Kernel("nipt_bank", "nipt_bank_cluster_floor", [_P] + [_I] * 2)
# the previous form (csrc/nipt_bank_prev.cu), timings only: no path launches it
_PREV_BANK_KERNEL = Kernel("nipt_bank_prev", "nipt_bank_prev", [_P] * 9 + [_I] * 3 + [_F])

# threads a chain, and the register instantiations: columns a thread
_NT = 128
_BANK_CPTS = (2, 5, 8)
# shared memory a block may take (csrc/nipt_bank.cu SMEM_LIMIT)
_SMEM_LIMIT = 232448
# the cluster form's blocks a chain and capacity (csrc/nipt_bank.cu
# CLUSTER_C, CLUSTER_COLS): 16 blocks of 1,024 columns
_CLUSTER_C = 16
_CLUSTER_COLS = _CLUSTER_C * _NT * 8


def _bank_cpt(K):
    """Columns a thread of the kernel holds in registers at K haplotypes, or
    0 where no register form holds K."""
    return next((c for c in _BANK_CPTS if c * _NT >= K), 0)


def _staged_floats(G):
    return (3 * G + 3) & ~3


def bank_form(K: int, G: int) -> int:
    """The form code of the bank kernel at K haplotypes and G grids, as
    csrc/nipt_bank.cu takes it (the sweeps' codes, gibbs_sweep.GENERAL /
    CLUSTER / GLOBAL): columns a thread in registers (2, 5 or 8, up to K =
    1,024) while the 3G staged scalars fit shared memory (about 19,000
    grids), GENERAL while those and the 9K bank fit (K <= 6,257 at 512
    grids), CLUSTER up to K = 16,384 while the staged scalars fit beside the
    cluster's exchange (about 18,700 grids), else GLOBAL (the bank and the
    staged scalars in a scratch plane of bank_scratch_floats(K, G) floats a
    chain)."""
    staged = 4 * _staged_floats(G)
    cpt = _bank_cpt(K)
    if cpt and staged <= _SMEM_LIMIT - 4096:
        return cpt
    if staged + 36 * K <= _SMEM_LIMIT - 1024:
        return GENERAL
    if K <= _CLUSTER_COLS and staged <= _SMEM_LIMIT - 8192:
        return CLUSTER
    return GLOBAL


def bank_scratch_floats(K: int, G: int) -> int:
    """Floats of scratch a chain of the bank kernel takes: the global form's
    staged scalars and bank, none in the other forms."""
    return _staged_floats(G) + 9 * K if bank_form(K, G) == GLOBAL else 0


def bank_scan(lemg, beta, trans, ht, u, is_end, perm_mask, K_real, _prev=False, _variant=None):
    """The relabelling drawn at every block end of every chain.

    lemg [G, 3B, K] f32 log grid emissions and beta [G, 3B, K] as the
    sweeps leave them (the pad haplotypes k >= K_real are masked here);
    trans [2, G] (stay, jump) into each grid; ht [G, B, 6] the class-count
    term of each relabelling for the block that holds grid g, counted up to
    g; u [G, B] that block's uniform; is_end [G, B] i32 whether the chain's
    block ends at g; perm_mask [6] the relabellings allowed. Returns (chosen
    [G, B] i32, 0 where no block ends; probs [G, B, 6] f32 the
    relabellings' probabilities at the block ends, 0 elsewhere).

    Inputs on the CPU run the plain version; CUDA tensors launch the
    kernel in the form bank_form(K, G) names: registers up to K = 1,024,
    the general form above that, the cluster form where neither fits shared
    memory, up to K = 16,384, and the global form past it (each of the
    last two under its own launch count). Private, timings and tests only:
    _variant a form code (GLOBAL: the global form at any K, timed in turn
    with the cluster form); _prev launches the previous form
    (csrc/nipt_bank_prev.cu) on the e and beta * mask planes that it reads,
    built here (_prev_planes)."""
    G, BN, K = lemg.shape
    if BN % 3:
        raise ValueError(f"a NIPT state has 3 rows a chain, got {BN} rows")
    B = BN // 3
    dev, f32 = lemg.device, torch.float32
    _check(lemg, "lemg", f32, (G, BN, K), dev)
    _check(beta, "beta", f32, (G, BN, K), dev)
    _check(trans, "trans", f32, (2, G), dev)
    _check(ht, "ht", f32, (G, B, 6), dev)
    _check(u, "u", f32, (G, B), dev)
    _check(is_end, "is_end", torch.int32, (G, B), dev)
    _check(perm_mask, "perm_mask", f32, (6,), dev)
    if not 0 < K_real <= K:
        raise ValueError(f"bad K_real={K_real}")
    if dev.type == "cpu":
        return bank_scan_plain(lemg, beta, trans, ht, u, is_end, perm_mask, K_real)
    if _prev:
        return _prev_bank_scan(*_prev_planes(lemg, beta, K_real), trans, ht, u, is_end,
                               perm_mask, K_real)
    chosen = torch.empty((G, B), dtype=torch.int32, device=dev)
    probs = torch.empty((G, B, 6), dtype=f32, device=dev)
    cpt = bank_form(K, G) if _variant is None else _variant
    scratch = torch.empty((B, _staged_floats(G) + 9 * K) if cpt == GLOBAL else (1,), dtype=f32,
                          device=dev)
    {GLOBAL: BANK_GLOBAL_KERNEL, CLUSTER: BANK_CLUSTER_KERNEL}.get(cpt, BANK_KERNEL).launch(
        lemg.data_ptr(), beta.data_ptr(), trans.data_ptr(), ht.data_ptr(), u.data_ptr(),
        is_end.data_ptr(), perm_mask.data_ptr(), chosen.data_ptr(), probs.data_ptr(), G, B, K,
        K_real, cpt, 1.0 / K_real, scratch.data_ptr())
    return chosen, probs


def _prev_planes(lemg, beta, K_real):
    """The planes the previous form reads: e = exp(lemg - the row maximum
    over the real haplotypes) and beta, both 0 at the pads."""
    km = torch.arange(lemg.shape[2], device=lemg.device) < K_real
    kmf = km.to(torch.float32)
    e = torch.exp(lemg - torch.where(km, lemg, -torch.inf).amax(2, keepdim=True)) * kmf
    return e, beta * kmf


def _prev_bank_scan(e, bk, trans, ht, u, is_end, perm_mask, K_real):
    """The previous form's launch on its planes (timings only)."""
    G, BN, K = e.shape
    B = BN // 3
    chosen = torch.empty((G, B), dtype=torch.int32, device=e.device)
    probs = torch.empty((G, B, 6), dtype=torch.float32, device=e.device)
    _PREV_BANK_KERNEL.launch(e.data_ptr(), bk.data_ptr(), trans.data_ptr(), ht.data_ptr(),
                             u.data_ptr(), is_end.data_ptr(), perm_mask.data_ptr(),
                             chosen.data_ptr(), probs.data_ptr(), G, B, K, 1.0 / K_real)
    return chosen, probs


def bank_floor(steps: int, B: int, device) -> torch.Tensor:
    """Launches `steps` reductions of a bank step (16 slots: 9 sums, 3
    maxima; a record per warp, one barrier, the records' reads) in each of
    B blocks of the kernel's width and nothing else: timed, it gives the
    least a grid step of the kernel can take on the card."""
    if torch.device(device).type != "cuda":
        raise ValueError("bank_floor times the card and needs a CUDA device")
    out = torch.empty((B,), dtype=torch.float32, device=device)
    FLOOR_KERNEL.launch(out.data_ptr(), B, steps)
    return out


def bank_cluster_floor(steps: int, B: int, device) -> torch.Tensor:
    """The same for the cluster form's step (the reduction, then the
    exchange of its 12 values) on B clusters of the form's shape; out
    [B * blocks a cluster]."""
    if torch.device(device).type != "cuda":
        raise ValueError("bank_cluster_floor times the card and needs a CUDA device")
    out = torch.empty((B * _CLUSTER_C,), dtype=torch.float32, device=device)
    CLUSTER_FLOOR_KERNEL.launch(out.data_ptr(), B, steps)
    return out


def bank_scan_plain(lemg, beta, trans, ht, u, is_end, perm_mask, K_real):
    """Plain PyTorch version of the bank scan: the same operations at every
    grid (chains whose block does not end there are masked), so nothing is
    read back to the host inside the loop."""
    G, BN, K = lemg.shape
    B = BN // 3
    dev, f32 = lemg.device, torch.float32
    invs_t = torch.as_tensor(nipt_tables.INVS, dtype=torch.int64, device=dev)
    pick = invs_t + 3 * torch.arange(3, device=dev)          # [6, 3] index i*3 + INVS[r, i]
    rows_b = torch.arange(B, device=dev)
    km = torch.arange(K, device=dev) < K_real
    jump = trans[1].clone()
    jump[0] += 1.0
    jump = (jump / K_real).tolist()
    stay = trans[0].tolist()
    ends = is_end != 0
    bank = torch.zeros((3, 3, B, K), dtype=f32, device=dev)  # raw, [row i, emissions of row j]
    sc = torch.ones((3, 3, B, 1), dtype=f32, device=dev)     # 1 / the normaliser bank carries
    lg = torch.zeros((9, B), dtype=f32, device=dev)
    chosen_g = torch.zeros((G, B), dtype=torch.int32, device=dev)
    probs_g = torch.zeros((G, B, 6), dtype=f32, device=dev)
    for g in range(G):
        lm = torch.where(km, lemg[g], -torch.inf)
        e = torch.exp(lm - lm.amax(1, keepdim=True))         # 0 at the pads
        bank = e.reshape(1, 3, B, K) * ((stay[g] * sc) * bank + jump[g])
        s = bank.sum(3, keepdim=True).clamp(min=1e-30)
        inv = 1.0 / s
        lg = lg + torch.log(s.reshape(9, B))
        bk = torch.where(km, beta[g], 0.0).reshape(3, 1, B, K)
        junction = ((bank * bk).sum(3, keepdim=True) * inv).reshape(9, B)
        lw = (torch.log(junction.clamp(min=1e-30)) + lg)[pick].sum(1).T + ht[g]     # [B, 6]
        lw = lw - lw.amax(1, keepdim=True)
        w = torch.exp(lw.clamp(min=-100.0)) * perm_mask
        p = w / w.sum(1, keepdim=True)
        chosen = (torch.cumsum(p, 1) <= u[g][:, None]).sum(1).clamp(max=5)          # [B]
        end_b = ends[g]
        sel = pick[chosen].T                                                        # [3, B]
        drawn = bank.reshape(9, B, K)[sel, rows_b]                                  # [3, B, K]
        drawn_sc = inv.reshape(9, B, 1)[sel, rows_b]
        bank = torch.where(end_b[:, None], drawn[:, None], bank)
        sc = torch.where(end_b[:, None], drawn_sc[:, None], inv)
        lg = torch.where(end_b, 0.0, lg)
        chosen_g[g] = torch.where(end_b, chosen, 0)
        probs_g[g] = torch.where(end_b[:, None], p, 0.0)
    return chosen_g, probs_g
