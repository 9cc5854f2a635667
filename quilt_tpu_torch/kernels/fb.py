"""Full-panel haploid forward-backward: CUDA kernels, plain versions and the
batched driver.

Two kernel families, chosen per call by fb_plan:
- fused (csrc/fb.cu): one thread block per row. Counterpart of
  quilt_tpu/kernels/fb_pallas.py:fb_pallas_core (Pallas _fwd_kernel and
  _bwd_kernel). For many rows against a small panel.
- tiled (csrc/fb_tiled.cu): one row's haplotypes split over a cluster of
  blocks. Counterpart of fb_pallas_tiled_core (Pallas _max_kernel_tiled,
  _fwd_kernel_tiled, and _remat_kernel_tiled with _bwd_kernel_tiled folded
  into one backward launch an FB call). For few rows against a large panel.
fb_full_batched is the counterpart of quilt_tpu/kernels/fb_full.py:
fb_full_batched. The emission factorisation is the Pallas one: with
t0/t1 the GL terms of hap allele 0/1 and dl = log t1 - log t0, the log
emission of haplotype k in grid g is sum_s log t0[s] + sum_s bit_k,s dl[s];
the first term is a per-row constant added to the log-likelihood outside
the kernels, the second is a 32-term dot with the grid's panel bits.

Sizing: K_pad (multiple of 128, hence of every split count 1, 2, 4, 8, 16)
and the grid padding to GRID_CHUNK = 16 come from the prepared inputs
(inputs.FBInputs) and are kept. The checkpoint interval of each family is
the chunk whose rematerialised alphas fit its backward kernel's shared
memory: fused_cg(K_pad, Gp) (16, 8 or 4 grids; GRID_CHUNK with global
planes above K_pad = 13,824) and tiled_cg(K_pad / splits, Gp) (16, 8, 4 or
2; 2 for the staged form's alpha and word planes at 10,241-12,288
haplotypes a block; GRID_CHUNK with global planes above 27,552).
Gamma capture (the HLA run: FBInputs.capture_grid >= 0) is a part of the
fused backward only; fb_plan keeps such calls fused, as the JAX package
keeps them off its tiled path (fb_full.py:_pallas_plan).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .._build import Kernel, check_tensor as _check
from ..inputs import GRID_CHUNK, FBInputs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_KERNEL = Kernel("fb", "fb_forward", [_P] * 6 + [_I] * 5 + [_F, _I])
_BWD_ARGS = [_P] * 11 + [_I] * 6 + [_F, _F, _I, _I]
BWD_KERNEL = Kernel("fb", "fb_backward", _BWD_ARGS)
# the same entry launched with capture flags: counted apart, so that a run
# shows the capturing form ran
BWD_CAPTURE_KERNEL = Kernel("fb", "fb_backward", _BWD_ARGS, name="fb_backward_capture")
FLOOR_KERNEL = Kernel("fb", "fb_chain_floor", [_P] + [_I] * 3)
# the fused kernels as they were before their redesign (csrc/fb_prev.cu),
# for timing beside it only (fb_forward / fb_backward with _prev=True)
_PREV_FWD = Kernel("fb_prev", "fb_forward_prev", [_P] * 6 + [_I] * 5 + [_F])
_PREV_BWD = Kernel("fb_prev", "fb_backward_prev", [_P] * 11 + [_I] * 6 + [_F, _F])
MAX_TILED_KERNEL = Kernel("fb_tiled", "fb_max_tiled", [_P] * 3 + [_I] * 4)
FWD_TILED_KERNEL = Kernel("fb_tiled", "fb_forward_tiled", [_P] * 8 + [_I] * 6 + [_F, _I])
BWD_TILED_KERNEL = Kernel("fb_tiled", "fb_backward_tiled",
                          [_P] * 12 + [_I] * 7 + [_F, _F, _I, _I])
TILED_FLOOR_KERNEL = Kernel("fb_tiled", "fb_tiled_chain_floor", [_P] + [_I] * 4)
# the tiled forward and backward as they were before their redesign
# (csrc/fb_tiled_prev.cu: the forward's alpha in a global row; a remat and a
# backward launch per chunk), for timing beside them only
# (fb_forward_tiled / fb_backward_tiled with _prev=True)
_PREV_FWD_TILED = Kernel("fb_tiled_prev", "fb_forward_tiled_prev", [_P] * 8 + [_I] * 6 + [_F])
_PREV_REMAT_TILED = Kernel("fb_tiled_prev", "fb_remat_tiled_prev", [_P] * 7 + [_I] * 7 + [_F])
_PREV_BWD_TILED = Kernel("fb_tiled_prev", "fb_backward_tiled_prev",
                         [_P] * 14 + [_I] * 8 + [_F, _F])
# and the emission maximum before its redesign (a block per (grid, split),
# a barrier and an atomic a row; fb_max_tiled with _prev=True)
_PREV_MAX_TILED = Kernel("fb_tiled_prev", "fb_max_tiled_prev", [_P] * 3 + [_I] * 5)
_NEG = -1e30
# device-memory budget of one core call's checkpoints + scratch: fb_plan
# takes rows per call = budget / per-row bytes of the chosen family
_CALL_BYTES = 4 << 30
# fb_plan's cost model, fitted to chip_smoke.py's "fb_plan timing" lines on
# an H100 (PERF.md section 6). A core call's blocks run in waves: fused, one
# block a row over the card's _N_SM SMs; split, a cluster of `splits`
# blocks a row, of which the card holds _ACTIVE_CLUSTERS[splits] at once
# (the backward, one block an SM: cudaOccupancyMaxActiveClusters, 15 of 8
# and 7 of 16 blocks, since a cluster stays within a GPC of 16-18 SMs;
# chip_smoke.py prints them). A wave costs about its blocks' haplotypes a
# grid, plus _BLOCK_OVERHEAD_K haplotypes' worth for a split block's fixed
# work a grid (cluster exchange, reductions, top-K), times
# _GENERAL_FORM_COST for a split block too wide for registers (the general
# form's backward: 11.745 against 8.459 ms at 28 rows x 40,960), and that
# again times _INTERVAL2_COST where it checkpoints every 2 grids and
# _GLOBAL_PLANES_COST where its chunk alphas live in global planes (above
# 27,552 haplotypes a block; both measured at K = 98,304 against the
# 8-block split); the staged form (interval 2, 24 a thread) costs as the
# register forms (20.49 us a grid a wave at 12,288 a block against the
# 20-column form's 16.60 at 10,240). A fused row wider than _TILED_MIN_K
# costs _FUSED_WIDE_COST (measured 1.2 at 8,192 to 1.9 at 40,960). Below
# _TILED_MIN_K nothing is split (unmeasured), nor to fewer than
# _MIN_K_PER_SPLIT haplotypes a block. Refitted when clusters of 16 and the
# staged form came (whole waves of the clusters held at once, not a share
# of the SMs: 8 blocks a row at 16 rows x 98,304 take 2 waves of 15): with
# the other constants as before, a wide cost of 1.7 (1.5 no longer) and a
# block of at least 640 haplotypes (8 blocks of 640 are the fastest at 14
# rows x 5,120) reproduce all 27 timed choices, as does any overhead in
# 1,800-2,500 and general-form cost in 1.2-1.8.
_N_SM = 132
_ACTIVE_CLUSTERS = {2: 66, 4: 30, 8: 15, 16: 7}
_TILED_MIN_K = 5120
_MIN_K_PER_SPLIT = 640
_BLOCK_OVERHEAD_K = 2368
_GENERAL_FORM_COST = 1.4
_FUSED_WIDE_COST = 1.7
_INTERVAL2_COST = 1.3
_GLOBAL_PLANES_COST = 1.35

# The fused kernels (csrc/fb.cu): NT threads a row, thread t holding the
# haplotypes t, t + NT, ...; in registers when K_pad <= NT * max(_CPTS).
# This module chooses the storage and the columns a thread holds (_CPTS:
# the kernels' instantiations) and sizes the scratch rows for them; the
# entry points refuse a choice without an instantiation or beyond the
# block's shared memory. That memory (fb.cu bwd_smem_floats): two
# reduction buffers (a warp's record of the gamma reduction _RW floats),
# the chunk's maxima, the top-K candidate lists, the chunk's log-ratios and
# emission tables (_EMF floats a grid) and, where they fit, the chunk's
# alpha planes. fused_cg reserves room for up to _KTOP_RESERVE top gammas.
_NT = 512
_NWARP = _NT // 32
_CPTS = (1, 2, 4, 8, 10, 16)
_RW, _EMF = 33, 128
_SMEM_LIMIT = 232448
_KTOP_RESERVE = 32


def _r4(n):
    return (n + 3) & ~3


def _bwd_smem_bytes(CG, K_pad, K_top, planes):
    return 4 * (_r4(2 * _NWARP * _RW) + _r4(4 * _NWARP) + _r4(CG) + 2 * _r4(_NWARP * K_top)
                + _r4(CG * 32) + CG * _EMF + (CG * K_pad if planes else 0))


def fused_cg(K_pad: int, Gp: int) -> int:
    """Checkpoint interval of the fused family: the largest of 16, 8, 4
    dividing Gp whose alpha planes fit the backward kernel's shared memory
    (16 up to K_pad = 3,328, 8 up to 6,784, 4 up to 13,824); above that
    GRID_CHUNK, with the planes in global memory."""
    for cg in (16, 8, 4):
        if Gp % cg == 0 and _bwd_smem_bytes(cg, K_pad, _KTOP_RESERVE, True) <= _SMEM_LIMIT:
            return cg
    return GRID_CHUNK


def _cpt(K_pad, general=False):
    """Columns a thread of the fused kernels holds in registers: the
    fewest of _CPTS that hold K_pad, else 0, the general form (its state in
    global planes; any K_pad). `general` forces it (tests only)."""
    if general:
        return 0
    return next((c for c in _CPTS if c * _NT >= K_pad), 0)


def _bwd_storage(CG, K_pad, K_top, general=False):
    """(alpha planes in shared memory?, columns a thread in registers or 0
    for the general form) of the backward kernel."""
    smem = _bwd_smem_bytes(CG, K_pad, K_top, True) <= _SMEM_LIMIT
    return smem, _cpt(K_pad, general) if smem else 0


def _bwd_scratch_planes(CG, K_pad, K_top, general=False):
    """Global planes of K_pad floats a row of the backward kernel: the
    general form's four state planes, and the chunk's alphas when they do
    not fit shared memory."""
    smem, cpt = _bwd_storage(CG, K_pad, K_top, general)
    return (4 if cpt == 0 else 0) + (0 if smem else CG)


def fb_forward(dl, words, trans2, K, CG=None, _prev=False, _general=False):
    """Forward pass. dl [B, S] f32 GL log-ratios (S = Gp*32); words
    [Gp, K_pad] i32 packed panel bits; trans2 [2, Gp] f32 (stay, jump)
    into each grid; CG the checkpoint interval (default fused_cg). Returns
    (ckpt [Gp/CG, B, K_pad] alphas entering each chunk, logs [B]
    log-likelihood without the per-row constant). _prev (the kernels before
    their redesign, csrc/fb_prev.cu; timings only) and _general (the
    general form at any K_pad; tests only) are private."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    dev = dl.device
    CG = fused_cg(K_pad, Gp) if CG is None else CG
    _check(dl, "dl", torch.float32, (B, Gp * 32), dev)
    _check(words, "words", torch.int32, (Gp, K_pad), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    if Gp % CG or not 0 < K <= K_pad:
        raise ValueError(f"bad Gp={Gp} / CG={CG} / K={K}")
    if dev.type == "cpu":
        return fb_forward_plain(dl, words, trans2, K, CG)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dev)
    logs = torch.empty((B,), dtype=torch.float32, device=dev)
    cpt = _cpt(K_pad, _general)
    planes = 2 if (_prev or cpt == 0) else 0
    scratch = torch.empty((B, planes, K_pad) if planes else (1,), dtype=torch.float32, device=dev)
    args = (words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), ckpt.data_ptr(),
            logs.data_ptr(), scratch.data_ptr(), Gp, K, K_pad, B, CG, 1.0 / K)
    if _prev:
        _PREV_FWD.launch(*args)
    else:
        FWD_KERNEL.launch(*args, cpt)
    return ckpt, logs


def fb_backward(dl, words, ckpt, trans2, thin, K, K_top, eps, CG=None, cap=None, _prev=False,
                _general=False):
    """Backward pass from the forward's checkpoints (CG as given to
    fb_forward). thin [Gp] i32 (>= 0 at thinned grids); cap [Gp] f32 (> 0
    at the grids whose gamma to capture) or None. Returns (dos [B, S] f32
    per-SNP dosages, tv/ti [Gp, B, K_top] top gammas and their haplotype
    indices, zero away from thinned grids) and, given cap, gcap [B, K_pad]:
    the sum of the normalised gammas at the captured grids (zero at padded
    haplotypes). The kernel keeps the chunk's alphas in shared memory where
    CG planes fit, else in global memory. _prev / _general as fb_forward."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    dev = dl.device
    CG = fused_cg(K_pad, Gp) if CG is None else CG
    _check(dl, "dl", torch.float32, (B, Gp * 32), dev)
    _check(words, "words", torch.int32, (Gp, K_pad), dev)
    _check(ckpt, "ckpt", torch.float32, (Gp // CG, B, K_pad), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    if cap is not None:
        _check(cap, "cap", torch.float32, (Gp,), dev)
    if Gp % CG or not 0 < K_top <= K <= K_pad:
        raise ValueError(f"bad Gp={Gp} / CG={CG} / K={K} / K_top={K_top}")
    if dev.type == "cpu":
        return fb_backward_plain(dl, words, ckpt, trans2, thin, K, K_top, eps, CG, cap)
    dos = torch.empty((B, S), dtype=torch.float32, device=dev)
    tv = torch.empty((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.empty((Gp, B, K_top), dtype=torch.int32, device=dev)
    smem, cpt = _bwd_storage(CG, K_pad, K_top, _general)
    planes = 2 * CG + 3 if _prev else _bwd_scratch_planes(CG, K_pad, K_top, _general)
    scratch = torch.empty((B, planes, K_pad) if planes else (1,), dtype=torch.float32, device=dev)
    gcap = None if cap is None else torch.zeros((B, K_pad), dtype=torch.float32, device=dev)
    args = (words.data_ptr(), dl.data_ptr(), ckpt.data_ptr(), trans2.data_ptr(),
            thin.data_ptr(), dos.data_ptr(), tv.data_ptr(), ti.data_ptr(), scratch.data_ptr(),
            None if cap is None else cap.data_ptr(), None if gcap is None else gcap.data_ptr(),
            Gp, K, K_pad, B, CG, K_top, 1.0 / K, float(eps))
    if _prev:
        _PREV_BWD.launch(*args)
    else:
        (BWD_KERNEL if cap is None else BWD_CAPTURE_KERNEL).launch(*args, int(smem), cpt)
    return (dos, tv, ti) if cap is None else (dos, tv, ti, gcap)


def chain_floor(steps: int, blocks: int, which: int, device) -> torch.Tensor:
    """Launches `steps` dependent reductions of a fused FB step's kind (which
    = 0: the forward's (m, s) pair; 1: the reverse step's two, a sum and a
    maximum, then 33 sums) with the kernels' 512 threads in each of `blocks`
    blocks and nothing else: timed, it gives the least a step of the fused
    kernels can take on the card."""
    if torch.device(device).type != "cuda":
        raise ValueError("chain_floor times the card and needs a CUDA device")
    out = torch.empty((blocks,), dtype=torch.float32, device=device)
    FLOOR_KERNEL.launch(out.data_ptr(), blocks, steps, which)
    return out


def _emissions(dl, words, g, K):
    """Plain per-grid emissions scaled to max 1, and their log max. The
    logits are one matrix product, independent of the kernels' order of
    additions (_tile_logits), so tests can hold the kernels against them."""
    K_pad = words.shape[1]
    sh = torch.arange(32, device=words.device, dtype=torch.int32)
    hT = ((words[g][None, :] >> sh[:, None]) & 1).to(dl.dtype)  # [32, K_pad]
    logm = dl[:, g * 32:(g + 1) * 32] @ hT
    lane = torch.arange(K_pad, device=words.device)
    logm = torch.where(lane[None, :] < K, logm, _NEG)
    mx = logm.amax(1, keepdim=True)
    return torch.exp(logm - mx), mx


def _fwd_step_plain(alpha, x, stay, cj, K):
    """One grid of the fused forward in the kernel's algebra: alpha, x [B,
    K_pad] (normalised alphas, logits; columns >= K do not count). Thread t
    of the kernel holds the columns t, t + NT, ...: its logit maximum m_t
    and its sum s_t of a = (stay alpha + cj) e^(x - m_t); the pairs combine
    to (mx, ssum) and alpha <- a e^(m_t - mx) / ssum. Returns (alpha, mx,
    ssum), the last two [B, 1]."""
    B, K_pad = x.shape
    n = -(-K_pad // _NT) * _NT
    real = (torch.arange(n, device=x.device) < K).view(-1, _NT)
    xg = torch.full((B, n), _NEG, dtype=torch.float32, device=x.device)
    ag = torch.zeros((B, n), dtype=torch.float32, device=x.device)
    xg[:, :K_pad], ag[:, :K_pad] = x, alpha
    xg = torch.where(real, xg.view(B, -1, _NT), _NEG)
    mt = xg.amax(1, keepdim=True)                                     # [B, 1, NT]
    a = torch.where(real, (stay * ag.view(B, -1, _NT) + cj) * torch.exp(xg - mt), 0.0)
    mx = mt.amax(2)                                                   # [B, 1]
    f = torch.exp(mt[:, 0] - mx)                                      # [B, NT]
    ssum = (a.sum(1) * f).sum(1, keepdim=True)
    return (a * (f / ssum)[:, None, :]).reshape(B, n)[:, :K_pad], mx, ssum


def fb_forward_plain(dl, words, trans2, K, CG=None):
    """Plain PyTorch version of fb_forward (Pallas _fwd_kernel), in the
    kernel's online (m, s) form."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    CG = fused_cg(K_pad, Gp) if CG is None else CG
    alpha = torch.zeros((B, K_pad), dtype=torch.float32, device=dl.device)
    acc = torch.zeros((B, 1), dtype=torch.float32, device=dl.device)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dl.device)
    for g in range(Gp):
        if g % CG == 0:
            ckpt[g // CG] = alpha
        x = _tile_logits(dl, words, g, K, 0, K_pad)
        alpha, mx, ssum = _fwd_step_plain(alpha, x, trans2[0, g], trans2[1, g] * (1.0 / K), K)
        acc = acc + torch.log(ssum) + mx
    return ckpt, acc[:, 0]


def fb_backward_plain(dl, words, ckpt, trans2, thin, K, K_top, eps, CG=None, cap=None):
    """Plain PyTorch version of fb_backward (Pallas _bwd_kernel) in the
    kernel's algebra: chunk rematerialisation from the checkpoints (the
    forward's step), then per grid, with etb = e_{g+1} beta, c = jump/K of
    grid g+1 and se = sum etb: num = stay etb + c se, beta' = num / max num
    (max num = stay max etb + c se), gamma = alpha num / G with G = sum alpha
    num, and the dosages from the bit-masked sums of alpha num (the global
    last grid: stay 0, c se 1); e of grid g from its logits and the remat's
    maximum; top-K by iterative masked argmax (lowest index on ties), and
    the gamma sum at the grids that cap flags."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    CG = fused_cg(K_pad, Gp) if CG is None else CG
    NSC = Gp // CG
    dev = dl.device
    invK = 1.0 / K
    lane = torch.arange(K_pad, device=dev)
    sh = torch.arange(32, device=dev, dtype=torch.int32)
    dos = torch.empty((B, S), dtype=torch.float32, device=dev)
    tv = torch.zeros((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.zeros((Gp, B, K_top), dtype=torch.int32, device=dev)
    thin_h = thin.tolist()
    cap_h = [0.0] * Gp if cap is None else cap.tolist()
    gcap = None if cap is None else torch.zeros((B, K_pad), dtype=torch.float32, device=dev)
    beta = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    en = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    for s in range(NSC):
        ci = NSC - 1 - s
        alpha = ckpt[ci]
        alphas, mxs = [], []
        for j in range(CG):
            g = ci * CG + j
            x = _tile_logits(dl, words, g, K, 0, K_pad)
            alpha, mx, _ = _fwd_step_plain(alpha, x, trans2[0, g], trans2[1, g] * invK, K)
            alphas.append(alpha)
            mxs.append(mx)
        for j in range(CG - 1, -1, -1):
            g = ci * CG + j
            last = g == Gp - 1
            stay = 0.0 if last else trans2[0, g + 1]
            etb = en * beta
            x = _tile_logits(dl, words, g, K, 0, K_pad)
            en = torch.where(lane[None, :] < K, torch.exp(x - mxs[j]), 0.0)
            se = etb.sum(1, keepdim=True)
            cse = torch.ones_like(se) if last else trans2[1, g + 1] * invK * se
            num = stay * etb + cse
            beta = num * (1.0 / torch.clamp(stay * etb.amax(1, keepdim=True) + cse, min=1e-30))
            gr = alphas[j] * num
            G = gr.sum(1, keepdim=True)
            hN = ((words[g][:, None] >> sh[None, :]) & 1).to(torch.float32)
            dos[:, g * 32:(g + 1) * 32] = eps + (1.0 - 2.0 * eps) * ((gr @ hN) / G)
            gamma = gr / G
            if cap_h[g] > 0:
                gcap += torch.where(lane[None, :] < K, gamma, 0.0)
            if thin_h[g] >= 0:
                work = torch.where(lane[None, :] < K, gamma, -1.0)
                for t in range(K_top):
                    idx = work.argmax(1, keepdim=True)        # first maximum
                    tv[g, :, t] = work.gather(1, idx)[:, 0]
                    ti[g, :, t] = idx[:, 0].to(torch.int32)
                    work = work.scatter(1, idx, -2.0)
    return (dos, tv, ti) if cap is None else (dos, tv, ti, gcap)


def fb_core(gl, words, trans2, thin, K, K_top, ref_error, CG=None, cap=None):
    """The fused FB of one row batch, as quilt_tpu's fb_pallas_core: gl
    [B, 2, S] f32 (padded SNPs = 1), cap [Gp] f32 capture flags or None;
    CG the checkpoint interval (default fused_cg). Returns (dosage [B, S],
    log_like [B], top_vals, top_idx [Gp, B, K_top]) and, given cap, gcap
    [B, K_pad]."""
    eps = float(ref_error)
    dl, csum = _gl_log_ratios(gl, eps)
    ckpt, logs = fb_forward(dl, words, trans2, K, CG)
    dos, tv, ti, *gcap = fb_backward(dl, words, ckpt, trans2, thin, K, K_top, eps, CG, cap)
    return (dos, logs + csum, tv, ti, *gcap)


def _gl_log_ratios(gl, eps):
    """dl [B, S] = log t1 - log t0 and the per-row constant sum_s log t0."""
    t0 = gl[:, 0] * (1.0 - eps) + gl[:, 1] * eps
    t1 = gl[:, 0] * eps + gl[:, 1] * (1.0 - eps)
    lt0 = torch.log(torch.clamp(t0, min=1e-30))
    lt1 = torch.log(torch.clamp(t1, min=1e-30))
    return (lt1 - lt0).contiguous(), lt0.sum(-1)


# ---------------------------------------------------------------------------
# K-split ("tiled") family: one row's haplotypes over `splits` blocks
# ---------------------------------------------------------------------------
#
# Each wrapper takes k_tile, the haplotypes per block: on a CUDA tensor the
# kernel runs K_pad / k_tile concurrent blocks per row (1, 2, 4, 8 or 16, one
# thread-block cluster); on a CPU tensor the plain version walks the tiles
# in order, with any k_tile (the last tile may be ragged). Sums over K are
# taken tile by tile, so they depend on k_tile at rounding level and are
# reproducible for a given k_tile.
#
# The backward (csrc/fb_tiled.cu fb_backward_tiled) is one launch an FB
# call. Its checkpoint interval is tiled_cg(k_tile, Gp): the chunk whose
# rebuilt alphas (and, in the staged form, words) fit a block's shared
# memory. The wrapper picks the storage (_tiled_storage: shared-memory or
# global alpha planes, and the haplotypes a thread holds in registers,
# _TILED_CPTS, or 0 for the general form), sizes the scratch for it and
# passes both; the entry point refuses a choice without an instantiation.
# Its shared memory (fb_tiled.cu bwd_smem_floats): the warps' records
# (_TILED_RW floats each), two posts (the records' sums and the warps' top-K
# lists), the chunk's scalars, log-ratios and emission tables, and the
# chunk's planes of k_tile floats: its alphas, and in the staged form
# (_STAGED_CPT haplotypes a thread: e*beta and the dosage sums fill the
# registers) its words beside them.
_TILED_CPTS = (2, 4, 8, 16, 20, 24)
_STAGED_CPT = 24
_TILED_RW = 34
_SPLITS = (1, 2, 4, 8, 16)


def _bwd_tiled_smem_bytes(CG, KS, K_top, planes):
    """planes: 0 / False (global storage), 1 / True (the chunk's alpha
    planes) or 2 (the staged form's alpha and word planes)."""
    post = _r4(_TILED_RW + 2 * _NWARP * K_top)
    return 4 * (_r4(_NWARP * _TILED_RW) + 2 * post + _r4(4 * CG + 1) + _r4(CG * 32)
                + CG * _EMF + int(planes) * CG * KS)


def _tiled_cpt(KS):
    """The fewest haplotypes a thread of _TILED_CPTS that hold KS, else 0
    (the general form)."""
    return next((c for c in _TILED_CPTS if c * _NT >= KS), 0)


def _smem_planes(cpt):
    return 2 if cpt == _STAGED_CPT else 1


def kernel_tiled_smem_bytes(CG, KS, K_top, planes) -> int:
    """The tiled backward's shared memory in bytes as the kernel library
    computes it (fb_tiled.cu bwd_smem_floats): the layout that
    _bwd_tiled_smem_bytes copies, for tests to hold the two equal. Builds
    the library; needs nvcc, not a card."""
    fn = _build.load("fb_tiled").fb_backward_tiled_smem_bytes
    fn.argtypes, fn.restype = [_I] * 4, _I
    return fn(CG, KS, K_top, int(planes))


def tiled_cg(KS: int, Gp: int) -> int:
    """Checkpoint interval of the tiled family at KS haplotypes a block: the
    largest of 16, 8, 4, 2 dividing Gp whose planes fit the backward
    kernel's shared memory (16 up to KS = 3,296, 8 up to 6,752, 4 up to
    10,240; 2 from 10,241 to 12,288, where the staged form keeps a word
    plane beside each alpha plane; 4 again up to 13,696, 2 up to 27,552);
    above that GRID_CHUNK, with the planes in global memory."""
    planes = _smem_planes(_tiled_cpt(KS))
    for cg in (16, 8, 4, 2):
        if Gp % cg == 0 and _bwd_tiled_smem_bytes(cg, KS, _KTOP_RESERVE, planes) <= _SMEM_LIMIT:
            return cg
    return GRID_CHUNK


def _tiled_storage(CG, KS, K_top, general=False):
    """(alpha planes in shared memory?, haplotypes a thread in registers or
    0 for the general form) of the tiled backward at KS haplotypes a block
    and interval CG. The staged form (_STAGED_CPT) needs its word planes
    beside the alpha planes; at an interval where they do not fit (a CG
    forced by a caller, never tiled_cg's) the general form takes the block.
    `general` forces the general form (tests and timings only)."""
    cpt = 0 if general else _tiled_cpt(KS)
    if cpt == _STAGED_CPT and _bwd_tiled_smem_bytes(CG, KS, K_top, 2) > _SMEM_LIMIT:
        cpt = 0
    smem = _bwd_tiled_smem_bytes(CG, KS, K_top, _smem_planes(cpt)) <= _SMEM_LIMIT
    return smem, cpt if smem else 0


def _fwd_tiled_cpt(KS, general=False):
    """Haplotypes a thread of the tiled forward holds in registers at KS
    haplotypes a block (the backward's register instantiations; at 24 the
    staged form, its next words in shared memory), or 0 for the general
    form, whose alphas live in a global plane a row."""
    return 0 if general else _tiled_cpt(KS)


def _tiled_scratch_planes(CG, KS, K_top, general=False):
    """Global planes of K_pad floats a row of the tiled backward: the
    general form's e*beta plane, and the chunk's alphas where they do not
    fit shared memory."""
    smem, cpt = _tiled_storage(CG, KS, K_top, general)
    return (1 if cpt == 0 else 0) + (0 if smem else CG)


def _tiled_planes(K_pad, Gp, splits):
    """Planes of K_pad floats a row of one tiled FB call: the checkpoints,
    the forward's alpha plane (general form only) and the backward's
    scratch planes."""
    KS = K_pad // splits
    cg = tiled_cg(KS, Gp)
    return (Gp // cg + (1 if _fwd_tiled_cpt(KS) == 0 else 0)
            + _tiled_scratch_planes(cg, KS, _KTOP_RESERVE))


def _splits(K_pad, k_tile):
    splits = K_pad // k_tile
    if splits * k_tile != K_pad or splits not in _SPLITS:
        raise ValueError(f"on the GPU k_tile must cut K_pad={K_pad} into 1, 2, 4, 8 or 16 "
                         f"blocks, got k_tile={k_tile}")
    return splits


def _check_tiled(dl, words, K, k_tile, CG):
    Gp, K_pad = words.shape
    _check(dl, "dl", torch.float32, (dl.shape[0], Gp * 32), dl.device)
    _check(words, "words", torch.int32, (Gp, K_pad), dl.device)
    if Gp % CG or not 0 < K <= K_pad or k_tile < 1:
        raise ValueError(f"bad Gp={Gp} / CG={CG} / K={K} / k_tile={k_tile}")


def fb_max_tiled(dl, words, K, k_tile, _prev=False):
    """mx [Gp, B]: per (grid, row) the maximum over the K haplotypes of
    the emission logit dl[b, g*32:(g+1)*32] . bits[k]. The kernel adds a
    logit's log-ratios by byte tables, in another order than the plain
    version's nibble order: the two agree within max_tiled_tolerance.
    Private, timings only: _prev launches the previous form (nibble order,
    equal to the plain version)."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    _check_tiled(dl, words, K, k_tile, 1)
    if dl.device.type == "cpu":
        return fb_max_tiled_plain(dl, words, K, k_tile)
    splits = _splits(K_pad, k_tile)
    if _prev:
        mx = torch.full((Gp, B), float("-inf"), dtype=torch.float32, device=dl.device)
        _PREV_MAX_TILED.launch(words.data_ptr(), dl.data_ptr(), mx.data_ptr(),
                               Gp, K, K_pad, B, splits)
        return mx
    mx = torch.empty((Gp, B), dtype=torch.float32, device=dl.device)
    MAX_TILED_KERNEL.launch(words.data_ptr(), dl.data_ptr(), mx.data_ptr(), Gp, K, K_pad, B)
    return mx


def max_tiled_tolerance(dl, Gp):
    """[Gp, B]: how far fb_max_tiled's mx may lie from its plain version's.
    Both build a logit's 8 nibble sums alike (fb_common.cuh nibble_sum, the
    plain _tile_logits: the same additions in the same order, so the same
    bits) and differ only in the 7 additions that combine them: in nibble
    order in the plain version, by byte pairs and then bytes in the kernel.
    Each of the two is within gamma_7 = 7u / (1 - 7u) (u = 2^-24) x the sum
    of the nibble sums' magnitudes, at most sum |dl|, of the nibble sums'
    exact total, and the maximum moves no further than its arguments."""
    u = 2.0 ** -24
    return (14 * u / (1 - 7 * u)) * dl.abs().reshape(dl.shape[0], Gp, 32).sum(2).T


def fb_forward_tiled(dl, words, trans2, mx, K, k_tile, CG=None, _prev=False, _general=False):
    """Forward pass against the pre-computed emission maxima mx [Gp, B]; CG
    the checkpoint interval (default tiled_cg). Returns (ckpt [Gp/CG, B,
    K_pad], S [Gp, B], logs [B]): checkpoint c is the UNNORMALISED alpha
    entering chunk c (zeros for c = 0; the Pallas kernel's block c held the
    alpha entering chunk c+1), S[g] = sum_k of the unnormalised alpha of
    grid g, which normalises it, and logs the log-likelihood sum_g (log S[g]
    + mx[g]) without the per-row constant. One kernel launch on the card,
    its alphas in registers (_fwd_tiled_cpt) or, above 24 haplotypes a
    thread, in a global plane a row.
    Private, tests and timings only: _prev launches the previous form
    (csrc/fb_tiled_prev.cu); _general forces the general form."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    CG = tiled_cg(k_tile, Gp) if CG is None else CG
    _check_tiled(dl, words, K, k_tile, CG)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    _check(mx, "mx", torch.float32, (Gp, B), dev)
    if dev.type == "cpu":
        return fb_forward_tiled_plain(dl, words, trans2, mx, K, k_tile, CG)
    splits = _splits(K_pad, k_tile)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dev)
    S = torch.empty((Gp, B), dtype=torch.float32, device=dev)
    logs = torch.empty((B,), dtype=torch.float32, device=dev)
    cpt = _fwd_tiled_cpt(k_tile, _general)
    general = _prev or cpt == 0
    scratch = torch.empty((B, K_pad) if general else (1,), dtype=torch.float32, device=dev)
    args = (words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(), ckpt.data_ptr(),
            S.data_ptr(), logs.data_ptr(), scratch.data_ptr(), Gp, K, K_pad, B, CG, splits,
            1.0 / K)
    if _prev:
        _PREV_FWD_TILED.launch(*args)
    else:
        FWD_TILED_KERNEL.launch(*args, cpt)
    return ckpt, S, logs


def fb_backward_tiled(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps, k_tile, CG=None,
                      _prev=False, _general=False, _rebuilt=None):
    """Backward pass of a whole FB call from the forward's checkpoints
    ckpt [Gp/CG, B, K_pad] (CG as given to fb_forward_tiled), its S and the
    emission maxima mx [Gp, B]: per chunk from the last to the first, the
    chunk's alphas rebuilt, then its grids descending, carrying e*beta and
    its sum over K between chunks. Returns (dos [B, Gp*32] per-SNP
    dosages, tv / ti [Gp, B, K_top] top gammas and their haplotype indices,
    zero away from thinned grids). One kernel launch on the card.
    Private: _prev (timings only) launches the previous form, a remat and a
    backward kernel per chunk (csrc/fb_tiled_prev.cu); _general (tests and
    timings only) forces the general form; _rebuilt (tests only) is a [Gp,
    B, K_pad] tensor that receives the raw rebuilt alphas."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    CG = tiled_cg(k_tile, Gp) if CG is None else CG
    _check_tiled(dl, words, K, k_tile, CG)
    _check(ckpt, "ckpt", torch.float32, (Gp // CG, B, K_pad), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    _check(mx, "mx", torch.float32, (Gp, B), dev)
    _check(S, "S", torch.float32, (Gp, B), dev)
    if not 0 < K_top <= min(K, k_tile):
        raise ValueError(f"bad K_top={K_top} for K={K} / k_tile={k_tile}")
    if dev.type == "cpu":
        return fb_backward_tiled_plain(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps,
                                       k_tile, CG)
    splits = _splits(K_pad, k_tile)
    if _prev:
        return _backward_tiled_prev(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps,
                                    splits, CG)
    dos = torch.empty((B, Gp * 32), dtype=torch.float32, device=dev)
    tv = torch.empty((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.empty((Gp, B, K_top), dtype=torch.int32, device=dev)
    smem, cpt = _tiled_storage(CG, k_tile, K_top, _general)
    planes = _tiled_scratch_planes(CG, k_tile, K_top, _general)
    scratch = torch.empty((B, planes, K_pad) if planes else (1,), dtype=torch.float32, device=dev)
    if _rebuilt is not None:
        _check(_rebuilt, "_rebuilt", torch.float32, (Gp, B, K_pad), dev)
    BWD_TILED_KERNEL.launch(words.data_ptr(), dl.data_ptr(), ckpt.data_ptr(), trans2.data_ptr(),
                            thin.data_ptr(), mx.data_ptr(), S.data_ptr(), dos.data_ptr(),
                            tv.data_ptr(), ti.data_ptr(), scratch.data_ptr(),
                            None if _rebuilt is None else _rebuilt.data_ptr(), Gp, K, K_pad, B,
                            CG, K_top, splits, 1.0 / K, float(eps), int(smem), cpt)
    return dos, tv, ti


def _backward_tiled_prev(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps, splits, CG):
    """fb_backward_tiled by the previous form: per chunk a remat launch
    writing the chunk's alphas to device memory and a backward launch
    reading them and the e*beta carry (csrc/fb_tiled_prev.cu)."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    eb = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    E = torch.full((B,), float(K), dtype=torch.float32, device=dev)
    dos = torch.empty((B, Gp * 32), dtype=torch.float32, device=dev)
    tv = torch.empty((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.empty((Gp, B, K_top), dtype=torch.int32, device=dev)
    alphas = torch.empty((CG, B, K_pad), dtype=torch.float32, device=dev)
    work = torch.empty((B, K_pad), dtype=torch.float32, device=dev)
    eb_out, E_out = torch.empty_like(eb), torch.empty_like(E)
    dos_c = torch.empty((B, CG * 32), dtype=torch.float32, device=dev)
    for ci in range(Gp // CG - 1, -1, -1):
        _PREV_REMAT_TILED.launch(words.data_ptr(), dl.data_ptr(), ckpt[ci].data_ptr(),
                                 trans2.data_ptr(), mx.data_ptr(), S.data_ptr(),
                                 alphas.data_ptr(), Gp, K, K_pad, B, CG, ci, splits, 1.0 / K)
        _PREV_BWD_TILED.launch(words.data_ptr(), dl.data_ptr(), alphas.data_ptr(),
                               trans2.data_ptr(), thin.data_ptr(), mx.data_ptr(),
                               eb.data_ptr(), E.data_ptr(), dos_c.data_ptr(),
                               tv[ci * CG].data_ptr(), ti[ci * CG].data_ptr(),
                               eb_out.data_ptr(), E_out.data_ptr(), work.data_ptr(), Gp, K,
                               K_pad, B, CG, ci, K_top, splits, 1.0 / K, float(eps))
        dos[:, ci * CG * 32:(ci + 1) * CG * 32] = dos_c
        eb, eb_out, E, E_out = eb_out, eb, E_out, E
    return dos, tv, ti


def tiled_active_clusters(splits: int, KS: int, fwd: bool = False) -> int:
    """The clusters of `splits` blocks that the card can hold at once for
    the tiled backward (or forward) in the form fb_backward_tiled /
    fb_forward_tiled take at KS haplotypes a block
    (cudaOccupancyMaxActiveClusters; 0: the entry points refuse the shape).
    Needs the card."""
    cg = tiled_cg(KS, GRID_CHUNK)
    cpt = _fwd_tiled_cpt(KS) if fwd else _tiled_storage(cg, KS, _KTOP_RESERVE)[1]
    fn = _build.load("fb_tiled").fb_tiled_active_clusters
    fn.argtypes, fn.restype = [_I] * 5 + [ctypes.POINTER(_I)], _I
    active = _I(0)
    err = fn(splits, KS, cg, cpt, int(fwd), ctypes.byref(active))
    if err:
        raise RuntimeError(f"fb_tiled_active_clusters: cudaError {err}")
    return active.value


def tiled_chain_floor(steps: int, B: int, splits: int, device, fwd=False) -> torch.Tensor:
    """Launches `steps` steps of the tiled backward (fwd False: the 34-value
    block reduction, the post, the cluster barrier and the reads of the
    posts) or of the tiled forward (fwd True: each warp's shuffle sum
    posted, the cluster barrier, the NS x 16 posts read by every warp), with
    no haplotype work, on B clusters of `splits` blocks: timed, it gives the
    least a step of that kernel can take on the card."""
    if torch.device(device).type != "cuda":
        raise ValueError("tiled_chain_floor times the card and needs a CUDA device")
    out = torch.empty((B, splits), dtype=torch.float32, device=device)
    TILED_FLOOR_KERNEL.launch(out.data_ptr(), splits, B, steps, int(fwd))
    return out


def _tile_logits(dl, words, g, K, k0, k1):
    """Emission logits [B, k1-k0] of grid g for haplotypes k0..k1-1 (pads
    -1e30) in the CUDA kernels' order (fb_common.cuh): per nibble of the
    panel word the sum of its set bits' log-ratios in bit order (bit x
    log-ratio is exact), then the 8 nibble sums in order, so the kernels and
    their plain versions start from identical emissions."""
    sh = torch.arange(32, device=words.device, dtype=torch.int32)
    hT = ((words[g, k0:k1][None, :] >> sh[:, None]) & 1).to(torch.float32)
    d = dl[:, g * 32:(g + 1) * 32]
    logm = None
    for q in range(8):
        nib = torch.zeros((dl.shape[0], k1 - k0), dtype=torch.float32, device=dl.device)
        for s in range(4 * q, 4 * q + 4):
            nib.addcmul_(d[:, s:s + 1], hT[s][None, :])
        logm = nib if logm is None else logm + nib
    lane = torch.arange(k0, k1, device=words.device)
    return torch.where(lane[None, :] < K, logm, _NEG)


def _tiles(K_pad, k_tile):
    return [(k0, min(k0 + k_tile, K_pad)) for k0 in range(0, K_pad, k_tile)]


def fb_max_tiled_plain(dl, words, K, k_tile):
    """Plain PyTorch version of fb_max_tiled (Pallas _max_kernel_tiled)."""
    Gp, K_pad = words.shape
    mx = torch.empty((Gp, dl.shape[0]), dtype=torch.float32, device=dl.device)
    for g in range(Gp):
        mx[g] = torch.stack([_tile_logits(dl, words, g, K, k0, k1).amax(1)
                             for k0, k1 in _tiles(K_pad, k_tile)]).amax(0)
    return mx


def fb_forward_tiled_plain(dl, words, trans2, mx, K, k_tile, CG=None):
    """Plain PyTorch version of fb_forward_tiled (Pallas _fwd_kernel_tiled)."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    CG = tiled_cg(k_tile, Gp) if CG is None else CG
    alpha = torch.zeros((B, K_pad), dtype=torch.float32, device=dev)
    inv_sprev = torch.ones((B, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B,), dtype=torch.float32, device=dev)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dev)
    S = torch.empty((Gp, B), dtype=torch.float32, device=dev)
    for g in range(Gp):
        if g % CG == 0:
            ckpt[g // CG] = alpha
        a_new = torch.empty_like(alpha)
        tot = torch.zeros((B,), dtype=torch.float32, device=dev)
        for k0, k1 in _tiles(K_pad, k_tile):
            e = torch.exp(_tile_logits(dl, words, g, K, k0, k1) - mx[g][:, None])
            a = (trans2[0, g] * (alpha[:, k0:k1] * inv_sprev) + trans2[1, g] * (1.0 / K)) * e
            a_new[:, k0:k1] = a
            tot = tot + a.sum(1)
        alpha = a_new
        S[g] = tot
        inv_sprev = (1.0 / tot)[:, None]
        acc = acc + torch.log(tot) + mx[g]
    return ckpt, S, acc


def fb_remat_tiled_plain(dl, words, ckpt_c, trans2, mx, S, ci, K, k_tile, CG):
    """The normalised alphas [CG, B, K_pad] of chunk ci from its checkpoint
    ckpt_c [B, K_pad] and the forward's stored S and mx [Gp, B] (Pallas
    _remat_kernel_tiled)."""
    B = dl.shape[0]
    K_pad = words.shape[1]
    alphas = torch.empty((CG, B, K_pad), dtype=torch.float32, device=dl.device)
    for k0, k1 in _tiles(K_pad, k_tile):
        a = ckpt_c[:, k0:k1]
        for j in range(CG):
            g = ci * CG + j
            inv_sprev = 1.0 / S[g - 1][:, None] if g > 0 else 1.0
            e = torch.exp(_tile_logits(dl, words, g, K, k0, k1) - mx[g][:, None])
            a = (trans2[0, g] * (a * inv_sprev) + trans2[1, g] * (1.0 / K)) * e
            alphas[j, :, k0:k1] = a * (1.0 / S[g][:, None])
    return alphas


def _top_lists(vals, idx, K_top):
    """K_top rounds of first-maximum extraction over vals [B, n] (candidates
    in ascending haplotype order, so the first maximum has the lowest
    index): (values, idx gathered) [B, K_top]."""
    work = vals.clone()
    tv, ti = [], []
    for _ in range(K_top):
        pos = work.argmax(1, keepdim=True)
        tv.append(work.gather(1, pos))
        ti.append(idx.gather(1, pos))
        work = work.scatter(1, pos, -3.0)
    return torch.cat(tv, 1), torch.cat(ti, 1)


def _bwd_chunk_tiled_plain(dl, words, alphas, trans2, thin, mx, eb, E, ci, K, K_top, eps,
                           k_tile, CG):
    """The backward over chunk ci, grids descending, from the chunk's
    normalised alphas [CG, B, K_pad] (Pallas _bwd_kernel_tiled and
    _merge_topk): per tile the partial AB, E, dosage sums and the tile's own
    top K_top; the tiles' lists merge by value descending, lowest haplotype
    index on ties. eb [B, K_pad] and E [B] carry e*beta and its sum over K
    of the grid after the chunk (ones and K above the last chunk, whose last
    grid has beta = 1). Returns (dos [B, CG*32], tv / ti [CG, B, K_top],
    and the carries eb', E' of the chunk's first grid)."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    sh = torch.arange(32, device=dev, dtype=torch.int32)
    dos = torch.empty((B, CG * 32), dtype=torch.float32, device=dev)
    tv = torch.zeros((CG, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.zeros((CG, B, K_top), dtype=torch.int32, device=dev)
    thin_h = thin[ci * CG:(ci + 1) * CG].tolist()
    tiles = _tiles(K_pad, k_tile)
    for j in range(CG - 1, -1, -1):
        g = ci * CG + j
        last = g == Gp - 1
        inv_e = 1.0 / torch.clamp(E, min=1e-30)[:, None]
        eb_new = torch.empty_like(eb)
        ab = torch.zeros((B,), dtype=torch.float32, device=dev)
        e_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
        part = torch.zeros((B, 32), dtype=torch.float32, device=dev)
        cand_v, cand_i = [], []
        for k0, k1 in tiles:
            if last:
                beta = torch.ones((B, k1 - k0), dtype=torch.float32, device=dev)
            else:
                beta = (trans2[0, g + 1] * (eb[:, k0:k1] * inv_e)
                        + trans2[1, g + 1] * (1.0 / K))
            gu = alphas[j, :, k0:k1] * beta
            ab = ab + gu.sum(1)
            hN = ((words[g, k0:k1][:, None] >> sh[None, :]) & 1).to(torch.float32)
            part = part + gu @ hN
            if thin_h[j] >= 0:
                lane = torch.arange(k0, k1, device=dev)
                v, i = _top_lists(torch.where(lane[None, :] < K, gu, -1.0),
                                  lane[None, :].expand(B, -1), K_top)
                cand_v.append(v)
                cand_i.append(i)
            e = torch.exp(_tile_logits(dl, words, g, K, k0, k1) - mx[g][:, None])
            eb_new[:, k0:k1] = e * beta
            e_sum = e_sum + eb_new[:, k0:k1].sum(1)
        inv_ab = 1.0 / torch.clamp(ab, min=1e-30)[:, None]
        dos[:, j * 32:(j + 1) * 32] = eps + (1.0 - 2.0 * eps) * part * inv_ab
        if thin_h[j] >= 0:
            # within a tile equal values are listed lowest index first and the
            # tiles ascend, so the first maximum has the lowest index
            v, i = _top_lists(torch.cat(cand_v, 1), torch.cat(cand_i, 1), K_top)
            tv[j] = v * inv_ab
            ti[j] = i.to(torch.int32)
        eb, E = eb_new, e_sum
    return dos, tv, ti, eb, E


def fb_backward_tiled_plain(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps, k_tile,
                            CG=None):
    """Plain PyTorch version of fb_backward_tiled: per chunk from the last
    to the first, fb_remat_tiled_plain then _bwd_chunk_tiled_plain, carrying
    e*beta and its sum between chunks."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    dev = dl.device
    CG = tiled_cg(k_tile, Gp) if CG is None else CG
    eb = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    E = torch.full((B,), float(K), dtype=torch.float32, device=dev)
    chunks = []
    for ci in range(Gp // CG - 1, -1, -1):
        alphas = fb_remat_tiled_plain(dl, words, ckpt[ci], trans2, mx, S, ci, K, k_tile, CG)
        dos, tv, ti, eb, E = _bwd_chunk_tiled_plain(dl, words, alphas, trans2, thin, mx, eb, E,
                                                    ci, K, K_top, eps, k_tile, CG)
        chunks.append((dos, tv, ti))
    chunks.reverse()
    return (torch.cat([c[0] for c in chunks], dim=1), torch.cat([c[1] for c in chunks]),
            torch.cat([c[2] for c in chunks]))


def fb_tiled_core(gl, words, trans2, thin, K, K_top, ref_error, k_tile, CG=None):
    """The K-split FB of one row batch, with the contract of fb_core
    (quilt_tpu's fb_pallas_tiled_core without its all-zero capture output):
    the emission-maximum pre-pass, the forward, then the backward, one
    kernel launch each on the card; CG the checkpoint interval (default
    tiled_cg). Returns (dosage [B, S], log_like [B], top_vals, top_idx
    [Gp, B, K_top])."""
    eps = float(ref_error)
    Gp = words.shape[0]
    CG = tiled_cg(k_tile, Gp) if CG is None else CG
    dl, csum = _gl_log_ratios(gl, eps)
    mx = fb_max_tiled(dl, words, K, k_tile)
    ckpt, S, logs = fb_forward_tiled(dl, words, trans2, mx, K, k_tile, CG)
    dos, tv, ti = fb_backward_tiled(dl, words, ckpt, trans2, thin, mx, S, K, K_top, eps,
                                    k_tile, CG)
    return dos, logs + csum, tv, ti


def _plan_cost(B, K_pad, Gp, splits, per_call):
    """fb_plan's estimated cost of B rows at `splits` blocks a row (1: the
    fused family), per_call rows a core call: waves x a wave's cost in
    haplotypes a grid (see _BLOCK_OVERHEAD_K). A fused wave holds at most
    _N_SM rows, a split one _ACTIVE_CLUSTERS[splits]."""
    calls = [per_call] * (B // per_call) + ([B % per_call] if B % per_call else [])
    if splits == 1:
        return sum(-(-r // _N_SM) for r in calls) * K_pad * (
            _FUSED_WIDE_COST if K_pad > _TILED_MIN_K else 1.0)
    KS = K_pad // splits
    cg = tiled_cg(KS, Gp)
    smem, cpt = _tiled_storage(cg, KS, _KTOP_RESERVE)
    form = ((_GENERAL_FORM_COST * (_INTERVAL2_COST if cg == 2 else 1.0) if cpt == 0 else 1.0)
            * (1.0 if smem else _GLOBAL_PLANES_COST))
    waves = sum(-(-r // _ACTIVE_CLUSTERS[splits]) for r in calls)
    return waves * (KS + _BLOCK_OVERHEAD_K) * form


def fb_plan(B: int, fb: FBInputs, family: Optional[str] = None,
            splits: Optional[int] = None, capture: bool = False) -> Tuple[str, int, int]:
    """("fused" | "tiled", rows per core call, K splits) for B rows: the
    counterpart of quilt_tpu/kernels/fb_full.py:_pallas_plan on this card.

    Rows are independent, so a call takes as many as fit _CALL_BYTES (per
    row, fused: Gp/CG checkpoints at CG = fused_cg, and the backward's
    global planes, none where its state and alphas fit the SM (K_pad <=
    8,192), else 4 state planes + CG alphas where those do not fit shared
    memory; tiled: Gp/CG checkpoints at CG = tiled_cg, the general forward's
    alpha plane and the backward's scratch planes, _tiled_planes). Of the fused
    family and the splits of 2, 4, 8 and 16 blocks a row, the plan takes the
    least cost (_plan_cost) over all the core calls of B rows. Measured on
    the H100 (512 grids, 14 to 200 rows x K = 5,120 .. 194,512, chip_smoke.py's
    "fb_plan timing" lines, tabulated in PERF.md §6 "fb_plan"): this takes
    the fastest choice at every timed shape, e.g. 8 blocks of 640 at 14 x
    5,120 (3.55 ms against 3.86 for 4), fused at 84 and 112 x 5,120 (7.79 /
    7.73 against 9.09 / 9.13 for 2 blocks), 2 blocks at 200 x 8,192 (22.94
    against 29.02 fused), 4 at 28 and 112 x 40,960 (11.99 / 46.71 against
    14.27 / 55.79 for 8), at 16 rows x 98,304 16 blocks (25.87 against
    30.10 for 8), at 112 rows 8 in the staged form (118.36 against 128.09
    for 16, whose 7 clusters at once take 16 waves), and 16 at 16 and 112
    x 194,512 (45.74 / 245.42 ms against 69.81 / 394.19 for 8).
    A call that captures gamma (`capture`) is fused: only the fused
    backward captures, as on the TPU (fb_pallas.py:659-663).
    `family` / `splits` force the choice (tests, timings)."""
    if family not in (None, "fused", "tiled"):
        raise ValueError(f"unknown FB family {family!r}")
    if capture:
        if family == "tiled":
            raise NotImplementedError(
                "gamma capture (the HLA run) is a part of the fused FB only, "
                "as in the JAX package; the K-split family cannot be forced with it")
        family = "fused"
    cg_f = fused_cg(fb.K_pad, fb.nGrids)
    fused_planes = fb.nGrids // cg_f + _bwd_scratch_planes(cg_f, fb.K_pad, _KTOP_RESERVE)

    def rows(planes):
        return max(1, min(B, _CALL_BYTES // (planes * fb.K_pad * 4)))

    def tiled_rows(s):
        return rows(_tiled_planes(fb.K_pad, fb.nGrids, s))

    if splits is None:
        splits = min((1,) + tuple(s for s in _SPLITS[1:] if fb.K_pad >= _TILED_MIN_K
                                  and fb.K_pad // s >= _MIN_K_PER_SPLIT),
                     key=lambda s: _plan_cost(B, fb.K_pad, fb.nGrids, s,
                                              rows(fused_planes) if s == 1 else tiled_rows(s)))
    elif splits not in _SPLITS:
        raise ValueError(f"splits must be 1, 2, 4, 8 or 16, got {splits}")
    if family is None:
        family = "tiled" if splits > 1 else "fused"
    if family == "fused":
        return family, rows(fused_planes), 1
    return family, tiled_rows(splits), splits


def fb_full_batched(gl, fb: FBInputs, K_top=16, ref_error=0.001, family=None, splits=None):
    """Batched FB over the whole panel. gl [B, 2, S] tensor (padded to
    fb.S, or shorter and padded here with 1). family / splits go to
    fb_plan. Returns device tensors (dosage [B, S], log_like [B],
    top_vals [Gp, B, K_top], top_idx) and, when fb.capture_grid >= 0, the
    normalised gamma at that grid, gcap [B, K] (quilt_tpu/kernels/
    fb_full.py:fb_full_batched returns it so)."""
    dev = fb.device_tensors(gl.device)
    B = gl.shape[0]
    if gl.shape[2] != fb.S:
        pad = torch.ones((B, 2, fb.S), dtype=torch.float32, device=gl.device)
        pad[:, :, :gl.shape[2]] = gl
        gl = pad
    family, step, splits = fb_plan(B, fb, family, splits, capture=fb.capture_grid >= 0)
    args = (dev["words"], dev["trans2"], dev["thin_flag"], fb.K, K_top, ref_error)
    if family == "tiled":
        core = lambda rows: fb_tiled_core(rows, *args, k_tile=fb.K_pad // splits)
    else:
        core = lambda rows: fb_core(rows, *args, cap=dev["capture_flag"])
    parts = [core(gl[b0:b0 + step]) for b0 in range(0, B, step)]
    out = parts[0] if len(parts) == 1 else tuple(
        torch.cat([p[i] for p in parts], dim=1 if i in (2, 3) else 0)
        for i in range(len(parts[0])))
    if fb.capture_grid >= 0:
        out = out[:4] + (out[4][:, :fb.K],)
    return out
