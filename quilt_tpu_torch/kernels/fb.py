"""Full-panel haploid forward-backward: CUDA kernels, plain versions and the
batched driver.

Counterparts of quilt_tpu/kernels/fb_pallas.py:fb_pallas_core (Pallas
kernels _fwd_kernel and _bwd_kernel) and quilt_tpu/kernels/fb_full.py:
fb_full_batched. The emission factorisation is the Pallas one: with
t0/t1 the GL terms of hap allele 0/1 and dl = log t1 - log t0, the log
emission of haplotype k in grid g is sum_s log t0[s] + sum_s bit_k,s dl[s];
the first term is a per-row constant added to the log-likelihood outside
the kernels, the second is a 32-term dot with the grid's panel bits.

Sizing: K_pad (multiple of 128) and the grid padding to GRID_CHUNK = 16
come from the prepared inputs (inputs.FBInputs) and are kept; CG = 16 is
also the checkpoint interval of the forward. Gamma capture (the HLA run's
`cap` input) is not in this slice.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check_tensor as _check
from ..inputs import GRID_CHUNK, FBInputs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_KERNEL = Kernel("fb", "fb_forward", [_P] * 6 + [_I] * 5 + [_F])
BWD_KERNEL = Kernel("fb", "fb_backward", [_P] * 9 + [_I] * 6 + [_F, _F])
_NEG = -1e30
# device-memory budget of one kernel call's checkpoints + scratch (the
# H100 plan: rows per call = budget / per-row bytes)
_CALL_BYTES = 4 << 30


def fb_forward(dl, words, trans2, K, CG=GRID_CHUNK):
    """Forward pass. dl [B, S] f32 GL log-ratios (S = Gp*32); words
    [Gp, K_pad] i32 packed panel bits; trans2 [2, Gp] f32 (stay, jump)
    into each grid. Returns (ckpt [Gp/CG, B, K_pad] alphas entering each
    chunk, logs [B] log-likelihood without the per-row constant)."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    dev = dl.device
    _check(dl, "dl", torch.float32, (B, Gp * 32), dev)
    _check(words, "words", torch.int32, (Gp, K_pad), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    if Gp % CG or not 0 < K <= K_pad:
        raise ValueError(f"bad Gp={Gp} / CG={CG} / K={K}")
    if dev.type == "cpu":
        return fb_forward_plain(dl, words, trans2, K, CG)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dev)
    logs = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, 2, K_pad), dtype=torch.float32, device=dev)
    FWD_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(),
                      ckpt.data_ptr(), logs.data_ptr(), scratch.data_ptr(),
                      Gp, K, K_pad, B, CG, 1.0 / K)
    return ckpt, logs


def fb_backward(dl, words, ckpt, trans2, thin, K, K_top, eps, CG=GRID_CHUNK):
    """Backward pass from the forward's checkpoints. thin [Gp] i32 (>= 0 at
    thinned grids). Returns (dos [B, S] f32 per-SNP dosages, tv/ti
    [Gp, B, K_top] top gammas and their haplotype indices, zero away from
    thinned grids)."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    dev = dl.device
    _check(dl, "dl", torch.float32, (B, Gp * 32), dev)
    _check(words, "words", torch.int32, (Gp, K_pad), dev)
    _check(ckpt, "ckpt", torch.float32, (Gp // CG, B, K_pad), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    if Gp % CG or not 0 < K_top <= K <= K_pad:
        raise ValueError(f"bad Gp={Gp} / CG={CG} / K={K} / K_top={K_top}")
    if dev.type == "cpu":
        return fb_backward_plain(dl, words, ckpt, trans2, thin, K, K_top, eps, CG)
    dos = torch.empty((B, S), dtype=torch.float32, device=dev)
    tv = torch.empty((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.empty((Gp, B, K_top), dtype=torch.int32, device=dev)
    scratch = torch.empty((B, 2 * CG + 3, K_pad), dtype=torch.float32, device=dev)
    BWD_KERNEL.launch(words.data_ptr(), dl.data_ptr(), ckpt.data_ptr(),
                      trans2.data_ptr(), thin.data_ptr(), dos.data_ptr(),
                      tv.data_ptr(), ti.data_ptr(), scratch.data_ptr(),
                      Gp, K, K_pad, B, CG, K_top, 1.0 / K, float(eps))
    return dos, tv, ti


def _emissions(dl, words, g, K):
    """Plain per-grid emissions scaled to max 1, and their log max."""
    K_pad = words.shape[1]
    sh = torch.arange(32, device=words.device, dtype=torch.int32)
    hT = ((words[g][None, :] >> sh[:, None]) & 1).to(torch.float32)  # [32, K_pad]
    logm = dl[:, g * 32:(g + 1) * 32] @ hT
    lane = torch.arange(K_pad, device=words.device)
    logm = torch.where(lane[None, :] < K, logm, _NEG)
    mx = logm.amax(1, keepdim=True)
    return torch.exp(logm - mx), mx


def fb_forward_plain(dl, words, trans2, K, CG=GRID_CHUNK):
    """Plain PyTorch version of fb_forward (Pallas _fwd_kernel)."""
    B = dl.shape[0]
    Gp, K_pad = words.shape
    alpha = torch.zeros((B, K_pad), dtype=torch.float32, device=dl.device)
    acc = torch.zeros((B, 1), dtype=torch.float32, device=dl.device)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=dl.device)
    for g in range(Gp):
        if g % CG == 0:
            ckpt[g // CG] = alpha
        e, mx = _emissions(dl, words, g, K)
        a_raw = (trans2[0, g] * alpha + trans2[1, g] * (1.0 / K)) * e
        ssum = a_raw.sum(1, keepdim=True)
        alpha = a_raw / ssum
        acc = acc + torch.log(ssum) + mx
    return ckpt, acc[:, 0]


def fb_backward_plain(dl, words, ckpt, trans2, thin, K, K_top, eps, CG=GRID_CHUNK):
    """Plain PyTorch version of fb_backward (Pallas _bwd_kernel): chunk
    rematerialisation from the checkpoints, max-normalised beta, gamma,
    dosage, and top-K by iterative masked argmax (lowest index on ties)."""
    B, S = dl.shape
    Gp, K_pad = words.shape
    NSC = Gp // CG
    dev = dl.device
    invK = 1.0 / K
    lane = torch.arange(K_pad, device=dev)
    sh = torch.arange(32, device=dev, dtype=torch.int32)
    dos = torch.empty((B, S), dtype=torch.float32, device=dev)
    tv = torch.zeros((Gp, B, K_top), dtype=torch.float32, device=dev)
    ti = torch.zeros((Gp, B, K_top), dtype=torch.int32, device=dev)
    thin_h = thin.tolist()
    beta = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    e_next0 = torch.ones((B, K_pad), dtype=torch.float32, device=dev)
    for s in range(NSC):
        ci = NSC - 1 - s
        alpha = ckpt[ci]
        alphas, es = [], []
        for j in range(CG):
            g = ci * CG + j
            e, _ = _emissions(dl, words, g, K)
            a_raw = (trans2[0, g] * alpha + trans2[1, g] * invK) * e
            alpha = a_raw / a_raw.sum(1, keepdim=True)
            alphas.append(alpha)
            es.append(e)
        for j in range(CG - 1, -1, -1):
            g = ci * CG + j
            if j == CG - 1:
                e_next = e_next0
                gn = min((ci + 1) * CG, NSC * CG - 1)
            else:
                e_next = es[j + 1]
                gn = g + 1
            etb = e_next * beta
            beta = trans2[0, gn] * etb + (trans2[1, gn] * invK) * etb.sum(1, keepdim=True)
            if j == CG - 1 and s == 0:
                beta = torch.ones_like(beta)
            beta = beta / torch.clamp(beta.amax(1, keepdim=True), min=1e-30)
            gamma = alphas[j] * beta
            gamma = gamma / gamma.sum(1, keepdim=True)
            hN = ((words[g][:, None] >> sh[None, :]) & 1).to(torch.float32)
            dos[:, g * 32:(g + 1) * 32] = eps + (1.0 - 2.0 * eps) * (gamma @ hN)
            if thin_h[g] >= 0:
                work = torch.where(lane[None, :] < K, gamma, -1.0)
                for t in range(K_top):
                    idx = work.argmax(1, keepdim=True)        # first maximum
                    tv[g, :, t] = work.gather(1, idx)[:, 0]
                    ti[g, :, t] = idx[:, 0].to(torch.int32)
                    work = work.scatter(1, idx, -2.0)
        e_next0 = es[0]
    return dos, tv, ti


def fb_core(gl, words, trans2, thin, K, K_top, ref_error, CG=GRID_CHUNK):
    """The fused FB of one row batch, as quilt_tpu's fb_pallas_core without
    the gamma capture: gl [B, 2, S] f32 (padded SNPs = 1). Returns
    (dosage [B, S], log_like [B], top_vals, top_idx [Gp, B, K_top])."""
    eps = float(ref_error)
    t0 = gl[:, 0] * (1.0 - eps) + gl[:, 1] * eps
    t1 = gl[:, 0] * eps + gl[:, 1] * (1.0 - eps)
    lt0 = torch.log(torch.clamp(t0, min=1e-30))
    lt1 = torch.log(torch.clamp(t1, min=1e-30))
    dl = (lt1 - lt0).contiguous()
    csum = lt0.sum(-1)
    ckpt, logs = fb_forward(dl, words, trans2, K, CG)
    dos, tv, ti = fb_backward(dl, words, ckpt, trans2, thin, K, K_top, eps, CG)
    return dos, logs + csum, tv, ti


def rows_per_call(B: int, fb: FBInputs, CG: int = GRID_CHUNK) -> int:
    """The H100 plan of fb_full_batched: rows are independent, and one call
    holds per row Gp/CG checkpoints plus 2*CG+3 scratch planes of K_pad
    floats; take as many rows as fit _CALL_BYTES."""
    per_row = (fb.nGrids // CG + 2 * CG + 3) * fb.K_pad * 4
    return max(1, min(B, _CALL_BYTES // per_row))


def fb_full_batched(gl, fb: FBInputs, K_top=16, ref_error=0.001,
                    capture_grid=-1):
    """Batched FB over the whole panel. gl [B, 2, S] tensor (padded to
    fb.S, or shorter and padded here with 1). Returns device tensors
    (dosage [B, S], log_like [B], top_vals [Gp, B, K_top], top_idx)."""
    if capture_grid >= 0:
        raise NotImplementedError(
            "FB gamma capture is part of the HLA slice, not this port"
        )
    dev = fb.device_tensors(gl.device)
    B = gl.shape[0]
    if gl.shape[2] != fb.S:
        pad = torch.ones((B, 2, fb.S), dtype=torch.float32, device=gl.device)
        pad[:, :, :gl.shape[2]] = gl
        gl = pad
    step = rows_per_call(B, fb)
    parts = [
        fb_core(gl[b0:b0 + step], dev["words"], dev["trans2"],
                dev["thin_flag"], fb.K, K_top, ref_error)
        for b0 in range(0, B, step)
    ]
    if len(parts) == 1:
        return parts[0]
    return (
        torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
        torch.cat([p[2] for p in parts], dim=1),
        torch.cat([p[3] for p in parts], dim=1),
    )
