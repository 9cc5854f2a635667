"""Read emissions and genotype likelihoods as torch ops (no Pallas kernel in
the JAX package corresponds to these).

Counterparts of quilt_tpu/engine/batch.py:_gather_words and of
quilt_tpu/kernels/emissions.py: ReadWindowCache / _gls_windowed_impl
(:242-354), expand_panel_bf16 / lem_full_from_cache / lem_subset
(:357-418), emat_read_from_bits (:118-213) and gls_from_labels_device
(:483-533). The JAX package splits float32 operands into bf16 hi/lo pairs
to stay exact on the TPU's matrix unit; here the products run in plain
float32 with TF32 off.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


def gather_words(rhb: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """Packed panel words of each row's haplotype subset: rhb [K, nGrids]
    i32, which [B, Ksub] -> [B, Ksub, nGrids]."""
    B, Kp = which.shape
    return rhb.index_select(0, which.reshape(-1).long()).reshape(B, Kp, rhb.shape[1])


def lem_window_meta(u_pad: np.ndarray, mask: np.ndarray, G: int, Rc: int = 256):
    """Per Rc-chunk of (grid-sorted) read slots, the first word of the SNP
    window covering every sample's reads in the chunk. Returns
    (s0 [n_rc] int32, Wwin words). u_pad / mask [B, R, J]."""
    B, R, J = u_pad.shape
    n_rc = (R + Rc - 1) // Rc
    Rpad = n_rc * Rc
    if Rpad != R:
        pad = [(0, 0), (0, Rpad - R), (0, 0)]
        u_pad = np.pad(u_pad, pad)
        mask = np.pad(mask, pad)
    w = (u_pad >> 5).reshape(B, n_rc, Rc, J)
    m = mask.reshape(B, n_rc, Rc, J)
    lo = np.where(m, w, np.iinfo(np.int32).max).min(axis=(0, 2, 3))
    hi = np.where(m, w, -1).max(axis=(0, 2, 3))
    lo = np.where(lo > hi, 0, lo)                   # empty chunk
    hi = np.maximum(hi, lo)
    Wwin = int((hi - lo + 1).max())
    Wwin = min(-(-Wwin // 4) * 4, max(G, 1))
    s0 = np.minimum(lo, max(G - Wwin, 0)).astype(np.int32)
    return s0, Wwin


class ReadWindowCache:
    """Per-batch windowed read-coefficient rows on the device.

    Reads are fixed across a batch's seek loop, so the per-base log terms
    are scattered once into each Rc-chunk's SNP window ([Bu, Rpad, Swin]
    planes; rows are per sample, chains share reads) and every GL call is
    one-hot(labels) @ window per chunk. The scatter accumulates duplicate
    indices: every pad base of a read lands on window column 0 (the JAX
    package declares these indices unique, see ROADMAP Q3-1)."""

    def __init__(self, u_pad, lpr, lpa, mask, G, device, Rc=128, lr=None, la=None):
        s0, Wwin = lem_window_meta(u_pad, mask, G, Rc)
        self.Rc = Rc
        self.Swin = Wwin * 32
        self.n_rc = len(s0)
        self.s0 = s0                                    # host: window slices
        Bu, R, J = u_pad.shape
        self.device = device
        Rpad = self.n_rc * Rc
        if Rpad != R:
            pad = [(0, 0), (0, Rpad - R), (0, 0)]
            u_pad, lpr, lpa, mask = (np.pad(x, pad) for x in (u_pad, lpr, lpa, mask))
            if lr is not None:
                lr, la = np.pad(lr, pad), np.pad(la, pad)
        self.Rpad = Rpad
        u_loc = np.clip(u_pad - (np.repeat(s0, Rc) * 32)[None, :, None], 0, self.Swin - 1)
        idx = tuple(
            torch.as_tensor(np.broadcast_to(x, u_loc.shape).ravel().astype(np.int64), device=device)
            for x in (np.arange(Bu)[:, None, None], np.arange(Rpad)[None, :, None], u_loc)
        )

        def scatter(vals):
            D = torch.zeros((Bu, Rpad, self.Swin), dtype=torch.float32, device=device)
            v = torch.as_tensor(vals.astype(np.float32).ravel(), device=device)
            return D.index_put_(idx, v, accumulate=True)

        self.pr = scatter(np.where(mask, lpr, 0.0))
        self.pa = scatter(np.where(mask, lpa, 0.0))
        self.diff = self.base = None
        if lr is not None:
            self.diff = scatter(np.where(mask, la - lr, 0.0))
            self.base = torch.as_tensor(
                np.where(mask, lr, 0.0).sum(axis=-1).astype(np.float32), device=device
            )                                           # [Bu, Rpad]

    def window_columns(self) -> torch.Tensor:
        """[n_rc * Swin] SNP index of every chunk's window column."""
        cols = self.s0.astype(np.int64)[:, None] * 32 + np.arange(self.Swin)[None, :]
        return torch.as_tensor(cols.ravel(), device=self.device)


def _gl_fix(logg: torch.Tensor, minGLValue: float) -> torch.Tensor:
    """exp, then the reference's per-SNP rescale where a GL is below
    minGLValue (reference-single.R:19-43). logg [..., 2, S]."""
    gl = torch.exp(logg)
    hi = gl.amax(-2, keepdim=True)
    fix = (gl < minGLValue).any(-2, keepdim=True)
    scaled = torch.clamp(gl / torch.clamp(hi, min=1e-30), min=minGLValue)
    return torch.where(fix, scaled, gl)


def gls_from_labels_windowed(cache: ReadWindowCache, H: torch.Tensor, n_latent: int,
                             C: int, S: int, minGLValue: float = 1e-10) -> torch.Tensor:
    """Haploid GLs [B*n_latent, 2, S] from read labels H [B, R] (rows =
    sample*C + chain): log gl[b, h, a, s] sums log p_a of the bases of the
    reads labelled h, as one-hot(H) @ window per read chunk."""
    _no_tf32()
    Sn, Rpad, Swin = cache.pr.shape
    n_rc, Rc = cache.n_rc, cache.Rc
    B = Sn * C
    Hp = torch.zeros((B, Rpad), dtype=torch.long, device=H.device)
    Hp[:, :H.shape[1]] = H[:, :Rpad]
    oh = torch.nn.functional.one_hot(Hp, n_latent).to(torch.float32)   # [B, Rpad, nl]
    lhs = (oh.reshape(Sn, C, n_rc, Rc, n_latent).permute(0, 2, 1, 4, 3)
           .reshape(Sn, n_rc, C * n_latent, Rc))
    parts = [lhs @ D.reshape(Sn, n_rc, Rc, Swin) for D in (cache.pr, cache.pa)]
    M = torch.stack(parts, dim=3)                      # [Sn, n_rc, C*nl, 2, Swin]
    M = M.permute(0, 2, 3, 1, 4).reshape(Sn, C * n_latent, 2, n_rc * Swin)
    logg = torch.zeros((Sn, C * n_latent, 2, S), dtype=torch.float32, device=H.device)
    logg.index_add_(3, cache.window_columns(), M)      # windows overlap: accumulate
    gl = _gl_fix(logg.reshape(B, n_latent, 2, S), minGLValue)
    return gl.reshape(B * n_latent, 2, S)


def expand_panel(rhb: torch.Tensor) -> torch.Tensor:
    """[K, G] packed words -> [K, G*32] {0,1} float32 panel (once per
    region; operand of the per-batch eMatRead products)."""
    sh = torch.arange(32, dtype=torch.int32, device=rhb.device)
    return ((rhb[:, :, None] >> sh) & 1).reshape(rhb.shape[0], -1).to(torch.float32)


def lem_full_from_cache(E_full: torch.Tensor, cache: ReadWindowCache) -> torch.Tensor:
    """Whole-panel log eMatRead [Bu*K, Rpad] f32 for the batch's reads:
    per read chunk, diff_chunk @ E_window^T, plus the per-read base.
    Rows are (sample, hap)-major so a subset is a flat row gather."""
    _no_tf32()
    K = E_full.shape[0]
    Bu, Rpad, Swin = cache.diff.shape
    Rc = cache.Rc
    logs = torch.empty((Bu, Rpad, K), dtype=torch.float32, device=E_full.device)
    for c in range(cache.n_rc):
        s = int(cache.s0[c]) * 32
        win = E_full[:, s:s + Swin]                                # [K, Swin]
        logs[:, c * Rc:(c + 1) * Rc] = cache.diff[:, c * Rc:(c + 1) * Rc] @ win.T
    logs += cache.base[:, :, None]                                 # in place: one [Bu, Rpad, K] buffer
    return logs.permute(0, 2, 1).reshape(Bu * K, Rpad)


def lem_subset(lem_full: torch.Tensor, flat_idx: torch.Tensor, max_diff: float, R_out: int):
    """Per-call subset of lem_full (rows = sample*K + hap): then the per-read
    rescale to max 0 and the -log(maxDifferenceBetweenReads) floor
    (reference rescale + clamp, copied-from-stitch.cpp:190-226). Returns
    (lem [B, Ksub, R_out] f32, skip [B, R_out] bool uninformative reads)."""
    B, Kp = flat_idx.shape
    sub = lem_full.index_select(0, flat_idx.reshape(-1).long()).reshape(B, Kp, -1)
    if sub.shape[2] > R_out:
        sub = sub[:, :, :R_out]
    elif sub.shape[2] < R_out:
        sub = torch.nn.functional.pad(sub, (0, R_out - sub.shape[2]))
    mx = sub.amax(1, keepdim=True)
    mn = sub.amin(1, keepdim=True)
    lem = torch.clamp(sub - mx, min=-math.log(max_diff))
    skip = (mx - mn)[:, 0] <= 1e-9
    return lem, skip


def emat_read_from_bits(words: torch.Tensor, u_pad: torch.Tensor, lr: torch.Tensor,
                        la: torch.Tensor, max_diff: float, R_out: int = 0,
                        read_chunk: int = 64) -> torch.Tensor:
    """eMatRead [B, K, R_out] f32 (probability domain) from packed subset
    words [B, K, nGrids] and per-row reads u_pad/lr/la [B, R, J]:
    log e[b,k,r] = sum_j lr[r,j] + bit(b,k,u[r,j]) * (la-lr)[r,j], each
    read rescaled to max 1 and floored at 1/max_diff; R_out > R pads with
    1.0. The engine uses it when the whole-panel cache is over its gate."""
    _no_tf32()
    B, K, _ = words.shape
    R, J = u_pad.shape[1], u_pad.shape[2]
    base = lr.sum(-1)                                              # [B, R]
    diff = la - lr
    u = u_pad.long()
    logs = torch.empty((B, K, R), dtype=torch.float32, device=words.device)
    for r0 in range(0, R, read_chunk):
        u_c = u[:, r0:r0 + read_chunk]                             # [B, Rc, J]
        Rc = u_c.shape[1]
        w = torch.gather(words, 2, (u_c >> 5).reshape(B, 1, Rc * J).expand(B, K, Rc * J))
        a = ((w >> (u_c & 31).reshape(B, 1, Rc * J).to(torch.int32)) & 1).to(torch.float32)
        logs[:, :, r0:r0 + Rc] = base[:, None, r0:r0 + Rc] + torch.einsum(
            "bkrj,brj->bkr", a.reshape(B, K, Rc, J), diff[:, r0:r0 + Rc]
        )
    logs = logs - logs.amax(1, keepdim=True)
    em = torch.clamp(torch.exp(logs), min=1.0 / max_diff)
    if R_out > R:
        em = torch.nn.functional.pad(em, (0, R_out - R), value=1.0)
    return em


def gls_from_labels_device(u_pad: torch.Tensor, lpr: torch.Tensor, lpa: torch.Tensor,
                           H: torch.Tensor, n_latent: int, S: int,
                           minGLValue: float = 1e-10) -> torch.Tensor:
    """Scatter form of the GL computation (per-row reads [B, R, J]; same result
    as gls_from_labels_windowed): [B*n_latent, 2, S]."""
    B, R, J = u_pad.shape
    logg = torch.zeros((B, n_latent, 2, S), dtype=torch.float32, device=u_pad.device)
    b = torch.arange(B, device=u_pad.device)[:, None, None].expand(B, R, J)
    h = H[:, :R].long()[:, :, None].expand(B, R, J)
    u = u_pad.long()
    for a, lp in ((0, lpr), (1, lpa)):
        logg.index_put_((b, h, torch.full_like(u, a), u), lp, accumulate=True)
    return _gl_fix(logg, minGLValue).reshape(B * n_latent, 2, S)
