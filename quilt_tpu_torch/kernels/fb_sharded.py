"""The segment-fused full-panel FB of one panel shard: CUDA kernels, their
plain versions, and the body that runs them over the shards of one data
row of the mesh with the exchanges between them.

The counterpart of quilt_tpu/kernels/fb_full.py:_fb_core_segmented (:440),
which the JAX package runs under shard_map with the panel's K split over
the mesh's panel axis (quilt_tpu/dist/mesh.py:ShardedFB). There the body is
XLA; here each of its four per-segment passes is a hand-written kernel
(csrc/fb_sharded.cu), launched once a segment on every shard.

A shard holds a block of K_shard columns of FBInputs.words ([Gp, K_shard],
global haplotypes k0 .. k0 + K_shard - 1, of which the first K_loc are real).
Emissions are exp(logit - mx) with the logit of fb.py (the GL log-ratios at
the word's set bits, in nibble order) and mx [Gp, B] the maximum logit of
each (grid, row) over the whole panel: fb_max_tiled on each shard, then the
maximum over the shards (the JAX body's one pmax a call). Within a segment
of L = SEG_LEN grids the Li & Stephens step is affine with a diagonal
propagator and a rank-1 jump inflow, so the coupling between shards over a
segment reduces to a few sums per row:

- forward, one exchange a segment: h_i = sum_k R(0,i) a0 and P(l,i) = sum_k
  R(l,i) (l <= i), with T_i = stay_i e_i and R(l,i) = T_l ... T_i, give the
  segment's masses M_1 .. M_L by a lower-triangular solve (M_0 = 1, c_l =
  jump_l / (K stay_l)): M_{i+1} = h_i + sum_l c_l M_l P(l,i); then alpha_i =
  (R(0,i) a0 + sum_l c_l M_l R(l,i)) / M_{i+1}, and log M_L is the
  segment's log-likelihood;
- backward, one exchange a segment: with the carry beta_R and the
  emission e_R right of the segment, T_j = stay_{j+1} e_{j+1} and Rb(j,l) =
  T_j ... T_l: q_j = sum_k e_j Rb(j,L-1) beta_R, NR = sum_k e_R beta_R and
  Qr(j,l) = sum_k e_j Rb(j,l-1) (Rb(j,j-1) = 1) give the masses N_L = NR,
  N_j = q_j + sum_{l>=j} cb_l N_{l+1} Qr(j,l) (cb_l = jump_{l+1} / K), and
  B_j = Rb(j,L-1) beta_R + sum_{l>=j} cb_l N_{l+1} Rb(j,l-1).

The JAX body spends one more exchange a backward segment on the gamma
normalisers gn_j = sum_k alpha_j B_j and the carry's normaliser sum_k B_0.
Here the carry is B_0 / N_0: N_0 = sum_k e_0 B_0 comes out of the segment's
own solve, and it is the mass that the next segment's sums take from the
carry (every one of them reads it through e_R), so the carry needs no
exchange of its own and enters the next segment with sum_k e_R beta_R = 1.
The gamma normalisers wait for one exchange at the end of the call with
the dosage sums: dosage, top-K values and the capture are each linear in
their grid's normaliser. So a call makes 2 Gp / L + 2 sums or maxima (the
pmax, a forward and a backward one a segment, the end's sum) and gathers
the shards' top-K lists and capture once, against the JAX body's
1 + 3 Gp / L + 1.

Each kernel block takes one row and a tile of TILE haplotypes (one a
thread) and reduces its sums in a fixed order, without atomics, into a
partial of its tile; the tiles' partials are summed with a torch reduction,
the shards' in the group's fixed order: two runs give the same bits. Every
alpha stays in a [Gp, B, K_shard] plane per shard (587 MB a shard at the
QUILT1 shape, 112 rows x 5,120 haplotypes, split in two).
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from .._build import Kernel, check_tensor as _check
from .fb import _NEG, _gl_log_ratios, _tile_logits, fb_max_tiled

SEG_LEN = 8                                          # grids a segment (the JAX body's)
TILE = 512                                           # haplotypes a kernel block
_TRI = [(l, i) for l in range(SEG_LEN) for i in range(l, SEG_LEN)]
FWD_VALS = SEG_LEN + len(_TRI)                       # h, then P(l, i): 44
BWD_VALS = SEG_LEN + 1 + len(_TRI)                   # q, NR, Qr(j, l): 45
_TINY = 1e-30

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD_LOCAL_KERNEL = Kernel("fb_sharded", "seg_fwd_local", [_P] * 6 + [_I] * 5)
FWD_APPLY_KERNEL = Kernel("fb_sharded", "seg_fwd_apply", [_P] * 7 + [_I] * 6)
BWD_LOCAL_KERNEL = Kernel("fb_sharded", "seg_bwd_local", [_P] * 6 + [_I] * 5)
BWD_APPLY_KERNEL = Kernel("fb_sharded", "seg_bwd_apply", [_P] * 13 + [_I] * 9)
KERNELS = (FWD_LOCAL_KERNEL, FWD_APPLY_KERNEL, BWD_LOCAL_KERNEL, BWD_APPLY_KERNEL)


def n_tiles(KS: int) -> int:
    return -(-KS // TILE)


def on_device(dev):
    """Makes `dev` the current CUDA device (the kernels launch on its
    current stream); nothing for a CPU device."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _check_seg(dl, words, trans2, mx, c):
    B = dl.shape[0]
    Gp, KS = words.shape
    dev = dl.device
    _check(dl, "dl", torch.float32, (B, Gp * 32), dev)
    _check(words, "words", torch.int32, (Gp, KS), dev)
    _check(trans2, "trans2", torch.float32, (2, Gp), dev)
    _check(mx, "mx", torch.float32, (Gp, B), dev)
    if Gp % SEG_LEN or not 0 <= c < Gp // SEG_LEN:
        raise ValueError(f"bad Gp={Gp} / segment {c} (segments of {SEG_LEN} grids)")
    return B, Gp, KS, dev


# ---------------------------------------------------------------------------
# the four passes: wrappers
# ---------------------------------------------------------------------------

def seg_fwd_local(dl, words, trans2, mx, alphas, c, K_loc):
    """Forward local sums of segment c: part [B, n_tiles, FWD_VALS], per
    row and tile h_0..h_7 then P(l, i) for l <= i (l major). alphas [Gp,
    B, K_shard] holds the alphas of the grids before the segment (the last
    of them is a0; zero at c = 0). dl [B, Gp*32] GL log-ratios, words [Gp,
    K_shard] i32, trans2 [2, Gp], mx [Gp, B] the global emission maxima;
    K_loc real haplotypes in the shard."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(alphas, "alphas", torch.float32, (Gp, B, KS), dev)
    if dev.type == "cpu":
        return seg_fwd_local_plain(dl, words, trans2, mx, alphas, c, K_loc)
    part = torch.empty((B, n_tiles(KS), FWD_VALS), dtype=torch.float32, device=dev)
    with on_device(dev):
        FWD_LOCAL_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                                alphas.data_ptr(), part.data_ptr(), Gp, KS, B, K_loc, c)
    return part


def seg_fwd_apply(dl, words, trans2, mx, tot, alphas, logm, c, K_loc, K):
    """Forward apply of segment c from the summed sums tot [B, FWD_VALS]:
    the mass solve, the alphas of the segment's grids written into alphas
    (in place) and, given logm [Gp/L, B], log M_L into logm[c]. K is the
    panel's haplotype count."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(tot, "tot", torch.float32, (B, FWD_VALS), dev)
    _check(alphas, "alphas", torch.float32, (Gp, B, KS), dev)
    if logm is not None:
        _check(logm, "logm", torch.float32, (Gp // SEG_LEN, B), dev)
    if dev.type == "cpu":
        return seg_fwd_apply_plain(dl, words, trans2, mx, tot, alphas, logm, c, K_loc, K)
    with on_device(dev):
        FWD_APPLY_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                                tot.data_ptr(), alphas.data_ptr(),
                                None if logm is None else logm.data_ptr(), Gp, KS, B, K_loc, K, c)


def seg_bwd_local(dl, words, trans2, mx, beta, c, K_loc):
    """Backward local sums of segment c: part [B, n_tiles, BWD_VALS], per
    row and tile q_0..q_7, NR and Qr(j, l) for j <= l (j major). beta [B,
    K_shard]: the carry, B_0 / N_0 of segment c + 1 (ones at the last
    segment)."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(beta, "beta", torch.float32, (B, KS), dev)
    if dev.type == "cpu":
        return seg_bwd_local_plain(dl, words, trans2, mx, beta, c, K_loc)
    part = torch.empty((B, n_tiles(KS), BWD_VALS), dtype=torch.float32, device=dev)
    with on_device(dev):
        BWD_LOCAL_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                                beta.data_ptr(), part.data_ptr(), Gp, KS, B, K_loc, c)
    return part


def seg_bwd_apply(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0, cap_grid):
    """Backward apply of segment c from the summed sums tot [B, BWD_VALS]:
    the mass solve, B_j, and for each grid g of the segment the gamma numerators alpha_g B_g,
    whose per-tile sums go to out["gnp"] [nt, Gp, B] and bit-masked sums to
    out["dpart"] [nt, B, Gp*32]; at thinned grids (thin[g] >= 0) each tile's
    K_top largest numerators and their global haplotype indices (k0 + column;
    lowest index first on ties; value 0 and index 0 past the tile's real
    haplotypes) to out["tvp"] / out["tip"] [nt, Gp, B, K_top] (zero
    elsewhere); at the capture grid the numerators to out["gcap"] [B,
    K_shard]. The carry beta is overwritten with this segment's B_0 / N_0."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    nt, K_top = n_tiles(KS), out["tvp"].shape[3]
    _check(alphas, "alphas", torch.float32, (Gp, B, KS), dev)
    _check(tot, "tot", torch.float32, (B, BWD_VALS), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    _check(beta, "beta", torch.float32, (B, KS), dev)
    _check(out["dpart"], "dpart", torch.float32, (nt, B, Gp * 32), dev)
    _check(out["gnp"], "gnp", torch.float32, (nt, Gp, B), dev)
    _check(out["tvp"], "tvp", torch.float32, (nt, Gp, B, K_top), dev)
    _check(out["tip"], "tip", torch.int32, (nt, Gp, B, K_top), dev)
    if cap_grid >= 0:
        _check(out["gcap"], "gcap", torch.float32, (B, KS), dev)
    if not 0 < K_top <= min(TILE, 32):
        raise ValueError(f"K_top must be 1..32, got {K_top}")
    if dev.type == "cpu":
        return seg_bwd_apply_plain(dl, words, trans2, mx, alphas, tot, thin, beta, out, c,
                                   K_loc, K, k0, cap_grid)
    gcap = out["gcap"].data_ptr() if cap_grid >= 0 else None
    with on_device(dev):
        BWD_APPLY_KERNEL.launch(
            words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(), alphas.data_ptr(),
            tot.data_ptr(), thin.data_ptr(), beta.data_ptr(), out["dpart"].data_ptr(),
            out["gnp"].data_ptr(), out["tvp"].data_ptr(), out["tip"].data_ptr(), gcap,
            Gp, KS, B, K_loc, K, k0, K_top, cap_grid, c)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the checks on the card)
# ---------------------------------------------------------------------------

def _tile_sums(v, nt):
    """[B, K_shard] -> [B, nt] sums over each tile of TILE columns."""
    pad = nt * TILE - v.shape[1]
    return (F.pad(v, (0, pad)) if pad else v).view(v.shape[0], nt, TILE).sum(2)


def _seg_e(dl, words, mx, g, K_loc):
    """Emissions [B, K_shard] of grid g scaled by the global maxima (0 past
    the shard's K_loc real haplotypes)."""
    return torch.exp(_tile_logits(dl, words, g, K_loc, 0, words.shape[1]) - mx[g][:, None])


def _fwd_products(dl, words, trans2, mx, alphas, c, K_loc):
    """(a0, {(l, i): R(l, i)}) of segment c."""
    g0 = c * SEG_LEN
    a0 = alphas[g0 - 1] if c else torch.zeros_like(alphas[0])
    T = [trans2[0, g0 + i] * _seg_e(dl, words, mx, g0 + i, K_loc) for i in range(SEG_LEN)]
    R = {}
    for l in range(SEG_LEN):
        U = T[l]
        R[(l, l)] = U
        for i in range(l + 1, SEG_LEN):
            U = U * T[i]
            R[(l, i)] = U
    return a0, R


def seg_fwd_local_plain(dl, words, trans2, mx, alphas, c, K_loc):
    """Plain version of seg_fwd_local (the local reductions of the JAX
    body's fwd_seg)."""
    a0, R = _fwd_products(dl, words, trans2, mx, alphas, c, K_loc)
    vals = [R[(0, i)] * a0 for i in range(SEG_LEN)] + [R[p] for p in _TRI]
    nt = n_tiles(words.shape[1])
    return torch.stack([_tile_sums(v, nt) for v in vals], 2)


def seg_fwd_apply_plain(dl, words, trans2, mx, tot, alphas, logm, c, K_loc, K):
    """Plain version of seg_fwd_apply (the mass solve and reconstruction of
    the JAX body's fwd_seg)."""
    L = SEG_LEN
    g0 = c * L
    a0, R = _fwd_products(dl, words, trans2, mx, alphas, c, K_loc)
    cl = trans2[1, g0:g0 + L] / (K * torch.clamp(trans2[0, g0:g0 + L], min=_TINY))
    P = {p: tot[:, L + j] for j, p in enumerate(_TRI)}
    M = [torch.ones_like(tot[:, 0])]
    for i in range(L):
        acc = tot[:, i]
        for l in range(i + 1):
            acc = acc + cl[l] * M[l] * P[(l, i)]
        M.append(acc)
    cm = [cl[l] * M[l] for l in range(L)]
    for i in range(L):
        A = R[(0, i)] * a0
        for l in range(i + 1):
            A = A + cm[l][:, None] * R[(l, i)]
        alphas[g0 + i] = A / torch.clamp(M[i + 1], min=_TINY)[:, None]
    if logm is not None:
        logm[c] = torch.log(torch.clamp(M[L], min=_TINY))


def _bwd_terms(dl, words, trans2, mx, c, K_loc):
    """(e [L x [B, K_shard]], e_R, T, jump of the next grid [L]) of segment c:
    e_R and the next grid's (stay, jump) are the grid right of the segment's,
    or ones and (1, 0) at the last segment (the JAX body's carry0)."""
    L = SEG_LEN
    g0 = c * L
    e = [_seg_e(dl, words, mx, g0 + j, K_loc) for j in range(L)]
    if c == words.shape[0] // L - 1:
        eR, t0R, t1R = torch.ones_like(e[0]), 1.0, 0.0
    else:
        eR, t0R, t1R = _seg_e(dl, words, mx, g0 + L, K_loc), trans2[0, g0 + L], trans2[1, g0 + L]
    nxt_e = e[1:] + [eR]
    t0 = [trans2[0, g0 + j + 1] for j in range(L - 1)] + [t0R]
    t1 = [trans2[1, g0 + j + 1] for j in range(L - 1)] + [t1R]
    return e, eR, [t0[j] * nxt_e[j] for j in range(L)], t1


def seg_bwd_local_plain(dl, words, trans2, mx, beta, c, K_loc):
    """Plain version of seg_bwd_local (the local reductions of the JAX
    body's bwd_seg)."""
    L = SEG_LEN
    e, eR, T, _ = _bwd_terms(dl, words, trans2, mx, c, K_loc)
    q, Qr = [], {}
    for j in range(L):
        U = T[j]
        Qr[(j, j)] = e[j]
        for l in range(j + 1, L):
            Qr[(j, l)] = e[j] * U
            U = U * T[l]
        q.append(e[j] * U * beta)
    vals = q + [eR * beta] + [Qr[p] for p in _TRI]
    nt = n_tiles(words.shape[1])
    return torch.stack([_tile_sums(v, nt) for v in vals], 2)


def seg_bwd_apply_plain(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0,
                        cap_grid):
    """Plain version of seg_bwd_apply (the mass solve and reconstruction of
    the JAX body's bwd_seg, with its gamma numerators' per-tile dosage and
    normaliser sums, top-K lists and capture, and the carry B_0 / N_0)."""
    L = SEG_LEN
    g0 = c * L
    Gp, KS = words.shape
    nt, K_top = n_tiles(KS), out["tvp"].shape[3]
    e, eR, T, t1 = _bwd_terms(dl, words, trans2, mx, c, K_loc)
    Qr = {p: tot[:, L + 1 + j] for j, p in enumerate(_TRI)}
    cb = [t / K for t in t1]
    N = [None] * (L + 1)
    N[L] = tot[:, L]
    for j in range(L - 1, -1, -1):
        acc = tot[:, j]
        for l in range(j, L):
            acc = acc + cb[l] * N[l + 1] * Qr[(j, l)]
        N[j] = acc
    cbN = [cb[l] * N[l + 1] for l in range(L)]
    sh = torch.arange(32, device=dl.device, dtype=torch.int32)
    lane = torch.arange(nt * TILE, device=dl.device)
    B0 = None
    for j in range(L):
        g = g0 + j
        u = [T[j]]                                       # u[m - j] = Rb(j, m)
        for m in range(j + 1, L):
            u.append(u[-1] * T[m])
        Bj = u[L - 1 - j] * beta + cbN[j][:, None]
        for l in range(j + 1, L):
            Bj = Bj + cbN[l][:, None] * u[l - 1 - j]
        if j == 0:
            B0 = Bj
        gam = alphas[g] * Bj                                                # [B, KS]
        out["gnp"][:, g] = _tile_sums(gam, nt).T
        pad = nt * TILE - KS
        gt = (F.pad(gam, (0, pad)) if pad else gam).view(-1, nt, TILE)
        bits = ((words[g][:, None] >> sh[None, :]) & 1).to(torch.float32)  # [KS, 32]
        bt = (F.pad(bits, (0, 0, 0, pad)) if pad else bits).view(nt, TILE, 32)
        out["dpart"][:, :, g * 32:(g + 1) * 32] = torch.einsum("btk,tks->tbs", gt, bt)
        out["tvp"][:, g] = 0.0
        out["tip"][:, g] = 0
        if int(thin[g]) >= 0:
            work = torch.where(lane[None, :] < K_loc, F.pad(gam, (0, pad)) if pad else gam, -1.0)
            work = work.view(-1, nt, TILE)
            for r in range(K_top):
                idx = work.argmax(2, keepdim=True)                           # first maximum
                v = work.gather(2, idx)[:, :, 0]                            # [B, nt]
                gidx = k0 + idx[:, :, 0] + TILE * torch.arange(nt, device=dl.device)[None, :]
                out["tvp"][:, g, :, r] = torch.clamp(v, min=0.0).T
                out["tip"][:, g, :, r] = torch.where(v >= 0, gidx, 0).T.to(torch.int32)
                work = work.scatter(2, idx, -2.0)
        if g == cap_grid:
            out["gcap"].copy_(gam)
    beta.copy_(B0 / torch.clamp(N[0], min=_TINY)[:, None])


# ---------------------------------------------------------------------------
# the body over the shards of one data row
# ---------------------------------------------------------------------------

@dataclass
class PanelShard:
    """One panel shard's per-region state on its device."""

    words: torch.Tensor       # [Gp, K_shard] i32 columns k0 .. k0 + K_shard - 1
    trans2: torch.Tensor      # [2, Gp] f32
    thin: torch.Tensor        # [Gp] i32
    K_loc: int                # real haplotypes of the shard (0 .. K_shard)
    k0: int                   # global index of its first column

    @property
    def device(self) -> torch.device:
        return self.words.device


def sharded_core(gl, shards: List[PanelShard], group, K: int, K_top: int, ref_error: float,
                 cap_grid: int = -1):
    """The segment-fused FB of one row batch over the panel shards of one
    data row: gl [B, 2, Gp*32] f32 on group.devices[0]; group exchanges the
    shards' partial tensors (dist.mesh.PanelGroup: sum / max / broadcast /
    gather). Returns, on gl's device, (dosage [B, Gp*32], log_like [B], tv /
    ti [Gp, B, K_top x n_shards] the shards' lists merged by value, zero
    values at index 0) and, with a capture grid, gcap [B, n_shards x
    K_shard], the normalised gamma at that grid."""
    eps = float(ref_error)
    L = SEG_LEN
    Gp, KS = shards[0].words.shape
    B = gl.shape[0]
    NSC, nt = Gp // L, n_tiles(KS)
    dl, csum = _gl_log_ratios(gl, eps)
    dls = group.broadcast(dl)
    mxs = []
    for sh, d in zip(shards, dls):
        with on_device(sh.device):
            mxs.append(fb_max_tiled(d, sh.words, sh.K_loc, KS) if sh.K_loc else
                       torch.full((Gp, B), _NEG, dtype=torch.float32, device=sh.device))
    mx = group.max(mxs)

    alphas = [torch.empty((Gp, B, KS), dtype=torch.float32, device=sh.device) for sh in shards]
    logm = torch.empty((NSC, B), dtype=torch.float32, device=gl.device)
    for c in range(NSC):
        tots = group.sum([seg_fwd_local(d, sh.words, sh.trans2, m, a, c, sh.K_loc).sum(1)
                          for sh, d, m, a in zip(shards, dls, mx, alphas)])
        for p, (sh, d, m, a, t) in enumerate(zip(shards, dls, mx, alphas, tots)):
            seg_fwd_apply(d, sh.words, sh.trans2, m, t, a, logm if p == 0 else None, c,
                          sh.K_loc, K)
    log_like = logm.sum(0) + mx[0].sum(0) + csum

    outs = []
    for sh in shards:
        z = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=sh.device)
        outs.append(dict(dpart=z(nt, B, Gp * 32), gnp=z(nt, Gp, B), tvp=z(nt, Gp, B, K_top),
                         tip=z(nt, Gp, B, K_top, dt=torch.int32),
                         gcap=torch.zeros((B, KS), dtype=torch.float32, device=sh.device)
                         if cap_grid >= 0 else None))
    betas = [torch.ones((B, KS), dtype=torch.float32, device=sh.device) for sh in shards]
    for c in range(NSC - 1, -1, -1):
        tots = group.sum([seg_bwd_local(d, sh.words, sh.trans2, m, b, c, sh.K_loc).sum(1)
                          for sh, d, m, b in zip(shards, dls, mx, betas)])
        for sh, d, m, a, t, b, o in zip(shards, dls, mx, alphas, tots, betas, outs):
            seg_bwd_apply(d, sh.words, sh.trans2, m, a, t, sh.thin, b, o, c, sh.K_loc, K,
                          sh.k0, cap_grid)

    # the end of the call: the dosage sums and gamma normalisers in one sum,
    # each shard's lists merged over its tiles, then gathered
    sums = group.sum([torch.cat([o["dpart"].sum(0).reshape(-1), o["gnp"].sum(0).reshape(-1)])
                      for o in outs])[0]
    gn = torch.clamp(sums[B * Gp * 32:].view(Gp, B), min=_TINY)
    dosage = eps + (1.0 - 2.0 * eps) * (sums[:B * Gp * 32].view(B, Gp * 32)
                                        / gn.T.repeat_interleave(32, dim=1))
    tvs, tis = [], []
    for o in outs:
        v = o["tvp"].permute(1, 2, 0, 3).reshape(Gp, B, nt * K_top)
        i = o["tip"].permute(1, 2, 0, 3).reshape(Gp, B, nt * K_top)
        v, order = torch.sort(v, dim=2, descending=True, stable=True)
        tvs.append(v[:, :, :K_top].contiguous())
        tis.append(i.gather(2, order[:, :, :K_top]))
    tv = torch.cat(group.gather(tvs), 2) / gn[:, :, None]
    ti = torch.cat(group.gather(tis), 2)
    tv, order = torch.sort(tv, dim=2, descending=True, stable=True)
    ti = torch.where(tv > 0, ti.gather(2, order), 0)
    if cap_grid < 0:
        return dosage, log_like, tv, ti
    gcap = torch.cat(group.gather([o["gcap"] for o in outs]), 1) / gn[cap_grid][:, None]
    return dosage, log_like, tv, ti, gcap
