"""The segment-fused full-panel FB of one panel shard: CUDA kernels, their
plain versions, and the body that runs them over the shards of one data
row of the mesh with the exchanges between them.

The counterpart of quilt_tpu/kernels/fb_full.py:_fb_core_segmented (:440),
which the JAX package runs under shard_map with the panel's K split over
the mesh's panel axis (quilt_tpu/dist/mesh.py:ShardedFB). There the body is
XLA; here it is hand-written kernels (csrc/fb_sharded.cu): a forward step a
segment (segment c's mass solve and alphas, then segment c + 1's local
sums) and a backward step a segment (segment c's solve, its alphas rebuilt
from a checkpoint, the gamma sums, then segment c - 1's local sums), with
the first segment's forward local pass and the last one's backward local
pass launched once a call.

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
their grid's normaliser. (So a per-(row, grid) factor on the numerators
moves nothing; the steps scale grid j's by M_{j+1} / M_L, which keeps their
sum at sum_k alpha_{L-1} B_{L-1} >= jump / K: unscaled, it is a product of
up to 7 grids' masses and left float32's range at K = 98,304.) So a call makes 2 Gp / L + 2 sums or maxima (the
pmax, a forward and a backward one a segment, the end's sum) and gathers
the shards' top-K lists and capture once, against the JAX body's
1 + 3 Gp / L + 1.

Each kernel block takes one row and a tile of TILE haplotypes (one a
thread) and reduces its sums in a fixed order, without atomics, into a
partial of its tile; the tiles' partials are summed with a torch reduction,
the shards' in the group's fixed order: two runs give the same bits. A
segment's alphas are affine in its entering alpha a0 with per-row scalars
c_l M_l and M_{i+1}, so a shard keeps only the last alpha of each segment
(a [Gp/L, B, K_shard] checkpoint plane) and those 2L scalars a (segment,
row); the backward step rebuilds the segment's alphas from them with the
forward's own arithmetic (seg_alphas in the kernels, _seg_alphas here), so
the rebuilt alphas are the forward's bit for bit. The previous form
(sharded_core(_prev=True), timings and tests only) ran a local and an apply
pass a segment in each direction (seg_fwd_apply / seg_bwd_apply) and kept
every alpha in a [Gp, B, K_shard] plane.
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
# the floor of the masses and normalisers: float32's least normal value (a
# segment's masses are products of up to 8 grids' and fall below 1e-30, the
# JAX body's floor, with every SNP informative at K = 16,384)
_TINY = float(torch.finfo(torch.float32).tiny)

SCAL_VALS = 2 * SEG_LEN                              # c_l M_l, then M_{i+1}: 16

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD_LOCAL_KERNEL = Kernel("fb_sharded", "seg_fwd_local", [_P] * 6 + [_I] * 5)
FWD_STEP_KERNEL = Kernel("fb_sharded", "seg_fwd_step", [_P] * 10 + [_I] * 6)
BWD_LOCAL_KERNEL = Kernel("fb_sharded", "seg_bwd_local", [_P] * 6 + [_I] * 5)
BWD_STEP_KERNEL = Kernel("fb_sharded", "seg_bwd_step", [_P] * 16 + [_I] * 9)
KERNELS = (FWD_LOCAL_KERNEL, FWD_STEP_KERNEL, BWD_LOCAL_KERNEL, BWD_STEP_KERNEL)
# the previous form's apply passes (sharded_core(_prev=True): timings and
# tests only; no path launches them)
_PREV_FWD_APPLY = Kernel("fb_sharded", "seg_fwd_apply", [_P] * 8 + [_I] * 6)
_PREV_BWD_APPLY = Kernel("fb_sharded", "seg_bwd_apply", [_P] * 13 + [_I] * 9)
_PREV_KERNELS = (_PREV_FWD_APPLY, _PREV_BWD_APPLY)
# the seg step split's pieces (chip_smoke.py; measurement only)
SPLIT_KERNEL = Kernel("fb_sharded", "seg_split", [_P] * 2 + [_I] * 7)
SPLIT_PIECES = ("bwd apply grid reductions", "block_argmax round", "bwd mass solve",
                "fwd mass solve", "block_sums of 45", "bwd step segment reductions",
                "bwd step top-K of a grid")


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


def _check_state(ckpt, scal, B, Gp, KS, dev):
    _check(ckpt, "ckpt", torch.float32, (Gp // SEG_LEN, B, KS), dev)
    _check(scal, "scal", torch.float32, (Gp // SEG_LEN, B, SCAL_VALS), dev)


def _check_out(out, B, Gp, KS, cap_grid, dev):
    """The backward's per-tile outputs; returns K_top."""
    nt, K_top = n_tiles(KS), out["tvp"].shape[3]
    _check(out["dpart"], "dpart", torch.float32, (nt, B, Gp * 32), dev)
    _check(out["gnp"], "gnp", torch.float32, (nt, Gp, B), dev)
    _check(out["tvp"], "tvp", torch.float32, (nt, Gp, B, K_top), dev)
    _check(out["tip"], "tip", torch.int32, (nt, Gp, B, K_top), dev)
    if cap_grid >= 0:
        _check(out["gcap"], "gcap", torch.float32, (B, KS), dev)
    if not 0 < K_top <= min(TILE, 32):
        raise ValueError(f"K_top must be 1..32, got {K_top}")
    return K_top


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# wrappers: the path's kernels
# ---------------------------------------------------------------------------

def seg_fwd_local(dl, words, trans2, mx, a0, c, K_loc):
    """Forward local sums of segment c: part [B, n_tiles, FWD_VALS], per
    row and tile h_0..h_7 then P(l, i) for l <= i (l major). a0 [B,
    K_shard] is the alpha entering the segment, the last of the grids
    before it (None: zero, as at c = 0). dl [B, Gp*32] GL log-ratios, words
    [Gp, K_shard] i32, trans2 [2, Gp], mx [Gp, B] the global emission
    maxima; K_loc real haplotypes in the shard. The path launches it at
    segment 0 only; the previous form at every segment."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    if a0 is not None:
        _check(a0, "a0", torch.float32, (B, KS), dev)
    if dev.type == "cpu":
        return seg_fwd_local_plain(dl, words, trans2, mx, a0, c, K_loc)
    part = torch.empty((B, n_tiles(KS), FWD_VALS), dtype=torch.float32, device=dev)
    with on_device(dev):
        FWD_LOCAL_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                                _ptr(a0), part.data_ptr(), Gp, KS, B, K_loc, c)
    return part


def seg_fwd_step(dl, words, trans2, mx, tot, ckpt, scal, logm, c, K_loc, K, _alphas=None):
    """Forward step of segment c from the summed sums tot [B, FWD_VALS]:
    the mass solve and the segment's alphas from checkpoint c - 1 of ckpt
    [Gp/L, B, K_shard] (zero at c = 0); writes the last of them into
    ckpt[c], the solve's c_l M_l and M_{i+1} into scal[c] ([Gp/L, B, 2L])
    and, given logm [Gp/L, B], log M_L into logm[c]. Returns segment c +
    1's local sums [B, n_tiles, FWD_VALS] (seg_fwd_local's), None at the
    last segment. K is the panel's haplotype count. _alphas, a [L, B,
    K_shard] tensor, takes all the segment's alphas (tests and checks)."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(tot, "tot", torch.float32, (B, FWD_VALS), dev)
    _check_state(ckpt, scal, B, Gp, KS, dev)
    if logm is not None:
        _check(logm, "logm", torch.float32, (Gp // SEG_LEN, B), dev)
    if _alphas is not None:
        _check(_alphas, "_alphas", torch.float32, (SEG_LEN, B, KS), dev)
    if dev.type == "cpu":
        return seg_fwd_step_plain(dl, words, trans2, mx, tot, ckpt, scal, logm, c, K_loc, K,
                                  _alphas)
    nxt = c + 1 < Gp // SEG_LEN
    part = torch.empty((B, n_tiles(KS), FWD_VALS), dtype=torch.float32, device=dev) if nxt else None
    with on_device(dev):
        FWD_STEP_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                               tot.data_ptr(), ckpt.data_ptr(), scal.data_ptr(), _ptr(logm),
                               _ptr(part), _ptr(_alphas), Gp, KS, B, K_loc, K, c)
    return part


def seg_bwd_local(dl, words, trans2, mx, beta, c, K_loc):
    """Backward local sums of segment c: part [B, n_tiles, BWD_VALS], per
    row and tile q_0..q_7, NR and Qr(j, l) for j <= l (j major). beta [B,
    K_shard]: the carry, B_0 / N_0 of segment c + 1 (ones at the last
    segment). The path launches it at the last segment only; the previous
    form at every segment."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(beta, "beta", torch.float32, (B, KS), dev)
    if dev.type == "cpu":
        return seg_bwd_local_plain(dl, words, trans2, mx, beta, c, K_loc)
    part = torch.empty((B, n_tiles(KS), BWD_VALS), dtype=torch.float32, device=dev)
    with on_device(dev):
        BWD_LOCAL_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                                beta.data_ptr(), part.data_ptr(), Gp, KS, B, K_loc, c)
    return part


def seg_bwd_step(dl, words, trans2, mx, ckpt, scal, tot, thin, beta, out, c, K_loc, K, k0,
                 cap_grid, _alphas=None):
    """Backward step of segment c from the summed sums tot [B, BWD_VALS]:
    the mass solve, B_j, the segment's alphas rebuilt from checkpoint c - 1
    and scal[c] (as seg_fwd_step left them: the forward's alphas bit for
    bit), and for each grid g of the segment the gamma numerators alpha_g
    B_g, whose per-tile sums go to out["gnp"] [nt, Gp, B] and bit-masked
    sums to out["dpart"] [nt, B, Gp*32]; at thinned grids (thin[g] >= 0)
    each tile's K_top largest numerators and their global haplotype indices
    (k0 + column; lowest index first on ties; value 0 and index 0 past the
    tile's real haplotypes) to out["tvp"] / out["tip"] [nt, Gp, B, K_top]
    (zero elsewhere); at the capture grid the numerators to out["gcap"] [B,
    K_shard]. The carry beta is overwritten with this segment's B_0 / N_0.
    Returns segment c - 1's local sums [B, n_tiles, BWD_VALS] from that
    carry (seg_bwd_local's), None at c = 0. _alphas, a [L, B, K_shard]
    tensor, takes the rebuilt alphas (tests and checks)."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check_state(ckpt, scal, B, Gp, KS, dev)
    _check(tot, "tot", torch.float32, (B, BWD_VALS), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    _check(beta, "beta", torch.float32, (B, KS), dev)
    K_top = _check_out(out, B, Gp, KS, cap_grid, dev)
    if _alphas is not None:
        _check(_alphas, "_alphas", torch.float32, (SEG_LEN, B, KS), dev)
    if dev.type == "cpu":
        return seg_bwd_step_plain(dl, words, trans2, mx, ckpt, scal, tot, thin, beta, out, c,
                                  K_loc, K, k0, cap_grid, _alphas)
    part = torch.empty((B, n_tiles(KS), BWD_VALS), dtype=torch.float32, device=dev) if c else None
    gcap = out["gcap"] if cap_grid >= 0 else None
    with on_device(dev):
        BWD_STEP_KERNEL.launch(
            words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(), ckpt.data_ptr(),
            scal.data_ptr(), tot.data_ptr(), thin.data_ptr(), beta.data_ptr(), _ptr(part),
            out["dpart"].data_ptr(), out["gnp"].data_ptr(), out["tvp"].data_ptr(),
            out["tip"].data_ptr(), _ptr(gcap), _ptr(_alphas), Gp, KS, B, K_loc, K, k0, K_top,
            cap_grid, c)
    return part


# ---------------------------------------------------------------------------
# wrappers: the previous form's apply passes (timings and tests only)
# ---------------------------------------------------------------------------

def seg_fwd_apply(dl, words, trans2, mx, tot, a0, alphas, logm, c, K_loc, K):
    """The previous form's forward apply of segment c from the summed sums
    tot [B, FWD_VALS] and the entering alpha a0 [B, K_shard] (None: zero):
    the mass solve, the segment's alphas written into alphas [L, B,
    K_shard] and, given logm [Gp/L, B], log M_L into logm[c]."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(tot, "tot", torch.float32, (B, FWD_VALS), dev)
    if a0 is not None:
        _check(a0, "a0", torch.float32, (B, KS), dev)
    _check(alphas, "alphas", torch.float32, (SEG_LEN, B, KS), dev)
    if logm is not None:
        _check(logm, "logm", torch.float32, (Gp // SEG_LEN, B), dev)
    if dev.type == "cpu":
        return seg_fwd_apply_plain(dl, words, trans2, mx, tot, a0, alphas, logm, c, K_loc, K)
    with on_device(dev):
        _PREV_FWD_APPLY.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(),
                               tot.data_ptr(), _ptr(a0), alphas.data_ptr(), _ptr(logm), Gp, KS, B,
                               K_loc, K, c)


def seg_bwd_apply(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0, cap_grid):
    """The previous form's backward apply of segment c: seg_bwd_step's
    outputs from the segment's stored alphas [L, B, K_shard], without the
    next local sums (a grid at a time behind block reductions)."""
    B, Gp, KS, dev = _check_seg(dl, words, trans2, mx, c)
    _check(alphas, "alphas", torch.float32, (SEG_LEN, B, KS), dev)
    _check(tot, "tot", torch.float32, (B, BWD_VALS), dev)
    _check(thin, "thin", torch.int32, (Gp,), dev)
    _check(beta, "beta", torch.float32, (B, KS), dev)
    K_top = _check_out(out, B, Gp, KS, cap_grid, dev)
    if dev.type == "cpu":
        return seg_bwd_apply_plain(dl, words, trans2, mx, alphas, tot, thin, beta, out, c,
                                   K_loc, K, k0, cap_grid)
    gcap = out["gcap"] if cap_grid >= 0 else None
    with on_device(dev):
        _PREV_BWD_APPLY.launch(
            words.data_ptr(), dl.data_ptr(), trans2.data_ptr(), mx.data_ptr(), alphas.data_ptr(),
            tot.data_ptr(), thin.data_ptr(), beta.data_ptr(), out["dpart"].data_ptr(),
            out["gnp"].data_ptr(), out["tvp"].data_ptr(), out["tip"].data_ptr(), _ptr(gcap),
            Gp, KS, B, K_loc, K, k0, K_top, cap_grid, c)


def seg_split(which: int, steps: int, B: int, KS: int, K_top: int, trans2, K: int):
    """Launches piece `which` of SPLIT_PIECES `steps` times in each block of
    a segment kernel's launch at B rows x K_shard KS (the seg step split:
    chip_smoke.py times it). Needs a CUDA device; returns the [B * nt]
    output the launch writes."""
    dev = trans2.device
    if dev.type != "cuda":
        raise ValueError("seg_split times the card and needs a CUDA device")
    out = torch.empty(B * n_tiles(KS), dtype=torch.float32, device=dev)
    with on_device(dev):
        SPLIT_KERNEL.launch(out.data_ptr(), trans2.data_ptr(), which, n_tiles(KS), B, steps,
                            K_top, trans2.shape[1], K)
    return out


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


def _fwd_R(dl, words, trans2, mx, c, K_loc):
    """{(l, i): R(l, i)} of segment c."""
    g0 = c * SEG_LEN
    T = [trans2[0, g0 + i] * _seg_e(dl, words, mx, g0 + i, K_loc) for i in range(SEG_LEN)]
    R = {}
    for l in range(SEG_LEN):
        U = T[l]
        R[(l, l)] = U
        for i in range(l + 1, SEG_LEN):
            U = U * T[i]
            R[(l, i)] = U
    return R


def _seg_alphas(R, a0, cm, M):
    """The segment's alphas [L x [B, K_shard]] from the entering alpha a0
    and the solve's scalars cm[l] = c_l M_l, M[i] = M_{i+1} ([B] each): the
    forward's and the backward rebuild's one helper, so the two agree bit
    for bit."""
    alphas = []
    for i in range(SEG_LEN):
        A = R[(0, i)] * a0
        for l in range(i + 1):
            A = A + cm[l][:, None] * R[(l, i)]
        alphas.append(A / torch.clamp(M[i], min=_TINY)[:, None])
    return alphas


def _zero_a0(words, B):
    return torch.zeros((B, words.shape[1]), dtype=torch.float32, device=words.device)


def seg_fwd_local_plain(dl, words, trans2, mx, a0, c, K_loc):
    """Plain version of seg_fwd_local (the local reductions of the JAX
    body's fwd_seg)."""
    R = _fwd_R(dl, words, trans2, mx, c, K_loc)
    if a0 is None:
        a0 = _zero_a0(words, dl.shape[0])
    vals = [R[(0, i)] * a0 for i in range(SEG_LEN)] + [R[p] for p in _TRI]
    nt = n_tiles(words.shape[1])
    return torch.stack([_tile_sums(v, nt) for v in vals], 2)


def _fwd_apply(dl, words, trans2, mx, tot, a0, c, K_loc, K):
    """The mass solve and reconstruction of the JAX body's fwd_seg: (the
    segment's alphas, cm, M, log M_L)."""
    L = SEG_LEN
    g0 = c * L
    cl = trans2[1, g0:g0 + L] / (K * torch.clamp(trans2[0, g0:g0 + L], min=_TINY))
    P = {p: tot[:, L + j] for j, p in enumerate(_TRI)}
    Mr = [torch.ones_like(tot[:, 0])]
    for i in range(L):
        acc = tot[:, i]
        for l in range(i + 1):
            acc = acc + cl[l] * Mr[l] * P[(l, i)]
        Mr.append(acc)
    cm = [cl[l] * Mr[l] for l in range(L)]
    if a0 is None:
        a0 = _zero_a0(words, dl.shape[0])
    alphas = _seg_alphas(_fwd_R(dl, words, trans2, mx, c, K_loc), a0, cm, Mr[1:])
    return alphas, cm, Mr[1:], torch.log(torch.clamp(Mr[L], min=_TINY))


def seg_fwd_apply_plain(dl, words, trans2, mx, tot, a0, alphas, logm, c, K_loc, K):
    """Plain version of seg_fwd_apply."""
    got, _, _, lm = _fwd_apply(dl, words, trans2, mx, tot, a0, c, K_loc, K)
    alphas.copy_(torch.stack(got))
    if logm is not None:
        logm[c] = lm


def seg_fwd_step_plain(dl, words, trans2, mx, tot, ckpt, scal, logm, c, K_loc, K, _alphas=None):
    """Plain version of seg_fwd_step: seg_fwd_apply's algebra, the last
    alpha and the scalars kept, then seg_fwd_local of segment c + 1."""
    a0 = ckpt[c - 1] if c else None
    got, cm, M, lm = _fwd_apply(dl, words, trans2, mx, tot, a0, c, K_loc, K)
    ckpt[c] = got[-1]
    scal[c] = torch.stack(cm + M, 1)
    if logm is not None:
        logm[c] = lm
    if _alphas is not None:
        _alphas.copy_(torch.stack(got))
    if c + 1 == words.shape[0] // SEG_LEN:
        return None
    return seg_fwd_local_plain(dl, words, trans2, mx, ckpt[c], c + 1, K_loc)


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


def _bwd_apply(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0, cap_grid,
               gscale=None):
    """The mass solve and reconstruction of the JAX body's bwd_seg from the
    segment's alphas [L x [B, K_shard]], with its gamma numerators'
    per-tile dosage and normaliser sums, top-K lists and capture, and the
    carry B_0 / N_0. gscale [L x [B]] scales grid j's numerators (the
    step's M_{j+1} / M_L; None: unscaled, the previous form)."""
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
        gam = alphas[j] * Bj                                                # [B, KS]
        if gscale is not None:
            gam = gam * gscale[j][:, None]
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


def seg_bwd_apply_plain(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0,
                        cap_grid):
    """Plain version of seg_bwd_apply (alphas [L, B, K_shard])."""
    _bwd_apply(dl, words, trans2, mx, list(alphas), tot, thin, beta, out, c, K_loc, K, k0,
               cap_grid)


def rebuilt_alphas_plain(dl, words, trans2, mx, ckpt, scal, c, K_loc):
    """Segment c's alphas [L x [B, K_shard]] rebuilt from checkpoint c - 1
    and scal[c] (the backward step's rebuild)."""
    L = SEG_LEN
    a0 = ckpt[c - 1] if c else _zero_a0(words, dl.shape[0])
    sc = scal[c]
    return _seg_alphas(_fwd_R(dl, words, trans2, mx, c, K_loc), a0,
                       [sc[:, l] for l in range(L)], [sc[:, L + i] for i in range(L)])


def gamma_scale_plain(scal, c):
    """[L x [B]]: the scale of segment c's gamma numerators, M_{j+1} / M_L
    from the forward's scalars (csrc/fb_sharded.cu gamma_scale: the scaled
    numerators of every grid sum to sum_k alpha_{L-1} B_{L-1} >= jump / K,
    where unscaled they can fall below float32's range)."""
    L = SEG_LEN
    ML = torch.clamp(scal[c][:, 2 * L - 1], min=_TINY)
    return [torch.clamp(scal[c][:, L + j], min=_TINY) / ML for j in range(L)]


def seg_bwd_step_plain(dl, words, trans2, mx, ckpt, scal, tot, thin, beta, out, c, K_loc, K, k0,
                       cap_grid, _alphas=None):
    """Plain version of seg_bwd_step: the alphas rebuilt, seg_bwd_apply's
    algebra on them with the numerators scaled by gamma_scale_plain, then
    seg_bwd_local of segment c - 1 from the carry."""
    alphas = rebuilt_alphas_plain(dl, words, trans2, mx, ckpt, scal, c, K_loc)
    if _alphas is not None:
        _alphas.copy_(torch.stack(alphas))
    _bwd_apply(dl, words, trans2, mx, alphas, tot, thin, beta, out, c, K_loc, K, k0, cap_grid,
               gamma_scale_plain(scal, c))
    return seg_bwd_local_plain(dl, words, trans2, mx, beta, c - 1, K_loc) if c else None


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


def _forward(shards, dls, mx, group, K, logm):
    """The forward over the segments: seg_fwd_local of segment 0, then a
    seg_fwd_step a segment, each shard's local sums exchanged between
    launches. Returns each shard's (checkpoint plane, scalar plane)."""
    Gp, KS = shards[0].words.shape
    B, NSC = dls[0].shape[0], Gp // SEG_LEN
    state = [(torch.empty((NSC, B, KS), dtype=torch.float32, device=sh.device),
              torch.empty((NSC, B, SCAL_VALS), dtype=torch.float32, device=sh.device))
             for sh in shards]
    parts = [seg_fwd_local(d, sh.words, sh.trans2, m, None, 0, sh.K_loc)
             for sh, d, m in zip(shards, dls, mx)]
    for c in range(NSC):
        tots = group.sum([p.sum(1) for p in parts])
        parts = [seg_fwd_step(d, sh.words, sh.trans2, m, t, ck, sc, logm if i == 0 else None, c,
                              sh.K_loc, K)
                 for i, (sh, d, m, t, (ck, sc)) in enumerate(zip(shards, dls, mx, tots, state))]
    return state


def _backward(shards, dls, mx, group, K, state, outs, cap_grid):
    """The backward: seg_bwd_local of the last segment, then a seg_bwd_step
    a segment down to 0, the local sums exchanged between launches."""
    Gp, KS = shards[0].words.shape
    B, NSC = dls[0].shape[0], Gp // SEG_LEN
    betas = [torch.ones((B, KS), dtype=torch.float32, device=sh.device) for sh in shards]
    parts = [seg_bwd_local(d, sh.words, sh.trans2, m, b, NSC - 1, sh.K_loc)
             for sh, d, m, b in zip(shards, dls, mx, betas)]
    for c in range(NSC - 1, -1, -1):
        tots = group.sum([p.sum(1) for p in parts])
        parts = [seg_bwd_step(d, sh.words, sh.trans2, m, ck, sc, t, sh.thin, b, o, c, sh.K_loc, K,
                              sh.k0, cap_grid)
                 for sh, d, m, (ck, sc), t, b, o in zip(shards, dls, mx, state, tots, betas, outs)]


def _forward_prev(shards, dls, mx, group, K, logm):
    """The previous form's forward: a local and an apply pass a segment,
    every alpha in a [Gp, B, K_shard] plane."""
    Gp, KS = shards[0].words.shape
    B, L = dls[0].shape[0], SEG_LEN
    alphas = [torch.empty((Gp, B, KS), dtype=torch.float32, device=sh.device) for sh in shards]
    for c in range(Gp // L):
        a0s = [a[c * L - 1] if c else None for a in alphas]
        tots = group.sum([seg_fwd_local(d, sh.words, sh.trans2, m, a0, c, sh.K_loc).sum(1)
                          for sh, d, m, a0 in zip(shards, dls, mx, a0s)])
        for i, (sh, d, m, t, a0, a) in enumerate(zip(shards, dls, mx, tots, a0s, alphas)):
            seg_fwd_apply(d, sh.words, sh.trans2, m, t, a0, a[c * L:(c + 1) * L],
                          logm if i == 0 else None, c, sh.K_loc, K)
    return alphas


def _backward_prev(shards, dls, mx, group, K, alphas, outs, cap_grid):
    Gp, KS = shards[0].words.shape
    B, L = dls[0].shape[0], SEG_LEN
    betas = [torch.ones((B, KS), dtype=torch.float32, device=sh.device) for sh in shards]
    for c in range(Gp // L - 1, -1, -1):
        tots = group.sum([seg_bwd_local(d, sh.words, sh.trans2, m, b, c, sh.K_loc).sum(1)
                          for sh, d, m, b in zip(shards, dls, mx, betas)])
        for sh, d, m, a, t, b, o in zip(shards, dls, mx, alphas, tots, betas, outs):
            seg_bwd_apply(d, sh.words, sh.trans2, m, a[c * L:(c + 1) * L], t, sh.thin, b, o, c,
                          sh.K_loc, K, sh.k0, cap_grid)


def sharded_core(gl, shards: List[PanelShard], group, K: int, K_top: int, ref_error: float,
                 cap_grid: int = -1, _prev: bool = False):
    """The segment-fused FB of one row batch over the panel shards of one
    data row: gl [B, 2, Gp*32] f32 on group.devices[0]; group exchanges the
    shards' partial tensors (dist.mesh.PanelGroup: sum / max / broadcast /
    gather). Returns, on gl's device, (dosage [B, Gp*32], log_like [B], tv /
    ti [Gp, B, K_top x n_shards] the shards' lists merged by value, zero
    values at index 0) and, with a capture grid, gcap [B, n_shards x
    K_shard], the normalised gamma at that grid. A shard launches 2 (Gp / L
    + 1) segment kernels a call. _prev (timings and tests only) runs the
    previous form: 4 Gp / L launches, every alpha in a plane."""
    eps = float(ref_error)
    Gp, KS = shards[0].words.shape
    B = gl.shape[0]
    NSC, nt = Gp // SEG_LEN, n_tiles(KS)
    dl, csum = _gl_log_ratios(gl, eps)
    dls = group.broadcast(dl)
    mxs = []
    for sh, d in zip(shards, dls):
        with on_device(sh.device):
            mxs.append(fb_max_tiled(d, sh.words, sh.K_loc, KS) if sh.K_loc else
                       torch.full((Gp, B), _NEG, dtype=torch.float32, device=sh.device))
    mx = group.max(mxs)

    logm = torch.empty((NSC, B), dtype=torch.float32, device=gl.device)
    state = (_forward_prev if _prev else _forward)(shards, dls, mx, group, K, logm)
    log_like = logm.sum(0) + mx[0].sum(0) + csum

    outs = []
    for sh in shards:
        z = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=sh.device)
        outs.append(dict(dpart=z(nt, B, Gp * 32), gnp=z(nt, Gp, B), tvp=z(nt, Gp, B, K_top),
                         tip=z(nt, Gp, B, K_top, dt=torch.int32),
                         gcap=torch.zeros((B, KS), dtype=torch.float32, device=sh.device)
                         if cap_grid >= 0 else None))
    (_backward_prev if _prev else _backward)(shards, dls, mx, group, K, state, outs, cap_grid)
    del state

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
