"""The diploid Gibbs call: 21 (n_its) forward/backward sweeps over a chain
batch on the grid-padded read layout, with on-the-fly suffix-swap block
moves.

Counterpart of the parts of quilt_tpu/kernels/gibbs_pallas.py that the
QUILT1 diploid path runs: the slot layout and index caches of
run_gibbs_chains_pallas (:1212-1257), the sweep loop of _gibbs_core_pallas
(:772-1088) with its per-iteration likelihood row, and the block moves
_live_jump_rate_padded (:644), _suffix_pair_composed_padded (:670), plus
quilt_tpu/kernels/gibbs.py:_run_peaks / _boundaries_from_rate (:108-202,
the 4-pass boundary cascade) and _pair_swap_parity (:262). Given the packed
subset words, the call also returns the Gibbs haplotype dosages and
genotype posteriors (gibbs_pallas.py:1037-1088, the dosage kernel): the
QUILT2 paths (msPBWT selection, the rare/common all-SNP call) consume them;
the QUILT1 diploid engine takes its dosages from the full-panel FB and
does not ask for them.

Layouts are nl-major: state rows h*B + b of [G, 2B, K] planes.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..inputs import GibbsInputs
from .gibbs_dosage import dosage_sweep
from .gibbs_sweep import bwd_sweep, fwd_sweep

PER_IT_COLS = (
    "p_O1_given_H1_L", "p_O2_given_H2_L", "p_O3_given_H3_L",
    "p_O_given_H_L", "p_H_given_L", "p_H_given_O_L_up_to_C",
    "p_set_H_given_L", "relabel",
)
BOUNDARY_PASSES = 4   # cascade depth of the device boundary detector
PRIOR = (0.5, 0.5)


@dataclass
class SlotLayout:
    """Grid-padded read slots of a chain batch: slot (g, i, b) holds row
    b's i-th read in grid g; W = max reads per grid over rows."""

    G: int
    W: int
    r_pad: torch.Tensor       # [G, W, B] i32 read index, -1 = empty slot
    valid: torch.Tensor       # [G, W, B] bool
    r_clip: torch.Tensor      # [G, W, B] int64 read index clipped into [0, R)
    cnt_max: torch.Tensor     # [1, G] i32 max reads in grid g over rows
    idx_back: torch.Tensor    # [B, R] int64 flat G*W slot of each read
    mask: torch.Tensor        # [B, R] bool real reads

    @classmethod
    def build(cls, inputs: GibbsInputs, B: int, device) -> "SlotLayout":
        """Layout of B chains; a single-row `inputs` is shared by all."""
        rs, rc, w, m = (np.broadcast_to(x, (B,) + x.shape[1:]) for x in (
            inputs.read_start, inputs.read_count, inputs.wif0, inputs.read_mask))
        G, R = inputs.G, inputs.R
        W = max(int(rc.max()), 1)
        ar_w = np.arange(W, dtype=np.int32)
        r_pad = np.where(ar_w[None, None, :] < rc[:, :, None],
                         rs[:, :, None] + ar_w[None, None, :], -1)
        r_pad = np.ascontiguousarray(np.transpose(r_pad, (1, 2, 0))).astype(np.int32)
        g_of_r = np.clip(w, 0, G - 1).astype(np.int64)
        i_of_r = np.clip(np.arange(R)[None, :] - np.take_along_axis(
            rs.astype(np.int64), g_of_r, axis=1), 0, W - 1)
        t = lambda x: torch.as_tensor(np.array(x, order="C"), device=device)
        return cls(
            G=G, W=W, r_pad=t(r_pad), valid=t(r_pad >= 0),
            r_clip=t(np.clip(r_pad, 0, R - 1).astype(np.int64)),
            cnt_max=t(rc.max(axis=0).astype(np.int32)[None, :]),
            idx_back=t(g_of_r * W + i_of_r), mask=t(m),
        )

    def to_slots(self, x: torch.Tensor, fill) -> torch.Tensor:
        """[B, R] per-read values -> [G, W, B] slots (fill at empty ones)."""
        b = torch.arange(x.shape[0], device=x.device)
        return torch.where(self.valid, x[b, self.r_clip], fill)


def counts_of(H_pad: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, 2] label counts of the live slots."""
    oh = torch.nn.functional.one_hot(H_pad.clamp(0, 1).long(), 2).to(torch.float32)
    return (oh * valid[..., None]).sum((0, 1))


def log_dmultinom(rc: torch.Tensor, p) -> torch.Tensor:
    """log multinomial pmf over the last axis (calc_prob_of_set_of_reads,
    gibbs-nipt.R:1308-1312)."""
    n = rc.sum(-1)
    logp = torch.log(torch.as_tensor(p, dtype=rc.dtype, device=rc.device))
    return (torch.lgamma(n + 1.0) - torch.lgamma(rc + 1.0).sum(-1)
            + torch.where(rc > 0, rc * logp, 0.0).sum(-1))


def live_jump_rate(alphas, beta, lemg, trans, B, K_real) -> torch.Tensor:
    """[G-1, B] posterior jump rate per grid gap summed over both latent
    haps, from the live FB state (reference:
    QUILT/src/gibbs-nipt-block.cpp:348-365)."""
    G, BN, K = lemg.shape
    km = torch.arange(K, device=lemg.device) < K_real
    kmf = km.to(torch.float32)
    mx = torch.where(km, lemg, -torch.inf).amax(2, keepdim=True)
    eb = torch.exp(lemg - mx) * kmf * beta
    n1 = (alphas[:-1] * eb[1:]).sum(2)                     # [G-1, BN]
    n2 = alphas[:-1].sum(2) * eb[1:].sum(2) / K_real
    t0 = trans[0, 1:][:, None]
    t1 = trans[1, 1:][:, None]
    denom = t0 * n1 + t1 * n2
    njf = torch.where(denom > 0, t0 * n1 / torch.clamp(denom, min=1e-300), 1.0)
    rate2 = (1.0 - njf).reshape(G - 1, 2, B).sum(1)
    rate2[-1] = 0.0
    return rate2


def run_peaks(smoothed: torch.Tensor, avail: torch.Tensor):
    """Per-run maxima of contiguous available runs, the leftmost on ties
    (the reference's stable descending sort). Returns masks [Gm, B]
    (peak, start, end) and, per position, the id of its (run, column)
    pair (ids of unavailable positions are meaningless)."""
    Gm, B = avail.shape
    start = avail & torch.cat([torch.ones_like(avail[:1]), ~avail[:-1]])
    end = avail & torch.cat([~avail[1:], torch.ones_like(avail[:1])])
    rid = torch.cumsum(start.long(), 0) - 1
    flat = (rid.clamp(min=0) * B + torch.arange(B, device=avail.device)).reshape(-1)
    score = torch.where(avail, smoothed, -torch.inf)
    run_max = torch.full((Gm * B,), -torch.inf, device=score.device).scatter_reduce(
        0, flat, score.reshape(-1), "amax")
    cand = avail & (score >= run_max[flat].reshape(avail.shape))
    pos = torch.arange(Gm, device=avail.device)[:, None].expand_as(avail)
    first = torch.full((Gm * B,), Gm, device=avail.device).scatter_reduce(
        0, flat, torch.where(cand, pos, Gm).reshape(-1), "amin")
    peak = cand & (pos == first[flat].reshape(avail.shape))
    return peak, start, end, flat


def boundaries_from_rate(rate2, smooth_w, NB, quantile_prob):
    """Per-row block-Gibbs boundaries from the live jump rate (reference:
    Rcpp_define_blocked_snps_using_gamma_on_the_fly,
    QUILT/src/gibbs-nipt-block.cpp:311-527): smooth over physical distance
    with the banded operator, threshold at min(1, sorted[int(n*q)]), then
    BOUNDARY_PASSES passes of the greedy descending-peak cascade (an
    interior peak consumes its run, an edge peak its +-1 neighbourhood).
    Keeps the NB highest peaks per row. rate2 [Gm, B]; smooth_w = (band
    [Gm, bw], idx0 [Gm]). Returns [NB, B] int32 suffix-start grids,
    ascending per row, 0 = pad."""
    Gm, B = rate2.shape
    band, idx0 = smooth_w
    bw = band.shape[1]
    gidx = torch.clamp(idx0[:, None].long() + torch.arange(bw, device=rate2.device)[None, :],
                       0, Gm - 1)
    smoothed = (band[:, :, None] * rate2[gidx]).sum(1)           # [Gm, B]
    v = min(int(Gm * quantile_prob), Gm - 1)
    thresh = torch.clamp(torch.sort(smoothed, dim=0).values[v], max=1.0)
    avail = smoothed > thresh[None, :]
    all_peaks = torch.zeros_like(avail)
    for _ in range(BOUNDARY_PASSES):
        peak, start, end, flat = run_peaks(smoothed, avail)
        all_peaks |= peak
        interior = peak & ~start & ~end
        # an interior peak consumes its whole run
        run_hit = torch.zeros((Gm * B,), dtype=torch.long, device=avail.device).scatter_reduce(
            0, flat, interior.reshape(-1).long(), "amax")
        consumed = avail & (run_hit[flat].reshape(avail.shape) > 0)
        near = peak.clone()
        near[1:] |= peak[:-1]
        near[:-1] |= peak[1:]
        avail = avail & ~consumed & ~near
    pscore = torch.where(all_peaks, smoothed, -torch.inf)
    vals, idx = torch.topk(pscore.T, min(NB, Gm), dim=1)         # [B, NB]
    bnd = torch.where(torch.isfinite(vals), idx + 1, 0)
    if bnd.shape[1] < NB:
        bnd = torch.nn.functional.pad(bnd, (0, NB - bnd.shape[1]))
    return torch.sort(bnd, dim=1).values.T.to(torch.int32).contiguous()


def pair_swap_parity(C, block_u, bnd_rb, G) -> torch.Tensor:
    """Diploid suffix pair-swap decisions for all boundaries at once: the
    keep/swap products are invariant under the plane swap, so acceptance
    comes from the original state and the net effect per grid is the XOR
    prefix of accepted swaps (same draws as the sequential loop; reference
    Rcpp_shard_block_gibbs_resampler, gibbs-nipt-block.cpp:1975-2355).
    C [NB, B, 2, 2]; block_u / bnd_rb [NB, B]. Returns parity [G, B]."""
    w_keep = C[..., 0, 0] * C[..., 1, 1]
    w_swap = C[..., 0, 1] * C[..., 1, 0]
    tot = w_keep + w_swap
    ok = torch.isfinite(tot) & (tot > 0)
    p_swap = torch.where(ok, w_swap / torch.where(tot > 0, tot, 1.0), 0.0)
    do_swap = (bnd_rb > 0) & ok & (block_u < p_swap)             # [NB, B]
    gids = torch.arange(G, device=C.device)[:, None, None]
    leq = (bnd_rb[None] > 0) & (bnd_rb[None] <= gids)
    return (leq & do_swap[None]).sum(1) % 2 == 1


def suffix_pair_composed(lemg, beta, alphas, H_pad, bnd_rb, block_u_j0, B, K_real):
    """Composed diploid suffix swaps at per-row boundaries: swaps the two
    latent planes of every grid whose swap parity is odd, and the labels
    of its slots."""
    G, BN, K = lemg.shape
    km = (torch.arange(K, device=lemg.device) < K_real).to(torch.float32)
    idxg = torch.clamp(bnd_rb.long() - 1, 0, G - 1)               # [NBu, B]
    idx = torch.cat([idxg, idxg], 1)[:, :, None].expand(-1, -1, K)
    a4 = alphas.gather(0, idx).reshape(-1, 2, B, K)
    b4 = beta.gather(0, idx).reshape(-1, 2, B, K)
    C = torch.einsum("jibk,jlbk->jbil", a4, b4 * km)
    parity = pair_swap_parity(C, block_u_j0, bnd_rb, G)           # [G, B]
    p = parity.long()
    idx2 = torch.stack([p, 1 - p], 1)[..., None].expand(G, 2, B, K)
    lemg, beta, alphas = (a.reshape(G, 2, B, K).gather(1, idx2).reshape(G, BN, K)
                          for a in (lemg, beta, alphas))
    par = parity[:, None, :]
    H_pad = torch.where(par & (H_pad == 0), 1, torch.where(par & (H_pad == 1), 0, H_pad))
    return lemg, beta, alphas, H_pad.to(torch.int32)


def run_gibbs_chains(layout: SlotLayout, trans, lem, skip, uniforms, H0, first_read,
                     iterative_init, K_real, block_u=None, do_block=None,
                     smooth_w=None, quantile_prob=0.95, words=None,
                     ref_error=0.001, timed=None):
    """One diploid Gibbs call over B chains.

    trans [2, G] f32 (stay, jump) into each grid (grid 0: (1, 0));
    lem [B, Kp, R] f32 rescaled log emissions and skip [B, R] bool
    uninformative reads (lem_subset, or log of emat_read_from_bits);
    uniforms [n_its, B, R]; H0 [B, R] i32; first_read [B] i32; block_u
    [n_its, NBu, 3, B] and do_block [n_its] bool with smooth_w the
    on-the-fly boundary smoothing band; words [B, Kp, G] i32 the packed
    subset words (gather_words) when the call is to return dosages;
    timed(name) a context manager timing the dosage pass. Returns (labels
    [B, R] i32, per-iteration likelihoods [n_its, B, 8], underflow [B]
    bool, hap_dos [B, 2, G*32] f32, gp [B, 3, G*32] f32); the last two are
    None without words."""
    B, K, R = lem.shape
    G, W = layout.G, layout.W
    n_its = uniforms.shape[0]
    dev = lem.device
    valid = layout.valid
    skip_r = skip | ~layout.mask
    b_idx = torch.arange(B, device=dev)
    # [G, W, B, K] float32 slot emissions; zeroed in place at empty slots
    lem_pad = lem.transpose(1, 2)[b_idx, layout.r_clip]
    lem_pad.masked_fill_(~valid[..., None], 0.0)
    H_pad = layout.to_slots(H0.to(torch.int32), 0).to(torch.int32)
    skip_pad = layout.to_slots(skip_r.to(torch.int32), 1).to(torch.int32)
    first_col = first_read.reshape(B, 1).to(torch.int32).contiguous()
    if iterative_init:
        lemg = torch.zeros((G, 2 * B, K), dtype=torch.float32, device=dev)
    else:
        oh = torch.nn.functional.one_hot(H_pad.long(), 2).to(torch.float32) * valid[..., None]
        lemg = torch.einsum("gwbn,gwbk->gnbk", oh, lem_pad).reshape(G, 2 * B, K).contiguous()
    beta = torch.ones((G, 2 * B, K), dtype=torch.float32, device=dev)
    alphas = None
    uf = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    lab = counts_of(H_pad, valid)
    per_it = torch.zeros((n_its, B, len(PER_IT_COLS)), dtype=torch.float32, device=dev)
    do_block = np.zeros(n_its, bool) if do_block is None else np.asarray(do_block, bool)
    NBu = 0 if block_u is None else block_u.shape[1]
    log_prior = torch.log(torch.tensor(PRIOR, device=dev))
    for it in range(n_its):
        it_mode = it if (iterative_init and it <= 1) else 2
        want_alpha = bool(do_block[it] or it == n_its - 1)
        u_pad = layout.to_slots(uniforms[it].to(torch.float32), 0.0)
        slots = torch.stack([u_pad.view(torch.int32), H_pad, skip_pad, layout.r_pad], 1).contiguous()
        lemg, alphas, H_pad, logc, uf_it, lab = fwd_sweep(
            lemg, beta, lem_pad, slots, first_col, lab, trans,
            layout.cnt_max, nl=2, K_real=K_real, it_mode=it_mode,
            prior=PRIOR, want_alpha=want_alpha,
        )
        uf = torch.maximum(uf, uf_it)
        beta = bwd_sweep(lemg, trans, nl=2, K_real=K_real)
        if do_block[it] and smooth_w is not None and NBu > 0:
            rate2 = live_jump_rate(alphas, beta, lemg, trans, B, K_real)
            bnd_rb = boundaries_from_rate(rate2, smooth_w, NBu, quantile_prob)
            lemg, beta, alphas, H_pad = suffix_pair_composed(
                lemg, beta, alphas, H_pad, bnd_rb, block_u[it, :, 0], B, K_real)
            lemg, beta = lemg.contiguous(), beta.contiguous()
            lab = counts_of(H_pad, valid)
        p_O_h = logc.reshape(2, B).T                               # [B, 2]
        p_O = p_O_h.sum(1)
        p_H = (lab * log_prior[None, :]).sum(1)
        per_it[it] = torch.stack([
            p_O_h[:, 0], p_O_h[:, 1], torch.zeros_like(p_O), p_O, p_H,
            p_O + p_H, log_dmultinom(lab, PRIOR), torch.ones_like(p_O),
        ], 1)
    H_flat = H_pad.reshape(G * W, B).T                              # [B, G*W]
    H_out = torch.where(layout.mask, H_flat.gather(1, layout.idx_back), 0).to(torch.int32)
    hap_dos = gp = None
    if words is not None:
        timed = timed or (lambda name: contextlib.nullcontext())
        with timed("gibbs:dosage_kernel"):
            hd = dosage_sweep(alphas.contiguous(), beta, words.permute(2, 0, 1).contiguous(),
                              2, K_real, ref_error)                 # [G, 2B, 32]
            hap_dos = hd.reshape(G, 2, B, 32).permute(2, 1, 0, 3).reshape(B, 2, G * 32)
            h1, h2 = hap_dos[:, 0], hap_dos[:, 1]
            gp = torch.stack([(1 - h1) * (1 - h2), h1 * (1 - h2) + (1 - h1) * h2, h1 * h2], 1)
    return H_out, per_it, uf[:, 0] > 0, hap_dos, gp
