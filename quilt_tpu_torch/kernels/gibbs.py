"""The Gibbs call, diploid (nl = 2 latent haplotypes a chain) and NIPT
(nl = 3: the mother's two and the fetus's paternal one): 21 (n_its)
forward/backward sweeps over a chain batch on the grid-padded read layout,
with on-the-fly block moves.

Counterpart of the parts of quilt_tpu/kernels/gibbs_pallas.py that the
batched engine runs: the slot layout and index caches of
run_gibbs_chains_pallas (:1212-1257), the sweep loop of _gibbs_core_pallas
(:772-1088) with its per-iteration likelihood row, and the block moves
_live_jump_rate_padded (:644), _suffix_pair_composed_padded (:670), plus
quilt_tpu/kernels/gibbs.py:_run_peaks / _boundaries_from_rate (:108-202,
the 4-pass boundary cascade) and _pair_swap_parity (:262). For NIPT: the
read classes _compute_Hclass_padded (:538, taken from the state at the end
of an iteration), the within-block 6-relabelling move with the label
resample from the classes (quilt_tpu/kernels/gibbs.py:nipt_block_within
:423, the production move set) and the entire relabelling
(_apply_perm3_padded :564, gibbs.py:_entire_probs :286). Given the packed
subset words, the call also returns the Gibbs haplotype dosages and
genotype posteriors (gibbs_pallas.py:1037-1088, the dosage kernel): the
QUILT2 paths (msPBWT selection, the rare/common all-SNP call) consume them;
the QUILT1 engine takes its dosages from the full-panel FB and does not ask
for them.

Layouts are nl-major: state rows h*B + b of [G, nl*B, K] planes.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..inputs import GibbsInputs
from . import nipt as nipt_tables
from .gibbs_dosage import dosage_sweep
from .gibbs_sweep import bwd_sweep, fwd_sweep
from .nipt_bank import bank_scan

PER_IT_COLS = (
    "p_O1_given_H1_L", "p_O2_given_H2_L", "p_O3_given_H3_L",
    "p_O_given_H_L", "p_H_given_L", "p_H_given_O_L_up_to_C",
    "p_set_H_given_L", "relabel",
)
BOUNDARY_PASSES = 4   # cascade depth of the device boundary detector
# bytes of the exponentiated slot emissions one step of the read
# classification may hold
_HCLASS_CHUNK_BYTES = 1 << 28


class GibbsCall(NamedTuple):
    """What run_gibbs_chains returns. The dosages and posteriors are None
    without packed words; gpF (mother's transmitted + fetus's paternal
    haplotype) is gp at nl = 2; H_class is all 0 at nl = 2."""

    H: torch.Tensor                    # [B, R] i32 read labels
    per_it: torch.Tensor               # [n_its, B, 8] PER_IT_COLS
    underflow: torch.Tensor            # [B] bool
    hap_dos: Optional[torch.Tensor]    # [B, nl, G*32]
    gp: Optional[torch.Tensor]         # [B, 3, G*32]
    gpF: Optional[torch.Tensor]        # [B, 3, G*32]
    H_class: torch.Tensor              # [B, R] i32 NIPT read classes 0..7


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

    def rows(self, b0: int, b1: int, device) -> "SlotLayout":
        """The layout of rows b0 .. b1-1 on `device`, with the whole batch's
        W and per-grid maxima (a chain's steps do not depend on the others)."""
        t = lambda x: x.to(device).contiguous()
        return SlotLayout(G=self.G, W=self.W, r_pad=t(self.r_pad[:, :, b0:b1]),
                          valid=t(self.valid[:, :, b0:b1]), r_clip=t(self.r_clip[:, :, b0:b1]),
                          cnt_max=t(self.cnt_max), idx_back=t(self.idx_back[b0:b1]),
                          mask=t(self.mask[b0:b1]))

    def to_slots(self, x: torch.Tensor, fill) -> torch.Tensor:
        """[B, R] per-read values -> [G, W, B] slots (fill at empty ones)."""
        b = torch.arange(x.shape[0], device=x.device)
        return torch.where(self.valid, x[b, self.r_clip], fill)


def counts_of(H_pad: torch.Tensor, valid: torch.Tensor, nl: int = 2) -> torch.Tensor:
    """[B, nl] label counts of the live slots."""
    oh = torch.nn.functional.one_hot(H_pad.clamp(0, nl - 1).long(), nl).to(torch.float32)
    return (oh * valid[..., None]).sum((0, 1))


def sample_idx(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF choice along the last axis; u [...] in [0, 1)."""
    cum = torch.cumsum(probs, -1)
    return (cum <= u[..., None]).sum(-1).clamp(max=probs.shape[-1] - 1)


def log_dmultinom(rc: torch.Tensor, p) -> torch.Tensor:
    """log multinomial pmf over the last axis (calc_prob_of_set_of_reads,
    gibbs-nipt.R:1308-1312)."""
    n = rc.sum(-1)
    logp = torch.log(torch.as_tensor(p, dtype=rc.dtype, device=rc.device))
    return (torch.lgamma(n + 1.0) - torch.lgamma(rc + 1.0).sum(-1)
            + torch.where(rc > 0, rc * logp, 0.0).sum(-1))


def live_jump_rate(alphas, beta, lemg, trans, B, K_real, include3=True) -> torch.Tensor:
    """[G-1, B] posterior jump rate per grid gap summed over the latent
    haps, from the live FB state (reference:
    QUILT/src/gibbs-nipt-block.cpp:348-365); include3=False leaves the
    third hap of a NIPT chain out (fetal fraction 0)."""
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
    r = (1.0 - njf).reshape(G - 1, BN // B, B)
    rate2 = r.sum(1) if include3 else r[:, 0] + r[:, 1]
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


def nipt_tables_for(ff: float, device):
    """(prior tuple, rlc [7, 3], clp [8], perm_mask [6]) of a NIPT call at
    fetal fraction ff: the label prior, the read-class probability rows, the
    per-class log label probabilities and the relabellings allowed (at
    ff = 0 only the identity and the swap of the mother's two)."""
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    perm_mask = np.ones(6, dtype=np.float32)
    if ff <= 0.0:
        perm_mask[[1, 3, 4, 5]] = 0.0
    prior = tuple(float(x) for x in nipt_tables.nipt_prior(ff))
    return prior, t(nipt_tables.make_rlc(ff)), t(nipt_tables.class_log_p(ff)), t(perm_mask)


def classify3(gain, lose_C, pC, h_cur, prior, rlc, cutoff=nipt_tables.CLASS_SUM_CUTOFF):
    """Batched NIPT read classification (see kernels/nipt.py). gain [..., 3],
    lose_C [...], pC [..., 3], h_cur [...] int -> class [...] i32 in 0..7."""
    oh = torch.nn.functional.one_hot(h_cur, 3).to(gain.dtype)
    stay = pC.prod(-1)
    ws = []
    for n in range(3):
        e_n = torch.zeros(3, dtype=gain.dtype, device=gain.device)
        e_n[n] = 1.0
        pC_m = (pC * (1.0 - oh) * (1.0 - e_n)).sum(-1)
        w_n = torch.where(h_cur == n, stay, lose_C * gain[..., n] * pC_m)
        ws.append(w_n * prior[n])
    w = torch.stack(ws, -1)
    s = w.sum(-1, keepdim=True)
    ok = torch.isfinite(s[..., 0]) & (s[..., 0] > 0)
    x = w / torch.where(s > 0, s, 1.0)
    y = (x[..., None, :] - rlc).abs().sum(-1)                     # [..., 7]
    ymin, cls = y.min(-1)
    return torch.where(ok & (ymin < cutoff), cls + 1, 0).to(torch.int32)


def compute_hclass(alphas, beta, lem_pad, H_pad, live, prior, rlc) -> torch.Tensor:
    """NIPT read classes on the grid-padded layout, from the state at the
    end of an iteration (not mid-sweep, as the reference takes them: the JAX
    package's documented deviation). alphas / beta [G, 3B, K]; lem_pad
    [G, W, B, K]; H_pad / live [G, W, B]. Returns [G, W, B] i32, 0 at slots
    that are not live. A few grids at a time, so the exponentiated slot
    emissions stay small."""
    G, BN, K = alphas.shape
    W, B = lem_pad.shape[1], lem_pad.shape[2]
    prior_t = torch.as_tensor(prior, dtype=torch.float32, device=alphas.device)
    out = torch.empty((G, W, B), dtype=torch.int32, device=alphas.device)
    step = max(1, _HCLASS_CHUNK_BYTES // (W * B * K * 4))
    for g0 in range(0, G, step):
        g1 = min(g0 + step, G)
        ab = (alphas[g0:g1] * beta[g0:g1]).reshape(g1 - g0, 3, B, K)
        em = torch.exp(lem_pad[g0:g1])
        gain = torch.einsum("gwbk,ghbk->gwbh", em, ab)
        lose = torch.einsum("gwbk,ghbk->gwbh", 1.0 / em, ab)
        h_cur = H_pad[g0:g1].clamp(0, 2).long()
        lose_C = lose.gather(3, h_cur[..., None])[..., 0]
        pC = ab.sum(3).permute(0, 2, 1)[:, None]                   # [g, 1, B, 3]
        cls = classify3(gain, lose_C, pC.expand_as(gain), h_cur, prior_t, rlc)
        out[g0:g1] = torch.where(live[g0:g1], cls, 0)
    return out


def _perm_tables(device):
    t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
    return t(nipt_tables.PERMS), t(nipt_tables.INVS), t(nipt_tables.CLASS_PERM)


def _permute_planes(planes, inv_sel):
    """new plane i = old plane inv_sel[g, i, b] of each [G, 3B, K] array."""
    G, BN, K = planes[0].shape
    idx = inv_sel[..., None].expand(G, 3, BN // 3, K)
    return [a.reshape(G, 3, BN // 3, K).gather(1, idx).reshape(G, BN, K) for a in planes]


def nipt_block_within(lemg, beta, H_pad, Hc_pad, valid, lem_pad, slots, first_col, trans,
                      bnd_rb, block_u_it, clp, perm_mask, rlc, K_real, resample_u_it=None):
    """Within-block 6-relabelling and the read-label resample from the read
    classes: the production NIPT move set (Rcpp_block_gibbs_resampler with
    block_approach=6 and resample_H_using_H_class, gibbs-nipt-block.cpp:
    1636-1974), as quilt_tpu/kernels/gibbs.py:nipt_block_within runs it, on
    the nl-major padded layout.

    The scan over the grids that carries the forward bank of the 6
    relabellings and draws one at each block end of each chain is
    kernels.nipt_bank.bank_scan (a CUDA kernel on the card); the class
    counts of a block do not depend on the draws and are summed here
    beforehand. Then labels, classes and lemg permute per block, the labels
    resample from the classes (when resample_u_it [G, W, B] is given) and
    lemg is rebuilt from the slot emissions. The forward and backward
    re-run that restores alpha and beta goes through the sweep kernels: a
    forward sweep told that no grid has a read (cnt_max = 0; `slots`
    [G, 4, W, B] is then unread but for its shape) is the plain alpha
    recursion.

    bnd_rb [NB, B] per-row suffix starts (0 = pad); block_u_it [NB, 3, B].
    Returns (lemg, beta, alphas, H_pad, Hc_pad)."""
    G, BN = lemg.shape[:2]
    B = BN // 3
    NB = bnd_rb.shape[0]
    dev = lemg.device
    f32 = torch.float32
    perms_t, invs_t, clsperm_t = _perm_tables(dev)
    rows_b = torch.arange(B, device=dev)
    # block topology per row from the suffix starts (pads -> G)
    bb = torch.sort(torch.where(bnd_rb > 0, bnd_rb, G).long(), dim=0).values      # [NB, B]
    gidx = torch.arange(G, device=dev)
    block_of_g = (gidx[:, None, None] >= bb[None]).sum(1)                          # [G, B]
    is_end = ((gidx[:, None, None] + 1) == bb[None]).any(1)
    is_end[G - 1] = True
    # class counts of each grid's block up to the grid, and their term
    # sum_c ns[CLASS_PERM[r, c]] * clp[c] in each relabelling's weight
    ns = torch.cumsum((torch.nn.functional.one_hot(Hc_pad.long(), 8).to(f32)
                       * valid[..., None]).sum(1), 0)                              # [G, B, 8]
    start = torch.where(block_of_g > 0, bb.gather(0, (block_of_g - 1).clamp(min=0)), 0)
    before = ns.gather(0, (start - 1).clamp(min=0)[..., None].expand(G, B, 8))
    ns = ns - torch.where((start > 0)[..., None], before, 0.0)
    ht = (ns[:, :, clsperm_t] @ clp).contiguous()                                  # [G, B, 6]
    # per-block uniforms: slot [j, 0] for block j < NB, slot [NB-1, 1] for the last
    u_blocks = torch.cat([block_u_it[:, 0], block_u_it[NB - 1:NB, 1]], 0)          # [NB+1, B]
    u_g = u_blocks[block_of_g.clamp(max=NB), rows_b[None, :]].contiguous()         # [G, B]
    chosen_g, _ = bank_scan(lemg.contiguous(), beta.contiguous(), trans, ht, u_g,
                            is_end.to(torch.int32), perm_mask, K_real)
    # a grid's relabelling is the one drawn at its block's end grid
    bnd_next = bb.gather(0, block_of_g.clamp(max=NB - 1))
    ends_g = torch.where(block_of_g < NB, bnd_next - 1, G - 1)
    perm_g = chosen_g.long().gather(0, ends_g)                                     # [G, B]
    perm_w = perm_g[:, None, :]
    H_pad = perms_t[perm_w, H_pad.clamp(0, 2).long()].to(torch.int32)
    Hc_pad = clsperm_t[perm_w, Hc_pad.long()].to(torch.int32)
    (lemg,) = _permute_planes([lemg], invs_t[perm_g].permute(0, 2, 1))

    if resample_u_it is not None:
        # class -> P(label) rows: classes 1..6 are rlc rows 0..5, classes 0
        # and 7 the prior row 6 (rcpp_sample_H_using_H_class)
        rlc_cls = rlc[torch.tensor([6, 0, 1, 2, 3, 4, 5, 6], device=dev)]
        cdf = torch.cumsum(rlc_cls[Hc_pad.long()], -1)                             # [G, W, B, 3]
        H_new = (resample_u_it[..., None] >= cdf).sum(-1).clamp(0, 2).to(torch.int32)
        H_pad = torch.where(valid, H_new, H_pad)
        lemg = lemg_from_labels(H_pad, valid, lem_pad, 3)

    # forward and backward re-run under the accepted labels
    no_reads = torch.zeros((1, G), dtype=torch.int32, device=dev)
    lab0 = torch.zeros((B, 3), dtype=f32, device=dev)
    alphas = fwd_sweep(lemg, beta, lem_pad, slots, first_col, lab0, trans, no_reads,
                       nl=3, K_real=K_real, it_mode=2, prior=(1.0, 1.0, 1.0))[1]
    beta = bwd_sweep(lemg, trans, nl=3, K_real=K_real)
    return lemg, beta, alphas, H_pad, Hc_pad


def lemg_from_labels(H_pad, valid, lem_pad, nl) -> torch.Tensor:
    """[G, nl*B, K] log grid emissions: each latent row's sum of the slot
    emissions of the reads labelled with it."""
    G, W, B, K = lem_pad.shape
    oh = torch.nn.functional.one_hot(H_pad.long(), nl).to(torch.float32) * valid[..., None]
    return torch.einsum("gwbn,gwbk->gnbk", oh, lem_pad).reshape(G, nl * B, K).contiguous()


def entire_relabel(lemg, beta, alphas, H_pad, Hc_pad, valid, log_prior, relabel_u_it):
    """Entire relabelling of a NIPT chain (rcpp_consider_and_try_entire_
    relabelling, gibbs-nipt.cpp:1553-1577): one of the 6 relabellings drawn
    per row from the label counts (get_weights_for_entire_relabelling,
    gibbs-nipt.R:1336-1352) and applied to every grid. Returns (lemg, beta,
    alphas, H_pad, Hc_pad, chosen [B])."""
    G, BN, K = lemg.shape
    B = BN // 3
    perms_t, invs_t, clsperm_t = _perm_tables(lemg.device)
    rc = counts_of(H_pad, valid, 3)
    lw = (rc[:, invs_t] * log_prior).sum(-1)                                       # [B, 6]
    lw = lw - lw.amax(1, keepdim=True)
    w = torch.exp(lw.clamp(min=-100.0))
    chosen = sample_idx(w / w.sum(1, keepdim=True), relabel_u_it)
    inv_sel = invs_t[chosen].T[None].expand(G, 3, B)
    lemg, beta, alphas = _permute_planes([lemg, beta, alphas], inv_sel)
    H_new = perms_t[chosen[None, None, :], H_pad.clamp(0, 2).long()].to(torch.int32)
    Hc_new = clsperm_t[chosen[None, None, :], Hc_pad.long()].to(torch.int32)
    return (lemg, beta, alphas, torch.where(valid, H_new, H_pad),
            torch.where(valid, Hc_new, Hc_pad), chosen)


def run_gibbs_chains(layout: SlotLayout, trans, lem, skip, uniforms, H0, first_read,
                     iterative_init, K_real, block_u=None, do_block=None,
                     smooth_w=None, quantile_prob=0.95, words=None,
                     ref_error=0.001, timed=None, nl=2, ff=0.0, resample_u=None,
                     relabel_u=None, boundaries=None, span=None,
                     span_prefix="sweep", section_prefix="gibbs") -> GibbsCall:
    """One Gibbs call over B chains: diploid (nl = 2) or NIPT (nl = 3 at
    fetal fraction ff, label prior (0.5, (1-ff)/2, ff/2)).

    trans [2, G] f32 (stay, jump) into each grid (grid 0: (1, 0));
    lem [B, Kp, R] f32 rescaled log emissions and skip [B, R] bool
    uninformative reads (lem_subset, or log of emat_read_from_bits);
    uniforms [n_its, B, R]; H0 [B, R] i32; first_read [B] i32; block_u
    [n_its, NBu, 3, B] and do_block [n_its] bool with smooth_w the
    on-the-fly boundary smoothing band, or without it boundaries [NBu] i32
    the static map's suffix starts, shared by every chain (a swap at one
    boundary leaves every later boundary's keep / swap weights unchanged,
    so the composed moves are the sequential static ones of
    quilt_tpu/kernels/gibbs_pallas.py:_block_moves_padded and, NIPT,
    nipt_block_within with one boundary row); words [B, Kp, G] i32 the packed
    subset words (gather_words) when the call is to return dosages;
    timed(name) a context manager timing the dosage pass and, for NIPT,
    the block moves and read classes, named `<section_prefix>:dosage_kernel`,
    `:block_move`, `:hclass` (the seek calls' "gibbs", the all-SNP call's
    "rare"); span(name) one that marks the
    call's other stretches without draining the device (the engine's
    SectionTimers.section: the slot emissions, the initial state, each
    sweep's slot words, forward, backward, diploid block move and
    per-iteration sums, the labels out), named `<span_prefix>.lem_pad`,
    `.init`, `.slots`, `.fwd`, `.bwd`, `.block`, `.per_it`, `.out` (the
    seek calls' "sweep", the all-SNP call's "rare"). NIPT only: resample_u
    [n_its, B, R] uniforms of the label resample that follows a block move
    (None: no resample), relabel_u [n_its, B] uniforms of an entire
    relabelling after every iteration (None: none; no engine asks for it)."""
    B, K, R = lem.shape
    G, W = layout.G, layout.W
    n_its = uniforms.shape[0]
    dev = lem.device
    valid = layout.valid
    untimed = lambda name: contextlib.nullcontext()
    timed = timed or untimed
    span = span or untimed
    # a timed section drains the device when it ends: the diploid block move
    # is a few small operations whose time that would distort, NIPT's move
    # and read classes are a large part of the call and are timed apart
    timed_nipt = timed if nl == 3 else untimed
    if nl == 3:
        prior, rlc, clp, perm_mask = nipt_tables_for(ff, dev)
    else:
        prior = (0.5, 0.5)
    with span(f"{span_prefix}.lem_pad"):
        # [G, W, B, K] float32 slot emissions; zeroed in place at empty slots
        b_idx = torch.arange(B, device=dev)
        lem_pad = lem.transpose(1, 2)[b_idx, layout.r_clip]
        lem_pad.masked_fill_(~valid[..., None], 0.0)
    with span(f"{span_prefix}.init"):
        skip_r = skip | ~layout.mask
        H_pad = layout.to_slots(H0.to(torch.int32), 0).to(torch.int32)
        skip_pad = layout.to_slots(skip_r.to(torch.int32), 1).to(torch.int32)
        live = valid & ~(skip_pad > 0)
        first_col = first_read.reshape(B, 1).to(torch.int32).contiguous()
        if iterative_init:
            lemg = torch.zeros((G, nl * B, K), dtype=torch.float32, device=dev)
        else:
            lemg = lemg_from_labels(H_pad, valid, lem_pad, nl)
        beta = torch.ones((G, nl * B, K), dtype=torch.float32, device=dev)
        alphas = None
        Hc_pad = torch.zeros((G, W, B), dtype=torch.int32, device=dev)
        uf = torch.zeros((B, 1), dtype=torch.float32, device=dev)
        lab = counts_of(H_pad, valid, nl)
        per_it = torch.zeros((n_its, B, len(PER_IT_COLS)), dtype=torch.float32, device=dev)
        log_prior = torch.log(torch.tensor(prior, device=dev))
    do_block = np.zeros(n_its, bool) if do_block is None else np.asarray(do_block, bool)
    NBu = 0 if block_u is None else block_u.shape[1]
    do_entire = nl == 3 and relabel_u is not None
    for it in range(n_its):
        it_mode = it if (iterative_init and it <= 1) else 2
        move = bool(do_block[it] and NBu > 0 and (smooth_w is not None or boundaries is not None))
        want_alpha = bool(do_block[it] or it == n_its - 1 or do_entire)
        with span(f"{span_prefix}.slots"):
            u_pad = layout.to_slots(uniforms[it].to(torch.float32), 0.0)
            slots = torch.stack([u_pad.view(torch.int32), H_pad, skip_pad, layout.r_pad],
                                1).contiguous()
        with span(f"{span_prefix}.fwd"):
            lemg, alphas, H_pad, logc, uf_it, lab = fwd_sweep(
                lemg, beta, lem_pad, slots, first_col, lab, trans,
                layout.cnt_max, nl=nl, K_real=K_real, it_mode=it_mode,
                prior=prior, want_alpha=want_alpha,
            )
        with span(f"{span_prefix}.bwd"):
            beta = bwd_sweep(lemg, trans, nl=nl, K_real=K_real)
        if nl == 3 and want_alpha:
            with timed_nipt(f"{section_prefix}:hclass"):
                Hc_pad = compute_hclass(alphas, beta, lem_pad, H_pad, live, prior, rlc)
        if move:
            with timed(f"{section_prefix}:block_move") if nl == 3 else span(f"{span_prefix}.block"):
                if smooth_w is not None:
                    rate2 = live_jump_rate(alphas, beta, lemg, trans, B, K_real,
                                           include3=nl == 2 or prior[2] > 0)
                    bnd_rb = boundaries_from_rate(rate2, smooth_w, NBu, quantile_prob)
                else:
                    bnd_rb = boundaries[:, None].expand(NBu, B)
                if nl == 3:
                    ru = None if resample_u is None else layout.to_slots(
                        resample_u[it].to(torch.float32), 0.0)
                    lemg, beta, alphas, H_pad, Hc_pad = nipt_block_within(
                        lemg, beta, H_pad, Hc_pad, valid, lem_pad, slots, first_col, trans,
                        bnd_rb, block_u[it], clp, perm_mask, rlc, K_real, resample_u_it=ru)
                else:
                    lemg, beta, alphas, H_pad = suffix_pair_composed(
                        lemg, beta, alphas, H_pad, bnd_rb, block_u[it, :, 0], B, K_real)
                    lemg, beta = lemg.contiguous(), beta.contiguous()
                lab = counts_of(H_pad, valid, nl)
        if do_entire:
            lemg, beta, alphas, H_pad, Hc_pad, chosen = entire_relabel(
                lemg, beta, alphas, H_pad, Hc_pad, valid, log_prior, relabel_u[it])
            lab = counts_of(H_pad, valid, nl)
        with span(f"{span_prefix}.per_it"):
            uf = torch.maximum(uf, uf_it)
            relabel = ((chosen + 1).to(torch.float32) if do_entire
                       else torch.ones((B,), dtype=torch.float32, device=dev))
            p_O_h = logc.reshape(nl, B).T                              # [B, nl]
            p_O = p_O_h.sum(1)
            p_H = (lab * log_prior[None, :]).sum(1)
            p_O3 = p_O_h[:, 2] if nl == 3 else torch.zeros_like(p_O)
            per_it[it] = torch.stack([
                p_O_h[:, 0], p_O_h[:, 1], p_O3, p_O, p_H,
                p_O + p_H, log_dmultinom(lab, prior), relabel,
            ], 1)

    def to_reads(x_pad):
        flat = x_pad.reshape(G * W, B).T                            # [B, G*W]
        return torch.where(layout.mask, flat.gather(1, layout.idx_back), 0).to(torch.int32)

    hap_dos = gp = gpF = None
    if words is not None:
        with timed(f"{section_prefix}:dosage_kernel"):
            hd = dosage_sweep(alphas.contiguous(), beta.contiguous(),
                              words.permute(2, 0, 1).contiguous(),
                              nl, K_real, ref_error)                # [G, nl*B, 32]
            hap_dos = hd.reshape(G, nl, B, 32).permute(2, 1, 0, 3).reshape(B, nl, G * 32)
            gp = _genotype_posterior(hap_dos[:, 0], hap_dos[:, 1])
            gpF = _genotype_posterior(hap_dos[:, 0], hap_dos[:, 2]) if nl == 3 else gp
    with span(f"{span_prefix}.out"):
        return GibbsCall(to_reads(H_pad), per_it, uf[:, 0] > 0, hap_dos, gp, gpF,
                         to_reads(Hc_pad))


def _genotype_posterior(h1, h2) -> torch.Tensor:
    """[B, 3, S] posterior of 0 / 1 / 2 alt alleles from two haplotype dosages."""
    return torch.stack([(1 - h1) * (1 - h2), h1 * (1 - h2) + (1 - h1) * h2, h1 * h2], 1)
