"""Plain reference of what a QUILT1 batch computes, written from the
method (Davies et al., Nat Genet 2021; QUILT's R sources) in NumPy and
plain PyTorch, with the precision as a parameter: float64 is the
reference, bfloat16 the control.

It works out again, from the benchmark's own inputs (the packed panel, the
SNP positions, the reads with their base qualities), everything the
program derives from them: the 32-SNP grids, the transitions, the read
emissions against each haplotype, the haploid genotype likelihoods of a
labelling, and the full-panel forward-backward over every haplotype of the
panel. It imports nothing of the program.

Two functions judge the program:

- `sweep_probabilities`: one Gibbs sweep of a set of chains, each of its
  own sample. Given the labels the chains held before the sweep and the
  labels the program drew (its state), it walks the reads in the sweep's order, gives for each
  read the probability of label 0 that the method assigns there, and then
  follows the program's draw (the sampler draws label 1 exactly when its
  uniform is at least that probability); it keeps the forward
  probabilities of each path after each grid.
- `fb_dosages`: the dosage of every SNP for each (chain, latent haplotype)
  row of a labelling, by the forward-backward over the whole panel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

SNPS_PER_GRID = 32


# ---------------------------------------------------------------------------
# Grids and transitions
# ---------------------------------------------------------------------------

def n_grids(nSNPs: int) -> int:
    return -(-nSNPs // SNPS_PER_GRID)


def transitions(pos: np.ndarray, config: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(stay, jump) [G] float64 into each grid. A grid's position is the
    midpoint of its first and last SNP; with no genetic map the distance is
    expRate cM a Mb; the recombination rate between grids is nGen * d / 100
    (d in cM), held between minRate and maxRate cM a Mb, and stay = e^-rate.
    Grid 0 has no predecessor (stay 0, jump 1)."""
    nSNPs = len(pos)
    G = n_grids(nSNPs)
    starts = np.arange(G) * SNPS_PER_GRID
    ends = np.minimum(starts + SNPS_PER_GRID, nSNPs) - 1
    L = ((pos[starts] + pos[ends]) // 2).astype(np.float64)
    cM = (L - L[0]) * float(config["expRate"]) / 1e6
    nGen = float(config["nGen"])
    dL = np.diff(L)
    rate = np.clip(nGen * np.diff(cM) / 100.0,
                   nGen * dL / 1e6 * (float(config["minRate"]) / 100.0),
                   nGen * dL / 1e6 * (float(config["maxRate"]) / 100.0))
    stay = np.zeros(G)
    jump = np.ones(G)
    stay[1:] = np.exp(-rate)
    jump[1:] = 1.0 - stay[1:]
    return stay, jump


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------

def base_probs(bq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(P(base | the read shows ref), P(base | it shows alt)) per base from
    the signed phred: a base read as the allele it shows with 1 - e, as
    any one of the three others with e / 3; quality 0 says nothing."""
    bq = np.asarray(bq, dtype=np.float64)
    e = 10.0 ** (-np.abs(bq) / 10.0)
    right, wrong = 1.0 - e, e / 3.0
    pR = np.where(bq < 0, right, wrong)
    pA = np.where(bq > 0, right, wrong)
    zero = bq == 0
    return np.where(zero, 0.25, pR), np.where(zero, 0.25, pA)


@dataclass
class SampleTables:
    """A sample's reads as the method uses them (read order: sorted by
    central grid, stable)."""

    u: np.ndarray          # int64 [nBases] SNP of each base
    read_of: np.ndarray    # int64 [nBases] read of each base
    lr: np.ndarray         # [nBases] log P(base | haplotype carries ref), ref_error mixed in
    la: np.ndarray         # [nBases] ... carries alt
    lpr: np.ndarray        # [nBases] log P(base | ref) (0 at quality 0): genotype likelihoods
    lpa: np.ndarray
    grid: np.ndarray       # int64 [nReads] central grid
    starts: np.ndarray     # int64 [nReads] first base of each read
    n_reads: int


def sample_tables(u: np.ndarray, bq: np.ndarray, offsets: np.ndarray,
                  ref_error: float) -> SampleTables:
    """The per-base log terms of one sample's reads (u, bq, offsets in the
    benchmark's read order). A read's central grid is the grid of its
    median SNP."""
    n = len(offsets) - 1
    lens = np.diff(offsets)
    read_of = np.repeat(np.arange(n), lens)
    pR, pA = base_probs(bq)
    lr = np.log(pR * (1 - ref_error) + pA * ref_error)
    la = np.log(pA * (1 - ref_error) + pR * ref_error)
    zero = np.asarray(bq) == 0
    lpr = np.where(zero, 0.0, np.log(np.maximum(pR, 1e-30)))
    lpa = np.where(zero, 0.0, np.log(np.maximum(pA, 1e-30)))
    mid = np.asarray(u, dtype=np.int64)[offsets[:-1] + (lens - 1) // 2]
    return SampleTables(u=np.asarray(u, dtype=np.int64), read_of=read_of, lr=lr, la=la,
                        lpr=lpr, lpa=lpa, grid=mid // SNPS_PER_GRID,
                        starts=np.asarray(offsets[:-1], dtype=np.int64), n_reads=n)


def read_log_emissions(t: SampleTables, rhb: np.ndarray, haps: np.ndarray,
                       max_diff: float, device="cpu", as_numpy: bool = True):
    """(lem [H, nReads], skip [nReads]) float64 for haplotypes haps [H]: the
    log probability of each read given each haplotype, less its largest
    over the haplotypes and held at or above -log(max_diff) (the method's
    maxDifferenceBetweenReads), and the reads that no haplotype tells apart
    (every haplotype the same probability). Worked on `device`; NumPy
    arrays, or the device's tensors where not as_numpy."""
    dev = torch.device(device)
    words = torch.as_tensor(rhb[haps].view(np.int32), device=dev)          # [H, G]
    u = torch.as_tensor(t.u, device=dev)
    bits = ((words[:, u >> 5] >> (u & 31).to(torch.int32)) & 1).to(torch.float64)
    lr = torch.as_tensor(t.lr, device=dev)
    per_base = lr + bits * (torch.as_tensor(t.la, device=dev) - lr)        # [H, nBases]
    le = torch.zeros((len(haps), t.n_reads), dtype=torch.float64, device=dev)
    le.index_add_(1, torch.as_tensor(t.read_of, device=dev), per_base)
    mx = le.amax(0, keepdim=True)
    skip = (mx - le.amin(0, keepdim=True))[0] <= 1e-9
    lem = torch.clamp(le - mx, min=-math.log(max_diff))
    return (lem.cpu().numpy(), skip.cpu().numpy()) if as_numpy else (lem, skip)


# ---------------------------------------------------------------------------
# One Gibbs sweep
# ---------------------------------------------------------------------------

def sweep_probabilities(tables: Sequence[SampleTables], rhb: np.ndarray, haps: np.ndarray,
                        labels_in: Sequence[np.ndarray], labels_out: Sequence[np.ndarray],
                        stay: np.ndarray, jump: np.ndarray, first_sweep: bool,
                        max_diff: float, prior=(0.5, 0.5), dtype=torch.float64,
                        device="cpu") -> Dict:
    """One forward sweep of N chains, chain i over the reads tables[i] of
    its own sample and its own haplotypes haps[i] [K] (panel indices), with
    the labels labels_in[i] [nReads_i] it held before the sweep and the
    labels labels_out[i] the program drew.

    The latent haplotype h of a chain is a copying path through its K
    haplotypes; grid g emits the product of the emissions of the reads of
    grid g labelled h. The backward probabilities come from labels_in (all
    ones on the first sweep of a call, which has none yet). The forward
    sweep walks the grids; at each read of the grid, in order, with its
    current label c and alpha_h, beta_h at the grid (alpha holding the
    grid's emissions):
        w_c     = prior_c * S_0 * S_1,         S_h = sum alpha_h beta_h
        w_n     = prior_n * G_n * L_c (n != c), G_n = sum alpha_n beta_n e,
                                                L_c = sum alpha_c beta_c / e
    and P(label 0) = w_0 / (w_0 + w_1). Then the read takes the program's
    label, which moves its emission from one path to the other, and the
    chain's forward probabilities are normalised again. The chains walk
    together, the j-th read of each chain's grid at one step; a chain with
    fewer reads in the grid waits.

    Worked on `device` in `dtype`. Returns {"p0": [nReads_i] of each chain
    (NaN at the reads its haplotypes do not tell apart, which the sampler
    never moves), "alphas": [G, N, nl, K] each path's forward probabilities
    after the grid's reads, normalised}."""
    N, K = haps.shape
    G = len(stay)
    nl = 2
    dev = torch.device(device)
    n_r = [t.n_reads for t in tables]
    R = max(n_r) + 1                       # read R - 1: no read (emission 1, never live)
    lem = torch.zeros((N, R, K), dtype=torch.float64, device=dev)
    skip = torch.ones((N, R), dtype=torch.bool, device=dev)
    lab_in = torch.zeros((N, R), dtype=torch.int64, device=dev)
    lab_out = torch.zeros((N, R), dtype=torch.int64, device=dev)
    grid = torch.zeros((N, R), dtype=torch.int64, device=dev)
    first = np.zeros((N, G), np.int64)
    count = np.zeros((N, G), np.int64)
    for i, t in enumerate(tables):
        # a read no haplotype of a chain tells apart is no step of that chain
        le, sk = read_log_emissions(t, rhb, haps[i], max_diff, dev, as_numpy=False)
        n = t.n_reads
        lem[i, :n] = le.T
        skip[i, :n] = sk
        lab_in[i, :n] = torch.as_tensor(np.asarray(labels_in[i], np.int64), device=dev)
        lab_out[i, :n] = torch.as_tensor(np.asarray(labels_out[i], np.int64), device=dev)
        grid[i, :n] = torch.as_tensor(t.grid, device=dev)
        count[i] = np.bincount(t.grid, minlength=G)[:G]
        first[i, 1:] = np.cumsum(count[i])[:-1]
    valid = torch.arange(R, device=dev)[None, :] < torch.as_tensor(n_r, device=dev)[:, None]
    # grid emissions of each path from the labels before the sweep
    lemg = torch.zeros((N, nl, G, K), dtype=dtype, device=dev)
    flat = (torch.arange(N, device=dev)[:, None] * G + grid).reshape(-1)
    lem_t = lem.to(dtype)
    del lem
    for h in range(nl):
        w = ((lab_in == h) & valid).to(dtype)
        acc = torch.zeros((N * G, K), dtype=dtype, device=dev)
        acc.index_add_(0, flat, (lem_t * w[..., None]).reshape(N * R, K))
        lemg[:, h] = acc.reshape(N, G, K)
    # each read's emission and its inverse, [N, R, K, 2]
    E = torch.exp(lem_t)
    EI = torch.stack([E, 1.0 / E], -1)
    st = torch.as_tensor(stay, dtype=dtype, device=dev)
    jp = torch.as_tensor(jump, dtype=dtype, device=dev)

    def grid_e(g):
        x = lemg[:, :, g]
        return torch.exp(x - x.amax(-1, keepdim=True))

    beta = torch.ones((N, nl, G, K), dtype=dtype, device=dev)
    if not first_sweep:
        b = torch.ones((N, nl, K), dtype=dtype, device=dev)
        for g in range(G - 2, -1, -1):
            eb = grid_e(g + 1) * b
            b = st[g + 1] * eb + jp[g + 1] / K * eb.sum(-1, keepdim=True)
            b = b / b.amax(-1, keepdim=True)
            beta[:, :, g] = b
    p0 = torch.full((N, R), float("nan"), dtype=torch.float64, device=dev)
    pri = [float(x) for x in prior]
    rows = torch.arange(N, device=dev)
    first_t = torch.as_tensor(first, device=dev)
    count_t = torch.as_tensor(count, device=dev)
    alpha = torch.zeros((N, nl, K), dtype=dtype, device=dev)
    alphas = torch.empty((G, N, nl, K), dtype=dtype, device=dev)
    for g in range(G):
        e = grid_e(g)
        a = e / K if g == 0 else e * (st[g] * alpha + jp[g] / K)
        alpha = a / a.sum(-1, keepdim=True)
        bg = beta[:, :, g]
        for j in range(int(count[:, g].max())):
            r = torch.where(j < count_t[:, g], first_t[:, g] + j, R - 1)
            EIr = EI[rows, r]                                         # [N, K, 2]
            ab = alpha * bg
            S = ab.sum(-1).to(torch.float64)                          # [N, 2]
            GL = torch.bmm(ab, EIr).to(torch.float64)                 # [N, 2, (gain, lose)]
            cur, new = lab_in[rows, r], lab_out[rows, r]
            Lcur = GL[rows, cur, 1]
            # w in the reference's precision: the control rounds it too
            w = torch.stack([torch.where(cur == n, pri[n] * S[:, 0] * S[:, 1],
                                         pri[n] * GL[:, n, 0] * Lcur) for n in range(nl)], 1)
            w = w.to(dtype).to(torch.float64)
            live = ~skip[rows, r]
            p0[rows, r] = torch.where(live, w[:, 0] / w.sum(1), p0[rows, r])
            move = live & (new != cur)
            # remove the read from its old path, add it to the new one
            f = torch.ones((N, nl, K), dtype=dtype, device=dev)
            f[rows, cur] = torch.where(move[:, None], EIr[..., 1], f[rows, cur])
            f[rows, new] = torch.where(move[:, None], EIr[..., 0], f[rows, new])
            moved = alpha * f
            alpha = torch.where(move[:, None, None], moved / moved.sum(-1, keepdim=True), alpha)
        alphas[g] = alpha
    p0 = p0.cpu().numpy()
    return {"p0": [p0[i, :n] for i, n in enumerate(n_r)], "alphas": alphas}


def control_draws(p0: np.ndarray, u: np.ndarray, labels_in: np.ndarray) -> np.ndarray:
    """The labels a sampler computing p0 [C, nReads] draws with the
    uniforms u: label 1 exactly when u >= p0; a read it cannot tell apart
    (NaN) keeps its label."""
    return np.where(np.isnan(p0), labels_in, np.asarray(u, dtype=np.float64) >= p0).astype(np.int64)


def decision_gaps(drawn: np.ndarray, labels_in: np.ndarray, u: np.ndarray,
                  p_ref: np.ndarray) -> np.ndarray:
    """The gap of each read's draw [C, nReads] against the reference's
    P(label 0) p_ref: 0 where the draw is the one u gives (label 1 exactly
    when u >= p_ref), else how far the uniform lies from p_ref, the least
    change of P(label 0) that would make the draw right. A read the
    reference cannot tell apart (NaN) must keep its label: gap 1 if it
    moved."""
    u = np.asarray(u, dtype=np.float64)
    drawn = np.asarray(drawn, dtype=np.int64)
    with np.errstate(invalid="ignore"):
        want = (u >= p_ref).astype(np.int64)
    gap = np.where(drawn != want, np.abs(u - p_ref), 0.0)
    return np.where(np.isnan(p_ref), (drawn != np.asarray(labels_in)).astype(np.float64), gap)


# ---------------------------------------------------------------------------
# Genotype likelihoods and the full-panel forward-backward
# ---------------------------------------------------------------------------

def haploid_gls(t: SampleTables, labels: np.ndarray, nSNPs: int, min_gl: float,
                nl: int = 2, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """[C * nl, 2, nSNPs] likelihoods of allele 0 / 1 of each latent
    haplotype from the bases of the reads labelled with it (labels [C,
    nReads]); a SNP where either is below min_gl is rescaled to max 1 and
    held at min_gl."""
    C = labels.shape[0]
    lab = np.asarray(labels, dtype=np.int64)[:, t.read_of]          # [C, nBases]
    rows = (np.arange(C)[:, None] * nl + lab).ravel()
    dev = torch.device(device)
    logg = torch.zeros((C * nl, 2, nSNPs), dtype=dtype, device=dev)
    idx_r = torch.as_tensor(rows, device=dev)
    idx_s = torch.as_tensor(np.tile(t.u, C), device=dev)
    for a, lp in ((0, t.lpr), (1, t.lpa)):
        vals = torch.as_tensor(np.tile(lp, C), dtype=dtype, device=dev)
        logg[:, a].index_put_((idx_r, idx_s), vals, accumulate=True)
    gl = torch.exp(logg)
    hi = gl.amax(1, keepdim=True)
    low = (gl < min_gl).any(1, keepdim=True)
    return torch.where(low, torch.clamp(gl / hi, min=min_gl), gl)


def panel_words_T(rhb: np.ndarray, device) -> torch.Tensor:
    """The packed panel [K, G] as [G, K] int32 words on `device`: a grid's
    words contiguous."""
    return torch.as_tensor(np.ascontiguousarray(rhb.T).view(np.int32), device=device)


def fb_dosages(gl: torch.Tensor, words_T: torch.Tensor, stay: np.ndarray, jump: np.ndarray,
               ref_error: float, nSNPs: int, dtype=torch.float64,
               block_bytes: float = None) -> torch.Tensor:
    """Dosage [rows, nSNPs] (float64) of each row of gl [rows, 2, nSNPs] by
    the forward-backward over all K haplotypes of the panel (words_T [G, K]
    int32 on the device): a haplotype at grid g emits prod_s P(gl | its
    allele), P = (1 - eps) for its own allele's likelihood and eps for the
    other's (eps = ref_error); the path jumps into grid g with jump_g, to
    any haplotype alike; gamma = alpha beta normalised; dosage = eps +
    (1 - 2 eps) sum_k gamma_k allele_k. Rows run in blocks whose stored
    alphas fit block_bytes (default: half the device's free memory)."""
    dev = words_T.device
    G, K = words_T.shape
    eps = float(ref_error)
    g0, g1 = gl[:, 0].to(torch.float64), gl[:, 1].to(torch.float64)
    t0 = (g0 * (1 - eps) + g1 * eps).to(dtype)
    t1 = (g0 * eps + g1 * (1 - eps)).to(dtype)
    dl = torch.log(t1) - torch.log(t0)
    pad = G * SNPS_PER_GRID - nSNPs
    if pad:
        dl = torch.nn.functional.pad(dl, (0, pad))
    st = torch.as_tensor(stay, dtype=dtype, device=dev)
    jp = torch.as_tensor(jump, dtype=dtype, device=dev)
    sh = torch.arange(SNPS_PER_GRID, device=dev, dtype=torch.int32)
    elem = torch.finfo(dtype).bits // 8
    if block_bytes is None:
        block_bytes = (torch.cuda.mem_get_info(dev)[0] / 2 if dev.type == "cuda" else 2e9)
    rb = max(1, int(block_bytes // (G * K * elem)))
    out = torch.empty((gl.shape[0], G * SNPS_PER_GRID), dtype=torch.float64, device=dev)

    def bits(g):
        return ((words_T[g][None, :] >> sh[:, None]) & 1).to(dtype)     # [32, K]

    def emis(d, bg):
        x = d @ bg                                                       # [rows, K]
        return torch.exp(x - x.amax(1, keepdim=True))

    for r0 in range(0, gl.shape[0], rb):
        d = dl[r0:r0 + rb]
        n = d.shape[0]
        alphas = torch.empty((G, n, K), dtype=dtype, device=dev)
        alpha = None
        for g in range(G):
            e = emis(d[:, g * 32:(g + 1) * 32], bits(g))
            a = e / K if g == 0 else e * (st[g] * alpha + jp[g] / K)
            alpha = a / a.sum(1, keepdim=True)
            alphas[g] = alpha
        beta = torch.ones((n, K), dtype=dtype, device=dev)
        for g in range(G - 1, -1, -1):
            bg = bits(g)
            gam = alphas[g] * beta
            gam = gam / gam.sum(1, keepdim=True)
            out[r0:r0 + n, g * 32:(g + 1) * 32] = (
                eps + (1 - 2 * eps) * (gam @ bg.T)).to(torch.float64)
            if g:
                eb = emis(d[:, g * 32:(g + 1) * 32], bg) * beta
                beta = st[g] * eb + jp[g] / K * eb.sum(1, keepdim=True)
                beta = beta / beta.amax(1, keepdim=True)
        del alphas
    return out[:, :nSNPs]
