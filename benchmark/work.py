"""The least time the card could take for a batch's Gibbs sweeps and
full-panel FB, counted from the algorithm's own sizes: grids, chain rows,
the haplotypes of a Gibbs subset and of the panel, the reads the benchmark
made, and the configuration's schedule of seek iterations and sweeps.
Nothing here reads the program's tensors, padding or launch arguments.

The formulas are frozen copies of chip_smoke.py's `_fwd_work`, `_bwd_work`
and `_bound` and of its fused-FB counts, rewritten over sizes:
`benchmark/tests/test_bm_work.py` holds them equal to chip_smoke.py's at
its timing shapes (where the padded sizes are passed in). The benchmark
passes the real sizes: K_pad = K, one slot a read.

Peaks: the published NVIDIA H100 SXM figures, HBM3 3.35 TB/s and 67
TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time: bytes over the HBM rate or operations over the
    float32 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def fwd_sweep_work(G: int, B: int, nl: int, K: int, n_slots: int, n_live: int,
                   want_alpha: bool = True, K_pad: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) of one forward Gibbs sweep of B chains (nl latent
    rows each) over K haplotypes: lemg read and written, beta read, the
    slots' four words (uniform, label, skip, read) read and the labels
    written, the alphas written where the sweep keeps them, the emissions
    of the live reads at the K haplotypes, and the small per-chain rows.
    Operations: ~8 a (grid, row, haplotype) for the emission and alpha
    step, ~6 a (live read, latent row, haplotype) for the relabelling."""
    Kp = K if K_pad is None else K_pad
    BN = B * nl
    plane = G * BN * Kp * F32
    # first read, label counts, transitions, reads a grid
    small = B * F32 + B * nl * F32 + 2 * G * F32 + G * F32
    outs_small = BN * F32 + B * F32 + B * nl * F32                   # logc, underflow, counts
    nbytes = (plane + 4 * n_slots * F32 + small                      # lemg, slots, small inputs
              + plane + (G if want_alpha else 1) * BN * Kp * F32     # lemg', alphas
              + n_slots * F32 + outs_small                           # labels, small outputs
              + G * BN * K * F32 + n_live * K * F32)                 # beta, live emissions
    return nbytes, 8 * G * BN * K + 6 * nl * n_live * K


def bwd_sweep_work(G: int, BN: int, K: int, K_pad: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) of one backward sweep over BN state rows: lemg
    at the K haplotypes, the transitions, beta written; ~8 operations a
    (grid, row, haplotype)."""
    Kp = K if K_pad is None else K_pad
    return G * BN * K * F32 + 2 * G * F32 + G * BN * Kp * F32, 8 * G * BN * K


def fb_forward_work(rows: int, G: int, K: int, K_pad: Optional[int] = None,
                    ckpt_bytes: int = 0) -> Tuple[int, int]:
    """(bytes, operations) of the full-panel forward of `rows` rows: the
    log-ratios [rows, 32 G], the packed words [G, K], the transitions, the
    stored checkpoints (none in the algorithm's own count) and the
    log-likelihoods; 40 operations a (row, grid, haplotype): 32 for the
    emission sum, ~8 for the alpha step and its normalisation."""
    Kp = K if K_pad is None else K_pad
    return (rows * 32 * G * F32 + G * Kp * F32 + 2 * G * F32 + ckpt_bytes + rows * F32,
            40 * rows * G * K)


def fb_backward_work(rows: int, G: int, K: int, K_top: int, K_pad: Optional[int] = None,
                     ckpt_bytes: int = 0, remat: bool = True) -> Tuple[int, int]:
    """(bytes, operations) of the full-panel backward: the log-ratios, the
    words, the checkpoints, the transitions and thinning flags read; the
    dosages [rows, 32 G] and the top-K lists [G, rows, K_top] (values and
    indices) written. Operations a (row, grid, haplotype): 32 for the
    dosage, ~12 for beta and gamma, and with `remat` the forward's 40 again
    (the fused kernel rebuilds its alphas; the algorithm need not)."""
    Kp = K if K_pad is None else K_pad
    nbytes = (rows * 32 * G * F32 + G * Kp * F32 + ckpt_bytes + 2 * G * F32 + G * F32
              + rows * 32 * G * F32 + 2 * G * rows * K_top * F32)
    return nbytes, ((40 if remat else 0) + 44) * rows * G * K


def batch_work(sizes: Dict) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) of one batch's Gibbs sweeps and full-panel FB
    from the cell's sizes: samples S, chains C, latent rows nl, grids G,
    the Gibbs subset Ksub, the panel K, sweeps a call n_its, of which
    n_alpha keep their alphas, Gibbs (and FB) calls a batch n_calls, the
    reads of the batch's samples, K_top."""
    S, C, nl, G = sizes["S"], sizes["C"], sizes["nl"], sizes["G"]
    B = S * C
    reads = sizes["reads"] * C                    # every chain steps through its sample's reads
    n_its, n_alpha, n_calls = sizes["n_its"], sizes["n_alpha"], sizes["n_calls"]
    gib_b = gib_f = 0.0
    for want_alpha, n in ((True, n_alpha), (False, n_its - n_alpha)):
        fb_, ff_ = fwd_sweep_work(G, B, nl, sizes["Ksub"], reads, reads, want_alpha)
        bb_, bf_ = bwd_sweep_work(G, B * nl, sizes["Ksub"])
        gib_b += n * (fb_ + bb_)
        gib_f += n * (ff_ + bf_)
    rows = B * nl
    fwd_b, fwd_f = fb_forward_work(rows, G, sizes["K"])
    bwd_b, bwd_f = fb_backward_work(rows, G, sizes["K"], sizes["K_top"], remat=False)
    # the FB as one function reads its inputs (log-ratios, words, transitions) once
    fb_b = fwd_b + bwd_b - (rows * 32 * G + G * sizes["K"] + 2 * G) * F32
    return {"gibbs": (n_calls * gib_b, n_calls * gib_f),
            "fb": (n_calls * fb_b, n_calls * (fwd_f + bwd_f))}
