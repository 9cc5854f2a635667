"""NIPT (triploid) label machinery shared by the Gibbs call and its oracles:
the port's own copy of quilt_tpu/kernels/nipt.py (NumPy only).

Functional equivalents of the reference's H_class / relabelling machinery:

- relabel permutation tables (reference: reorderX tables in
  rcpp_consider_and_try_entire_relabelling, QUILT/src/gibbs-nipt.cpp:1553-1577,
  and the rr/rr0 tables threaded through gibbs-nipt-block.cpp);
- `make_rlc`: the 7 read-label-class probability rows (QUILT/R/gibbs-nipt.R:
  1960-1974); classes are 1=mat-transmitted only, 2=mat-untransmitted,
  3=fetal, 4/5/6=pairwise-ambiguous ({1,2},{1,3},{2,3}), 7=uninformative,
  0=unclassified;
- `class_log_p`: per-class marginal label probability used by the block
  relabelling acceptance (rcpp_get_log_p_H_class2,
  QUILT/src/gibbs-nipt-block.cpp:168-209);
- read classification against rlc with class_sum_cutoff=0.06
  (QUILT/R/gibbs-nipt.R:845-860). DOCUMENTED DEVIATION: the reference
  classifies each read from the sampler state at the moment the read is
  resampled mid-sweep; here (kernel AND oracle, so the two-oracle tests
  stay exact) classification uses the end-of-iteration alpha/beta state,
  fully batched -- same stationary distribution, TPU-parallel;
- 6-permutation choice probabilities for block relabelling
  (Rcpp_consider_block_relabelling, gibbs-nipt-block.cpp:590-954, with the
  default block_approach=6 H_class read term) and for entire relabelling
  (get_weights_for_entire_relabelling, gibbs-nipt.R:1336-1352).

Permutation convention: relabel index r in 0..5 corresponds to the
reference's 1-based relabel 1..6. PERMS[r, h] is the NEW label of a read
currently labelled h; INVS[r, i] is the OLD latent-hap slot whose state
planes (alpha/beta/eMatGrid) move into slot i (new_plane[i] =
old_plane[INVS[r, i]]); CLASS_PERM[r, c] is the new H_class of a read of
class c.
"""
from __future__ import annotations

import numpy as np

CLASS_SUM_CUTOFF = 0.06

# reorderX tables, 0-based (gibbs-nipt.cpp:1566-1571)
PERMS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 0, 2], [2, 0, 1], [1, 2, 0], [2, 1, 0]],
    dtype=np.int32,
)
INVS = np.stack([np.argsort(p) for p in PERMS]).astype(np.int32)

# class mapping under each relabel: singleton classes follow PERMS; the
# pairwise-ambiguous class excluding singleton cbar is 7-cbar and maps to
# 7-PERMS(cbar); classes 0 and 7 are invariant.
CLASS_PERM = np.zeros((6, 8), dtype=np.int32)
for _r in range(6):
    CLASS_PERM[_r, 0] = 0
    CLASS_PERM[_r, 7] = 7
    for _c in (1, 2, 3):
        CLASS_PERM[_r, _c] = PERMS[_r, _c - 1] + 1
        CLASS_PERM[_r, 7 - _c] = 7 - (PERMS[_r, _c - 1] + 1)
del _r, _c

# S3 composition table: MUL[a, b] = index of "apply relabel b, then
# relabel a" (labels h -> PERMS[a][PERMS[b][h]]). Used by the composed
# suffix-move formulation, which samples each boundary's relabelling with
# junction statistics gathered from the ORIGINAL (pre-move) state and
# composes the accepted permutations, applying them to the big state
# arrays once instead of once per boundary.
MUL = np.zeros((6, 6), dtype=np.int32)
for _a in range(6):
    for _b in range(6):
        _composed = PERMS[_a][PERMS[_b]]
        MUL[_a, _b] = int(
            np.flatnonzero((PERMS == _composed[None]).all(axis=1))[0]
        )
del _a, _b, _composed

# inverse class maps: CLASS_PERM_INV[r, c] = the ORIGINAL class of a read
# whose class after relabel r is c (rows of CLASS_PERM are bijections)
CLASS_PERM_INV = np.stack(
    [np.argsort(row) for row in CLASS_PERM]
).astype(np.int32)


def nipt_prior(ff: float) -> np.ndarray:
    return np.array([0.5, (1.0 - ff) / 2.0, ff / 2.0], dtype=np.float64)


def make_rlc(ff: float) -> np.ndarray:
    """[7, 3] expected label-probability vector of each read class
    (reference: make_rlc, gibbs-nipt.R:1960-1974)."""
    p = nipt_prior(ff)
    rlc = np.zeros((7, 3), dtype=np.float64)
    rlc[0] = (1, 0, 0)
    rlc[1] = (0, 1, 0)
    rlc[2] = (0, 0, 1)
    rlc[3] = (p[0] / (p[0] + p[1]), p[1] / (p[0] + p[1]), 0)
    rlc[4] = (p[0] / (p[0] + p[2]), 0, p[2] / (p[0] + p[2]))
    rlc[5] = (0, p[1] / (p[1] + p[2]), p[2] / (p[1] + p[2]))
    rlc[6] = p
    return rlc


def class_log_p(ff: float) -> np.ndarray:
    """[8] log marginal probability per class, indices 0..7; the ff==0 /
    ff==1 guards substitute log(0.001) for the impossible singleton
    (reference: rcpp_get_log_p_H_class2, gibbs-nipt-block.cpp:168-209)."""
    v = np.zeros(8, dtype=np.float64)
    v[1] = np.log(0.5)
    v[2] = np.log(0.001) if ff >= 1.0 else np.log(0.5 - ff * 0.5)
    v[3] = np.log(0.001) if ff <= 0.0 else np.log(ff * 0.5)
    v[4] = np.log(1.0 - ff * 0.5)
    v[5] = np.log(0.5 + ff * 0.5)
    v[6] = np.log(0.5)
    return v


# ---------------------------------------------------------------------------
# numpy flavors (oracle)
# ---------------------------------------------------------------------------


def classify_read_np(
    gain: np.ndarray,   # [3] sum_k alpha_h beta_h em
    lose_C: float,      # sum_k alpha_C beta_C / em
    pC: np.ndarray,     # [3] sum_k alpha_h beta_h
    h_cur: int,
    prior: np.ndarray,
    rlc: np.ndarray,
    cutoff: float = CLASS_SUM_CUTOFF,
) -> int:
    """Classify one read from its label-move probabilities
    (reference: gibbs-nipt.R:845-860)."""
    w = np.empty(3, dtype=np.float64)
    for n in range(3):
        if n == h_cur:
            w[n] = pC[0] * pC[1] * pC[2]
        else:
            m = 3 - h_cur - n
            w[n] = lose_C * gain[n] * pC[m]
        w[n] *= prior[n]
    s = w.sum()
    if not np.isfinite(s) or s <= 0:
        return 0
    x = w / s
    y = np.abs(rlc - x[None, :]).sum(axis=1)
    c = int(np.argmin(y))
    return c + 1 if y[c] < cutoff else 0


def perm_choice_probs_np(
    cmat: np.ndarray,      # [3, 3] cmat[i, j] = sum_k alpha_i beta_j
    ns: np.ndarray,        # [8] class counts in the relabelled range
    ff: float,
) -> np.ndarray:
    """[6] normalized probability of each suffix relabelling (reference:
    Rcpp_consider_block_relabelling, gibbs-nipt-block.cpp:660-735, with the
    block_approach=6 H_class term)."""
    clp = class_log_p(ff)
    lw = np.zeros(6, dtype=np.float64)
    for r in range(6):
        for i in range(3):
            lw[r] += np.log(max(cmat[i, INVS[r, i]], 1e-300))
        for c in range(1, 7):
            # reference pairing: count of the class that MAPS TO c times
            # clp[c] (rcpp_calculate_block_read_label_probabilities_using_
            # H_class, gibbs-nipt-block.cpp:252-281: n_j = ns[rr(ir,j)];
            # differs from ns[c]*clp[CLASS_PERM[c]] for the two 3-cycles)
            lw[r] += ns[CLASS_PERM[r, c]] * clp[c]
    lw -= lw.max()
    lw = np.clip(lw, -100.0, None)
    w = np.exp(lw)
    if ff <= 0.0:
        w[[1, 3, 4, 5]] = 0.0   # only identity and the 1<->2 swap possible
    return w / w.sum()


def entire_relabel_probs_np(rc: np.ndarray, ff: float) -> np.ndarray:
    """[6] normalized probability of each entire relabelling from label
    counts rc (reference: get_weights_for_entire_relabelling,
    gibbs-nipt.R:1336-1352)."""
    p = nipt_prior(ff)
    logp = np.log(np.maximum(p, 1e-300))
    lw = np.array(
        [sum(rc[INVS[r, i]] * logp[i] for i in range(3)) for r in range(6)],
        dtype=np.float64,
    )
    lw -= lw.max()
    w = np.exp(np.clip(lw, -100.0, None))
    return w / w.sum()


def sample_index_np(probs: np.ndarray, u: float) -> int:
    return min(int(np.searchsorted(np.cumsum(probs), u, side="right")),
               len(probs) - 1)


def log_dmultinom_np(rc: np.ndarray, p: np.ndarray) -> float:
    """log multinomial pmf (reference: calc_prob_of_set_of_reads,
    gibbs-nipt.R:1308-1312)."""
    from scipy.special import gammaln

    rc = np.asarray(rc, dtype=np.float64)
    n = rc.sum()
    logp = np.log(np.maximum(p, 1e-300))
    return float(
        gammaln(n + 1) - gammaln(rc + 1).sum()
        + np.where(rc > 0, rc * logp, 0.0).sum()
    )
