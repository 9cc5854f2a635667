"""What decides `correct` in a QUILT1 cell: the program's output and state
from the last batch of the window, held against the plain reference
(reference/hmm.py).

Three numbers, each with the limit the configuration's file states
(`limits`), compared once the window has closed:

- `sweep_alpha_gap`: a Gibbs sampler draws, so no reference reproduces
  its labels; it can only follow the program's own state. For a few
  forward sweeps chosen from the seed among those that keep their forward
  probabilities (the block-move sweeps and each call's last), and
  N_SWEEP_ROWS chains chosen from the seed across the whole batch (one
  chain of as many samples as there are rows, more chains of each where
  the batch has fewer samples), the reference works out, from the labels
  the chains held before the sweep, its own read emissions, transitions
  and backward probabilities and the program's uniforms, each read's
  P(label 0), follows the label the program drew, and keeps each path's
  forward probabilities after each grid. The number is the median, over
  the kept (sweep, chain, path) rows, of each row's largest |program -
  reference| probability: in float32 a row now and then loses a
  haplotype's weight to the exponent's range where the reads of one grid
  disfavour it and are then relabelled away, which float64 keeps, so the
  largest over the rows swings with those rows (PERF.md: the float32
  reference and the bfloat16 control, which share float32's exponent,
  side with the program there). The largest is logged.
- `wrong_draw_share`: of the draws of those sweeps and chains, the share
  the program drew otherwise than the reference's P(label 0) gives with
  the program's own uniform (label 1 exactly where u >= P(label 0)), or
  that it holds in another grid than the reference. This is the
  sampler's decision, where the backward probabilities and the prior
  enter: the forward probabilities alone follow the program's draws. At
  MIN_DRAWS draws or more one wrong draw, which float32's exponent range
  can make on a sound run, reads under 3.4e-6.
- `dosage_gap`: from the labels each full-panel FB call started from (the
  program's Gibbs state), the reference works out the genotype likelihoods
  and the forward-backward over every haplotype of the panel, and
  averages the dosages over chains and post-burn-in seek iterations as
  the method does. The number is the largest |program - reference| over
  every SNP of every sample of the batch.

The control (`control.py`) computes the same numbers with the reference in
bfloat16 in the program's place.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .reference import hmm

N_SWEEPS = 3
N_SWEEP_ROWS = 16
MIN_DRAWS = 300_000


def plan(seed: int, impute: Dict, S: int, reads_per_sample: float) -> Dict:
    """The sweeps and chains the sweep check keeps, drawn from the seed:
    N_SWEEPS (Gibbs call, sweep) pairs among the sweeps that keep their
    forward probabilities (before each block move, and a call's last) whose
    state the reference can rebuild (not the first call's two initialising
    sweeps, nor a sweep right after a block move), and N_SWEEP_ROWS chain
    rows (sample * C + chain), or as many more as MIN_DRAWS draws take at
    the mix's reads a sample, spread over the batch's S samples: the
    samples in an order drawn from the seed, one chain each, then a second
    chain each, and so on."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 20])
    n_calls = 2 * int(impute["n_seek_its"])
    n_its = int(impute["small_ref_panel_gibbs_iterations"]) + 1
    blocks = {int(b) for b in impute.get("small_ref_panel_block_gibbs_iterations", [3, 6, 9])}
    keep_alpha = {b - 1 for b in blocks if 1 <= b <= n_its} | {n_its - 1}
    ok = [(c, it) for c in range(n_calls) for it in sorted(keep_alpha)
          if it not in blocks and not (c == 0 and it < 2)]
    pick = rng.choice(len(ok), size=min(N_SWEEPS, len(ok)), replace=False)
    C = int(impute["nGibbsSamples"])
    order = rng.permutation(S)
    chains = np.argsort(rng.random((S, C)), axis=1)         # a chain order for each sample
    n = min(max(N_SWEEP_ROWS, -(-MIN_DRAWS // max(int(N_SWEEPS * reads_per_sample), 1))), S * C)
    rows = sorted(int(order[i % S]) * C + int(chains[order[i % S], i // S]) for i in range(n))
    return {"sweeps": [ok[i] for i in sorted(pick)], "rows": rows}


def _sweep_reads(rec: Dict, j: int, n_reads: int):
    """Per-read (labels before, uniforms, labels drawn, the grid of each
    slot's read) of kept row j of a sweep record, from its slots."""
    slots, h_out = rec["slots"][j], rec["h_out"][j]           # [G, 4, W], [G, W]
    r_pad = slots[:, 3]
    g_of_slot = np.broadcast_to(np.arange(r_pad.shape[0])[:, None], r_pad.shape)
    live = r_pad >= 0
    r = r_pad[live]
    lab_in = np.zeros(n_reads, np.int64)
    lab_out = np.zeros(n_reads, np.int64)
    u = np.zeros(n_reads, np.float64)
    grid = np.full(n_reads, -1, np.int64)
    lab_in[r] = slots[:, 1][live]
    lab_out[r] = h_out[live]
    u[r] = slots[:, 0].view(np.float32)[live]
    grid[r] = g_of_slot[live]
    return lab_in, u, lab_out, grid


def sweep_numbers(state: Dict, tables: Sequence, rhb: np.ndarray, stay, jump,
                  max_diff: float, dtype=torch.float64, device="cpu") -> Dict:
    """{"alpha_gap": the median over the kept (sweep, chain, path) rows of
    each row's largest |program - reference| forward probability,
    "alpha_max": the largest, "reads": draws judged, "wrong": draws with a
    gap, "wrong_share": wrong / reads, "gap": the largest draw gap, "p":
    {(call, sweep): (P(label 0), labels before, labels drawn, uniforms:
    each a list over the kept rows, and the reference's alphas [G, N, nl,
    K])}} over the kept sweeps and chain rows (tables: the batch's
    samples' hmm.SampleTables). A read the program holds in another grid
    than the reference counts as a wrong draw of gap 1."""
    C, rows = state["C"], state["rows"]
    samp = [r // C for r in rows]
    ts = [tables[s] for s in samp]
    gap, rows_gap, judged, wrong, probs = 0.0, [], 0, 0, {}
    for (call, it), rec in sorted(state["sweeps"].items()):
        if rec["it_mode"] != 2:
            continue
        K_real = rec["K_real"]
        per = [_sweep_reads(rec, j, t.n_reads) for j, t in enumerate(ts)]
        haps = state["which"][call][:, :K_real]
        res = hmm.sweep_probabilities(ts, rhb, haps, [p[0] for p in per], [p[2] for p in per],
                                      stay, jump, first_sweep=it == 0, max_diff=max_diff,
                                      dtype=dtype, device=device)
        for (lab_in, u, lab_out, grid), t, p0 in zip(per, ts, res["p0"]):
            g = np.where(grid != t.grid, 1.0, hmm.decision_gaps(lab_out, lab_in, u, p0))
            gap = max(gap, float(g.max(initial=0.0)))
            judged += int(np.isfinite(p0).sum())
            wrong += int((g > 0).sum())
        prog_a = np.stack([a[..., :K_real] for a in rec["alphas"]], 1)         # [G, N, nl, K]
        ref_a = res["alphas"].to(torch.float64).cpu().numpy()
        probs[(call, it)] = ([x for x in res["p0"]], [p[0] for p in per], [p[2] for p in per],
                             [p[1] for p in per], ref_a)
        rows_gap.extend(row_gaps(prog_a, ref_a))
    return {"gap": gap, "alpha_gap": float(np.median(rows_gap)) if rows_gap else float("nan"),
            "alpha_max": float(max(rows_gap, default=float("nan"))), "reads": judged,
            "wrong": wrong, "wrong_share": wrong / judged if judged else float("nan"),
            "p": probs}


def row_gaps(a: np.ndarray, ref: np.ndarray) -> list:
    """The largest |a - ref| of each (chain, path) row of forward
    probabilities [G, C, nl, K]."""
    return list(np.abs(a - ref).max(axis=(0, 3)).ravel())


def reference_dosages(state: Dict, tables: Sequence, words_T: torch.Tensor, stay, jump,
                      impute: Dict, ref_error: float, nSNPs: int, dtype=torch.float64
                      ) -> np.ndarray:
    """[S, nSNPs] the batch's dosages by the reference: for each post-burn-
    in seek iteration, the forward-backward of each (chain, latent
    haplotype) row from the labels its FB call started from, then the sum
    of a chain's two haplotypes averaged over chains and iterations."""
    C = state["C"]
    n_seek = int(impute["n_seek_its"])
    n_burn = impute.get("n_burn_in_seek_its")
    n_burn = max(n_seek - 2, 0) if n_burn is None else int(n_burn)
    calls = list(range(n_burn, n_seek))
    dev = words_T.device
    gls = []
    for j in calls:
        H = state["labels"][j]
        for s, t in enumerate(tables):
            gls.append(hmm.haploid_gls(t, H[s * C:(s + 1) * C, :t.n_reads], nSNPs,
                                       float(impute.get("minGLValue", 1e-10)), dtype=dtype,
                                       device=dev))
    d = hmm.fb_dosages(torch.cat(gls), words_T, stay, jump, ref_error, nSNPs, dtype=dtype)
    S = len(tables)
    d = d.reshape(len(calls), S, C, 2, nSNPs).sum(3).mean(2).mean(0)
    return d.cpu().numpy()


def dosage_number(prog: Sequence[np.ndarray], ref: np.ndarray) -> float:
    """The largest |program - reference| dosage over every SNP and sample
    (a missing or non-finite program dosage counts as 2, the widest)."""
    worst = 0.0
    for s, d in enumerate(prog):
        if d is None or not np.all(np.isfinite(d)):
            return 2.0
        worst = max(worst, float(np.abs(np.asarray(d, np.float64) - ref[s]).max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number over its limit (or missing)
    makes the run not correct."""
    return {k: {"value": numbers.get(k, float("nan")), "limit": float(limits[k])}
            for k in limits}


def all_within(checks: Dict[str, Dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
