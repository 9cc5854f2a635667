"""Accuracy metrics: r2 binned by allele frequency and phase switch error.

Equivalents of r2_by_freq (reference: QUILT/R/functions.R:2804-2827) and
modified_calculate_pse (functions.R:1504-1607; double-switch exclusion).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def r2_simple(truth_g: np.ndarray, dosage: np.ndarray) -> float:
    m = np.isfinite(truth_g) & np.isfinite(dosage)
    if m.sum() < 2 or np.std(truth_g[m]) == 0 or np.std(dosage[m]) == 0:
        return float("nan")
    return float(np.corrcoef(truth_g[m], dosage[m])[0, 1] ** 2)


def r2_by_freq(
    breaks: np.ndarray,
    af: np.ndarray,
    truth_g: np.ndarray,
    dosage: np.ndarray,
    flip: bool = False,
) -> np.ndarray:
    """Per-AF-bin [n, nA, r2] table."""
    af = af.copy()
    truth_g = truth_g.astype(np.float64).copy()
    dosage = dosage.copy()
    if flip:
        w = af > 0.5
        af[w] = 1 - af[w]
        truth_g[w] = 2 - truth_g[w]
        dosage[w] = 2 - dosage[w]
    out = []
    for i in range(len(breaks) - 1):
        w = (af > breaks[i]) & (af <= breaks[i + 1])
        if w.sum() == 0:
            out.append([0, 0, np.nan])
            continue
        out.append([
            int(w.sum()),
            float(np.nansum(truth_g[w])),
            r2_simple(truth_g[w], dosage[w]),
        ])
    return np.asarray(out)


def calculate_pse(
    test_haps: np.ndarray,      # [nSNPs, 2] imputed hap dosages
    truth_haps: np.ndarray,     # [nSNPs, 2] truth 0/1 (may contain nan)
) -> Dict[str, float]:
    """Phase switch error at truth hets, excluding double switches
    (reference: modified_calculate_pse, functions.R:1504-1607)."""
    both_ok = (
        (np.isin(truth_haps[:, 0], [0, 1]))
        & (np.isin(truth_haps[:, 1], [0, 1]))
        & (truth_haps.sum(axis=1) == 1)
    )
    truth = truth_haps[both_ok].astype(np.int64)
    test = test_haps[both_ok]
    if len(test) == 0:
        return {"pse": float("nan"), "disc": float("nan"), "n_sites": 0}
    disc = int((np.round(test.sum(axis=1)) != 1).sum())
    test = np.round(test).astype(np.int64)
    # double-switch exclusion
    w = test.sum(axis=1) == 1
    d = np.abs(test[w, 0] - truth[w, 0])
    w2 = np.flatnonzero(np.diff(d) != 0)
    to_remove = []
    if len(w2) > 0:
        w3 = np.flatnonzero(np.diff(w2) == 1)
        idx_w = np.flatnonzero(w)
        for a in w3:
            to_remove.extend(idx_w[w2[[a, a + 1]]].tolist())
    keep = np.ones(len(test), dtype=bool)
    keep[to_remove] = False
    test_k = test[keep]
    truth_k = truth[keep]
    w = test_k.sum(axis=1) == 1
    if w.sum() < 2:
        return {"pse": float("nan"), "disc": disc, "n_sites": int(both_ok.sum())}
    t = test_k[w]
    tr = truth_k[w]
    if t[0, 0] != tr[0, 0]:
        t = t[:, ::-1]
    y = np.diff(np.abs(t[:, 0] - tr[:, 0])) != 0
    return {
        "pse": float(y.sum() / max(len(y), 1)),
        "phase_errors": int(y.sum()),
        "phase_sites": int(len(y)),
        "disc": disc,
        "n_sites": int(both_ok.sum()),
    }
