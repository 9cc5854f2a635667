"""The arithmetic of a run's numbers: the measured window, the rate over
it, r2 against truth (a frozen copy of quilt_tpu_torch/out/metrics.py:
r2_simple), and the spread of a set of runs as the bounds are set from it."""
from __future__ import annotations

import statistics
from typing import Sequence, Tuple

import numpy as np


def window_closed(elapsed_s: float, seconds: float) -> bool:
    """The window closes at the end of the first batch that finishes at or
    after `seconds` from its start."""
    return elapsed_s >= seconds


def closed_window(durations: Sequence[float], seconds: float) -> Tuple[int, float]:
    """(batches in the window, its length in seconds) for batches of these
    durations run back to back from the window's start."""
    t = 0.0
    for i, d in enumerate(durations):
        t += d
        if window_closed(t, seconds):
            return i + 1, t
    return len(durations), t


def samples_per_s(samples_per_batch: Sequence[int], durations: Sequence[float],
                  seconds: float) -> float:
    """Every sample of every batch in the window over the window's length."""
    n, t = closed_window(durations, seconds)
    return sum(samples_per_batch[:n]) / t


def r2_simple(truth_g: np.ndarray, dosage: np.ndarray) -> float:
    m = np.isfinite(truth_g) & np.isfinite(dosage)
    if m.sum() < 2 or np.std(truth_g[m]) == 0 or np.std(dosage[m]) == 0:
        return float("nan")
    return float(np.corrcoef(truth_g[m], dosage[m])[0, 1] ** 2)


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(values, n=4) gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
