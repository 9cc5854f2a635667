"""The window and rate arithmetic, and the spread the bounds are set from."""
import statistics

import pytest

from benchmark import rates


def test_window_closes_at_the_first_batch_past_the_seconds():
    # a stall of 5 s in the third batch: the window runs to its end
    durations = [1.0, 1.0, 5.0, 1.0, 1.0]
    assert rates.closed_window(durations, 3.0) == (3, 7.0)
    assert rates.closed_window(durations, 2.0) == (2, 2.0)
    assert rates.closed_window(durations, 100.0) == (5, 9.0)


def test_rate_counts_every_sample_and_all_the_time_including_a_stall():
    durations = [2.0, 2.0, 6.0, 2.0]
    per_batch = [32, 32, 32, 32]
    # 3 batches close the window at 10 s: 96 samples over 10 s, the stall included
    assert rates.samples_per_s(per_batch, durations, 5.0) == pytest.approx(9.6)
    assert rates.samples_per_s(per_batch, [2.0] * 4, 5.0) == pytest.approx(16.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert rates.spread(v) == pytest.approx((q3 - q1) / q2)


def test_r2_simple():
    import numpy as np
    t = np.array([0, 1, 2, 1, 0, 2], float)
    assert rates.r2_simple(t, t * 0.5 + 0.1) == pytest.approx(1.0)
    assert np.isnan(rates.r2_simple(np.zeros(6), t))


def test_idle_time_goes_to_the_section_open_over_it(tmp_path):
    """A trace with two kernels and two host sections: the idle time
    between the kernels is split at the sections' edges."""
    import json

    from benchmark import tracing
    ev = [
        {"ph": "X", "name": tracing.BATCH_RANGE, "cat": "user_annotation", "ts": 0, "dur": 100},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 0, "dur": 10},
        {"ph": "X", "name": "vcf:columns", "cat": "user_annotation", "ts": 20, "dur": 30},
        {"ph": "X", "name": "vcf:write", "cat": "user_annotation", "ts": 50, "dur": 40},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 90, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = tracing.read_trace(str(path))
    assert tr["busy_s"] == pytest.approx(20e-6) and tr["window_s"] == pytest.approx(100e-6)
    gaps = dict(tr["idle_gaps"])
    assert gaps["vcf:write"] == pytest.approx(40e-6)
    assert gaps["vcf:columns"] == pytest.approx(30e-6)
    assert gaps["outside the engine's timed sections"] == pytest.approx(10e-6)
    assert dict(tr["device_ops"]) == pytest.approx({"k1": 10e-6, "k2": 10e-6})
