"""The frame statistics of a window."""
import statistics

import pytest

from rtbench import stats


def test_window_mean_counts_whole_frames():
    # three back-to-back frames of 0.1, 0.2 and 0.3 s from t = 1.0
    assert stats.window_mean(1.0, 1.6, 3) == pytest.approx(0.2)
    with pytest.raises(ValueError):
        stats.window_mean(0.0, 1.0, 0)


@pytest.mark.parametrize("n,want", [(1, 9.0), (20, 18.0), (100, 94.0),
                                    (101, 95.0)])
def test_p95_is_nearest_rank_over_all_frames(n, want):
    vals = [float(i) for i in range(n)] if n > 1 else [9.0]
    assert stats.percentile(vals[::-1], 95) == want


def test_p95_takes_the_stall():
    vals = [0.1] * 95 + [1.0] * 5
    assert stats.percentile(vals, 95) == 0.1
    assert stats.percentile(vals + [1.0], 95) == 1.0


def test_spread_is_python_quartiles_over_median():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
