"""The arithmetic of rates, tails, spreads and the idle share, on inputs
whose answers are known."""

import statistics

import pytest

from perfbench.harness import stats, trace


def test_rate_is_all_the_work_over_all_the_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_sees_a_stall_that_medians_of_chunks_hide():
    # 200 steps of 10 ms, and a stall of 30 steps at 80 ms in one stretch
    steps = [10.0] * 200
    steps[100:130] = [80.0] * 30
    assert stats.percentile(steps, 95) == 80.0
    chunks = [steps[i:i + 20] for i in range(0, 200, 20)]
    # a median of the chunks' medians, or of their p95s, is blind to it
    assert statistics.median(statistics.median(c) for c in chunks) == 10.0
    assert statistics.median(stats.percentile(c, 95) for c in chunks) == 10.0


@pytest.mark.parametrize("q, want", [(50, 3), (95, 5), (100, 5), (1, 1)])
def test_nearest_rank(q, want):
    assert stats.percentile([5, 1, 4, 2, 3], q) == want


def test_spread_is_the_quartiles_over_the_median():
    vals = [100.0, 101.0, 99.0, 102.0, 98.0, 100.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_busy_and_idle_cover_the_window():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    gaps = stats.idle_gaps(iv, 0.0, 10.0)
    assert gaps == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.busy(iv, 0.0, 10.0) + sum(e - s for s, e in gaps) == 10.0


def test_trace_data_idle_share_and_breakdown():
    events = [("k2", 0.0, 0.4), ("k1", 0.3, 0.5), ("copy", 0.8, 0.9)]
    spans = [("render", 0.0, 0.6), ("copy_to_host", 0.6, 1.0)]
    data = trace.TraceData(events, 0.0, 1.0, {"units": 2, "steps": 2},
                           spans, 3.0, {})
    assert data.busy_s == pytest.approx(0.6)
    from perfbench.metrics.readers import idle_share, launches, syncs
    assert idle_share.read(data) == pytest.approx(40.0)
    assert launches.read(data, per="steps") == 1.5
    assert syncs.read(data, per="steps") == 3.0
    b = data.breakdown()
    assert b["device_ops"][0][0] == "k2"
    assert b["idle_gaps"][0] == ["copy_to_host", pytest.approx(0.3)]
