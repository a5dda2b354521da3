"""The yardstick's arithmetic: operation and byte counts, rooflines,
percentiles and rates, and the trace's reduction."""

import math

import numpy as np
import pytest

from benchmark.lib import flops, peaks, stats
from benchmark.lib.trace import DeviceTrace, Spans, breakdown


def test_conv_flop_hand_count():
    # the 18 3³ convs of one 128³ forward at base 64: Σ Ci·Co·voxels by level, ×27 taps ×2
    by_level = [(5 * 64 + 64 * 64 + 128 * 64 + 64 * 64) * 128 ** 3,
                (64 * 128 + 128 * 128 + 256 * 128 + 128 * 128) * 64 ** 3,
                (128 * 256 + 256 * 256 + 512 * 256 + 256 * 256) * 32 ** 3,
                (256 * 512 + 512 * 512 + 1024 * 512 + 512 * 512) * 16 ** 3,
                (512 * 1024 + 1024 * 1024) * 8 ** 3]
    convs = flops.convs(64, 5, (128, 128, 128))
    assert len(convs) == 18
    assert sum(c.flop for c in convs) == 2 * 27 * sum(by_level)
    assert sum(c.flop for c in convs) == pytest.approx(3.76e12, rel=1e-3)


def test_forward_and_step_flop():
    size = (128, 128, 128)
    up = sum(2 * (128 >> k + 1) ** 3 * (64 << k + 1) * (64 << k) * 8 for k in range(4))
    head = 2 * 128 ** 3 * 64
    fwd = flops.forward_flop(64, 5, 1, size)
    assert fwd == sum(c.flop for c in flops.convs(64, 5, size)) + up + head
    assert fwd / 2 == pytest.approx(1.913e12, rel=1e-3)  # multiply-adds
    assert flops.train_flop(64, 5, 1, size, 4) == 12 * fwd
    assert flops.forward_flop(64, 5, 3, size) - fwd == 2 * 2 * 128 ** 3 * 64


def test_conv_bound_takes_the_larger_of_its_two_limits():
    small = flops.Conv(1024, 1024, 4 ** 3)  # fewer voxels than 989/3.35 ≈ 295: the weight's bytes bind
    moved = 2 * 64 * 2048 + 2 * 27 * 1024 * 1024 + 4 * 1024
    assert flops.conv_seconds(small, "fwd") == pytest.approx(moved / peaks.HBM_BYTES_S)
    big = flops.Conv(64, 64, 128 ** 3)  # operations bind
    assert flops.conv_seconds(big, "fwd") == pytest.approx(big.flop / peaks.BF16_FLOPS)
    dw = flops.Conv(64, 64, 128 ** 3)
    assert flops.conv_seconds(dw, "dw") == pytest.approx(max(dw.flop / peaks.BF16_FLOPS,
                                                             (2 * 128 ** 3 * 128 + 4 * 27 * 64 * 64) / peaks.HBM_BYTES_S))
    # the three bounds of a 128³ sample, as PERF.md's kernel table has them
    size = (128, 128, 128)
    assert flops.forward_bound(64, 5, size) * 1e3 == pytest.approx(3.853, abs=1e-3)
    assert flops.dx_bound(64, 5, size) * 1e3 == pytest.approx(3.767, abs=1e-3)
    assert flops.dw_bound(64, 5, size) * 1e3 == pytest.approx(3.861, abs=1e-3)


def test_share_in_percent():
    assert flops.share(1.0, 2.0) == 50.0
    with pytest.raises(ValueError):
        flops.share(1.0, 0.0)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(q).random(37))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_percentile_with_missing_requests():
    assert stats.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert stats.percentile([1.0, 2.0, math.inf], 90) == math.inf
    assert stats.percentile([1.0] * 9 + [math.inf], 80) == 1.0


def test_rate_and_median():
    assert stats.rate(30, 15.0) == 2.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.median([3.0, 1.0, 2.0, 10.0]) == 2.5
    assert stats.median([]) is None


def test_trace_busy_idle_and_names():
    t = DeviceTrace(0, 100, [(10, 30, "conv3x3x3_kernel<bf16>"), (20, 40, "elementwise"),
                             (60, 70, "conv3x3_dw_kernel"), (95, 120, "dw_reduce")])
    assert t.busy_intervals() == [(10, 40), (60, 70), (95, 100)]
    assert t.busy_s() == pytest.approx(45e-9)
    assert t.idle_gaps() == [(0, 10), (40, 60), (70, 95)]
    assert t.seconds_matching("conv3x3x3_kernel") == pytest.approx(20e-9)
    assert t.seconds_matching("conv3x3_dw_kernel", "dw_reduce") == pytest.approx(35e-9)
    assert t.seconds_matching("absent") is None
    assert t.total_s() == pytest.approx(75e-9)


def test_idle_gaps_labelled_by_the_open_host_span():
    spans = Spans()
    spans.by_name["step"] = [(0, 50)]
    spans.by_name["sync"] = [(55, 100)]
    t = DeviceTrace(0, 100, [(10, 30, "k"), (60, 80, "k")])
    assert spans.labels([0, 30, 52, 80]) == ["step", "step", "none", "sync"]
    b = breakdown(t, spans)
    assert b["device_ops"] == [["k", pytest.approx(40e-9)]]
    # gaps (0, 10) and (30, 60) start under 'step', (80, 100) under 'sync'
    assert dict(b["idle_gaps"]) == {"step": pytest.approx(40e-9), "sync": pytest.approx(20e-9)}
