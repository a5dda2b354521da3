"""Median milliseconds of the gzip NIfTI mask write (``Predictor.save_mask``),
from the benchmark's span around the call."""

from benchmark.lib import stats


def read(r):
    values = r.spans.durations_s("write", r.window_start_ns, r.window_end_ns)
    return 1e3 * stats.median(values) if values else None
