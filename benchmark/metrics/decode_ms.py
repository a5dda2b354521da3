"""Median milliseconds of the Predictor's host decode and normalize of a case
(``Predictor.read_case``, on the server's prefetch thread), from the
benchmark's span around the call."""

from benchmark.lib import stats


def read(r):
    values = r.spans.durations_s("decode", r.window_start_ns, r.window_end_ns)
    return 1e3 * stats.median(values) if values else None
