"""Median of the server's own per-case latency (``PredictionServer.latencies``:
from the start of a case's processing to its written mask)."""

from benchmark.lib import stats


def read(r):
    values = r.counters.get("latency_s") or []
    return 1e3 * stats.median(values) if values else None
