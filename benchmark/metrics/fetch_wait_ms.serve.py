"""Median host milliseconds a served case's mask took to reach the host
(the program's ``serve.fetch`` span: the host waiting for the card to
finish the case's forwards)."""

from benchmark.lib import program_spans, stats


def read(r):
    spans = program_spans.window_spans(r)
    if not spans:
        return None
    cases = set(program_spans.keys_of(spans, "serve.case"))
    ms = program_spans.ms_by_key(spans, "serve.fetch")
    return stats.median([v for k, v in ms.items() if k in cases]) if cases else None
