"""Median host milliseconds of a served case's dispatch (the program's
``serve.dispatch`` spans of the case summed: its ingest, and the
ensemble x TTA forwards and the threshold issued to the card)."""

from benchmark.lib import program_spans, stats


def read(r):
    spans = program_spans.window_spans(r)
    if not spans:
        return None
    cases = set(program_spans.keys_of(spans, "serve.case"))
    ms = program_spans.ms_by_key(spans, "serve.dispatch")
    return stats.median([v for k, v in ms.items() if k in cases]) if cases else None
