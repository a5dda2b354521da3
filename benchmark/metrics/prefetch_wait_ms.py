"""Mean milliseconds a served case's thread waited for the case's decode
on the prefetch thread (the program's ``serve.prefetch_wait`` span), over
the cases served in the window."""

from benchmark.lib import program_spans


def read(r):
    spans = program_spans.window_spans(r)
    if not spans:
        return None
    cases = program_spans.keys_of(spans, "serve.case")
    ms = program_spans.ms_by_key(spans, "serve.prefetch_wait")
    return sum(ms.get(k, 0.0) for k in cases) / len(cases) if cases else None
