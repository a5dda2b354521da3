"""Milliseconds the server spent polling (the program's ``serve.poll``
spans: the inbox's listing and the sleep between polls) in the window,
per case served."""

from benchmark.lib import program_spans


def read(r):
    spans = program_spans.window_spans(r)
    if not spans:
        return None
    cases = program_spans.keys_of(spans, "serve.case")
    return sum(program_spans.ms_by_key(spans, "serve.poll").values()) / len(cases) if cases else None
