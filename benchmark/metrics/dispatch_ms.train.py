"""Median host milliseconds of one train step's dispatch: the program's
``train.gather`` and ``train.step`` spans of a step summed (the host
issuing the cached batch and the step's work to the card)."""

from benchmark.lib import program_spans, stats


def read(r):
    spans = program_spans.window_spans(r)
    if not spans:
        return None
    steps = set(program_spans.keys_of(spans, "train.step"))
    ms = program_spans.ms_by_key(spans, "train.gather", "train.step")
    return stats.median([v for k, v in ms.items() if k in steps]) if steps else None
