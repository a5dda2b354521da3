"""The served forwards' share of the card's bf16 peak: the operations of
every member and flip forward of the cases served in the traced window
(from the layer shapes) over the window's seconds."""

from benchmark.lib import flops, peaks


def read(r):
    if not r.counters.get("forwards"):
        return None
    return flops.share(r.work["flop"] / peaks.BF16_FLOPS, r.window_s)
