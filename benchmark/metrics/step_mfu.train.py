"""The whole train step's share of the card's bf16 peak: the model's
operations over the window (every conv, transposed conv and 1×1 head from
the layer shapes, the backward counted as twice the forward) divided by
the window's seconds."""

from benchmark.lib import flops, peaks


def read(r):
    return flops.share(r.work["flop"] / peaks.BF16_FLOPS, r.window_s)
