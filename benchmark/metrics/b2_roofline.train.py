"""B2's share of its roofline: the least time of the window's 3³ weight
gradients (counted from their shapes) over the device time of the B2
kernels, its split-K reduction included."""

from benchmark.lib import flops


def read(r):
    t = r.trace.seconds_matching("conv3x3_dw_kernel", "dw_reduce") if r.trace is not None else None
    return flops.share(r.work["b2_bound_s"], t) if t else None
