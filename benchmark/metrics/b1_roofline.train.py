"""B1's share of its roofline in training: the least time of the window's
3³ conv forward and dx calls (counted from their shapes) over the device
time of the B1 kernels that did them."""

from benchmark.lib import flops


def read(r):
    t = r.trace.seconds_matching("conv3x3x3_kernel") if r.trace is not None else None
    return flops.share(r.work["b1_bound_s"], t) if t else None
