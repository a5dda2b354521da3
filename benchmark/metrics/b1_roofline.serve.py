"""B1's share of its roofline on the folded serving path (bias and ReLU in
its epilogue): the least time of the traced window's forward conv calls
(counted from their shapes) over the device time of the B1 kernels."""

from benchmark.lib import flops


def read(r):
    t = r.trace.seconds_matching("conv3x3x3_kernel") if r.trace is not None else None
    return flops.share(r.work["b1_bound_s"], t) if t and r.counters.get("forwards") else None
