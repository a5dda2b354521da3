"""Device milliseconds a train step spends outside B1 and B2: norms, glue,
the loss, the clip and Adam, and copies (profiler device time)."""

B1, B2 = ("conv3x3x3_kernel",), ("conv3x3_dw_kernel", "dw_reduce")


def read(r):
    if r.trace is None or not r.counters.get("steps"):
        return None
    convs = (r.trace.seconds_matching(*B1) or 0.0) + (r.trace.seconds_matching(*B2) or 0.0)
    return 1e3 * (r.trace.total_s() - convs) / r.counters["steps"]
