"""Share of the traced window (a serving window until the server has
stopped) in which no kernel, copy or set ran on the card."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
