"""device.idle_pct: the share of the traced window in which no operation
ran on the device, in %: 100 - 100 * (the union of the device's
operations in the profiler's trace) / (first search to last wait)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
