"""device_idle_share.solves: 1 - (union of the device's busy intervals /
wall time) over the traced run's profiled stretch of whole calls, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.n_events == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
