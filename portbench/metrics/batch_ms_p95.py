"""batch_ms_p95: the 95th percentile of batch latency over every call of
the window, from the call's start to its results on the host."""

from portbench.core import percentile


def read(ctx):
    p = percentile(ctx.latencies_s, 95)
    return None if p is None else p * 1e3
