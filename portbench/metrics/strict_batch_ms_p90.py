"""strict_batch_ms_p90: the 90th percentile of batch latency in the traced
run's window (after its profiled stretch; the spans' synchronisations
included)."""

from portbench.core import percentile


def read(ctx):
    p = percentile(ctx.latencies_s, 90)
    return None if p is None else p * 1e3
