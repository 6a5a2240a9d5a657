"""strict_tier0_ms: the median per call of tier 0's synchronised span
(``ipm_lanes.solve_qcqp_polished_batch``: the ADMM and the snap sweeps)."""

import statistics


def read(ctx):
    t0 = [c["entry/tier0"] for c in ctx.spans if "entry/tier0" in c]
    return statistics.median(t0) if t0 else None
