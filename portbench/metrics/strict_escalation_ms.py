"""strict_escalation_ms: the median per call of the summed synchronised
spans of the escalation tiers: every ``ipm_lanes.solve_qcqp_ipm_lanes``
call of the router itself (tier 1, its speculative restart, the tier-1.5
chain; not tier 0's own polish) and ``auto._run_tier2_f64``."""

import statistics


def read(ctx):
    esc = [c.get("entry/lanes", 0.0) + c.get("entry/tier2", 0.0)
           for c in ctx.spans if "entry" in c]
    return statistics.median(esc) if esc else None
