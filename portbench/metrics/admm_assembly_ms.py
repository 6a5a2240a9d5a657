"""admm_assembly_ms: the median over calls of the entry span's self time:
the ``solve_qcqp_batch`` span minus the stage kernel's span inside it."""

import statistics


def read(ctx):
    own = [c["entry"] - c.get("entry/stage", 0.0) for c in ctx.spans
           if "entry" in c]
    return statistics.median(own) if own else None
