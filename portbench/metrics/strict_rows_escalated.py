"""strict_rows_escalated: the mean per call of ``AutoResult.n_escalated``,
the program's own count of rows past tier 0's gate."""


def read(ctx):
    n = ctx.counters.get("n_escalated")
    return sum(n) / len(n) if n else None
