"""linear_refused_rows: the mean over the program's logged calls of
``solve_linear`` of its counter ``linear.refused_rows``: the rows whose
equilibrated R_pp the Cholesky factor refused (their answers are NaN).

The program's counters are on only while a profiler session is active: in
a traced run, they count in the profiled calls.  None where the program
keeps no such counter or logged no such call."""

COUNTER = "linear.refused_rows"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    n = [c["counters"][COUNTER] for c in (log() if log else [])
         if c.get("root") == "linear" and COUNTER in c["counters"]]
    return sum(n) / len(n) if n else None
