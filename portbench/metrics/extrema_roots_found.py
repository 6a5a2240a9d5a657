"""extrema_roots_found: the mean over the program's logged calls of
``min_max_magnitude`` (one a derivative: two a screen) of its counter
``extrema.roots``: the interior candidates the grid bracket found, summed
over the batch's segments.

The program's counters are on only while a profiler session is active: in
a traced run, they count in the profiled calls.  None where the program
keeps no such counter or logged no such call."""

COUNTER = "extrema.roots"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    n = [c["counters"][COUNTER] for c in (log() if log else [])
         if c.get("root") == "extrema" and COUNTER in c["counters"]]
    return sum(n) / len(n) if n else None
