"""linear_solve_ms: the median over the program's logged calls of
``solve_linear`` of the device milliseconds of its root span ``linear``
(the free derivatives and the coefficients' recovery), from CUDA events on
the call's stream.

The program's spans are on only while a profiler session is active: in a
traced run, they log the profiled calls.  None where the program keeps no
such span or logged no such call on the card."""

import statistics

SPAN = "linear"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    ms = [c["spans"][SPAN]["device_ms"] for c in (log() if log else [])
          if c.get("root") == SPAN and SPAN in c["spans"]
          and c["spans"][SPAN]["device_ms"] is not None]
    return statistics.median(ms) if ms else None
