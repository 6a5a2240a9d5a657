"""extrema_select_ms: the median over the program's logged calls of
``min_max_magnitude`` (one a derivative: two a screen) of the device
milliseconds of its span ``extrema/select`` (the candidates' evaluation,
their magnitudes, the arg-min and the arg-max), from CUDA events on the
call's stream.

The program's spans are on only while a profiler session is active: in a
traced run, they log the profiled calls.  None where the program keeps no
such span or logged no such call on the card."""

import statistics

SPAN = "extrema/select"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    ms = [c["spans"][SPAN]["device_ms"] for c in (log() if log else [])
          if c.get("root") == "extrema" and SPAN in c["spans"]
          and c["spans"][SPAN]["device_ms"] is not None]
    return statistics.median(ms) if ms else None
