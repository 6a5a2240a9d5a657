"""admm_factor_ms: the median over the program's logged calls of
``solve_qcqp_batch`` of the device milliseconds of its span ``qcqp/factor``
(``_stage_factors``: each stage's block LDL^T factor and xq, summed over
the stages), from CUDA events on the call's stream.

The program's spans are on only while a profiler session is active: in a
traced run, they log the profiled calls.  None where the program keeps no
span log or logged no such call on the card."""

import statistics

SPAN = "qcqp/factor"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    ms = [c["spans"][SPAN]["device_ms"] for c in (log() if log else [])
          if c.get("root") == "qcqp" and SPAN in c["spans"]
          and c["spans"][SPAN]["device_ms"] is not None]
    return statistics.median(ms) if ms else None
