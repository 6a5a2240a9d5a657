"""admm_lu_fallback_blocks: the mean over the program's logged calls of
``solve_qcqp_batch`` of its counter ``spd_inverse.lu_blocks``: the matrices
that ``ops.linalg.spd_inverse``'s Cholesky factor refused in the call, which
take the pivoted-LU inverse instead.

The program's counters are on only while a profiler session is active: in a
traced run, they count in the profiled calls.  None where the program keeps
no span log or logged no such call."""

COUNTER = "spd_inverse.lu_blocks"


def read(ctx):
    try:
        from mav_tube_trajectory_generation_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    n = [c["counters"][COUNTER] for c in (log() if log else [])
         if c.get("root") == "qcqp" and COUNTER in c["counters"]]
    return sum(n) / len(n) if n else None
