"""Controls and planted faults of the feasibility screen's check
(``extrema_k10``).

Each is a context manager that puts something in the timed path's place
for as long as it is open, so that a run through ``core.run_cell`` shows
whether the check catches it.

Controls (a lower precision than the configuration states):
  * ``program_tf32``: the program with TF32 matrix products on;
  * ``reference_tf32``: the plain reference in float32 with TF32 matrix
    products, in the program's place (the solve and both maxima).

Faults (planted in the program):
  * ``grid_2``: the extrema's grid bracket at 2 cells in place of the
    configuration's (two critical points in one cell go unseen);
  * ``endpoints_only``: the maxima from the segments' ends alone, no
    interior root;
  * ``slice_times_stretched``: a sixteenth of the rows solved with their
    segment times x1.02 (answers consistent with themselves);
  * ``answer_altered``: the first row's answer (coefficients, times, cost,
    and so the maxima and the verdict) is the second row's;
  * ``slice_rejected``: a sixteenth of the rows' speed maxima x10, over the
    limit, so that those feasible rows are rejected.

A witness, not a fault: ``grid_4``, the bracket at 4 cells.  It finds the
same maxima as 64 cells on this traffic (0 of 8192 rows differ by 1e-6 in
float64), so no check may fail it.

    python3 portbench/screen_faults.py --variants none,grid_2 --seeds 11,12 \
        [--calls N] [--out screen_cal.jsonl]

drives each (variant, seed) through ``--calls`` calls (default: one pass
over the pool) on the card and prints one JSON line with the check's
readings, as ``calibrate.py`` does for the other cells.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.faults import _patched, _rows, _tf32  # noqa: E402
from portbench.reference import min_snap_extrema as ref  # noqa: E402

CELL = "extrema_k10"
VARIANTS = ("none", "program_tf32", "reference_tf32", "grid_2", "grid_4",
            "endpoints_only", "slice_times_stretched", "answer_altered",
            "slice_rejected")


def _coarse_grid(n_grid: int):
    def make(orig):
        def min_max(traj, derivative, n_grid_asked=None, **kw):
            return orig(traj, derivative, n_grid)
        return min_max
    return make


def _endpoints_only(orig):
    def candidates(*args, **kw):
        cand_t, valid = orig(*args, **kw)
        valid = valid.clone()
        valid[..., 2:] = False              # the first two are the ends
        return cand_t, valid
    return candidates


def _times_stretched(orig):
    def solve(structure, d_fixed, times, *args, **kw):
        times = times.clone()
        times[::16] *= 1.02
        return orig(structure, d_fixed, times, *args, **kw)
    return solve


def _altered(orig):
    def solve(*args, **kw):
        out = orig(*args, **kw)
        idx = torch.arange(out.times.shape[0])
        idx[0] = 1
        return _rows(out, idx)
    return solve


def _rejected(orig):
    def max_magnitude(traj, derivative, *args, **kw):
        out = orig(traj, derivative, *args, **kw)
        if derivative != 1:
            return out
        value = out.value.clone()
        value[::16] *= 10.0
        return out._replace(value=value)
    return max_magnitude


def _reference_solve(orig):
    """``solve_linear`` by the plain reference in the inputs' dtype: the
    waypoints are the standard mask's fixed positions."""
    from mav_tube_trajectory_generation_tpu_torch.solver.linear import \
        LinearSolution

    def solve(structure, d_fixed, times, method="cholesky"):
        cols = {tuple(c): i for i, c in enumerate(structure.fixed_cols)}
        wp = torch.stack([d_fixed[..., cols[(v, 0)], :]
                          for v in range(structure.n_vertices)], dim=-2)
        out = ref.screen(wp, times, structure.n_coefficients,
                         structure.derivative_to_optimize, ())
        return LinearSolution(out["coefficients"], times, d_fixed, None,
                              out["cost"])
    return solve


def _reference_max(orig):
    """``max_magnitude`` by the plain reference in the coefficients' dtype,
    on the host: the companion matrices' eigenvalues are a host routine
    even for tensors on the card, one matrix at a time."""
    from mav_tube_trajectory_generation_tpu_torch.models.trajectory import \
        Extremum

    def max_magnitude(traj, derivative, n_grid=None):
        c, t = traj.coefficients.cpu(), traj.times.cpu()
        value = torch.cat([
            ref.magnitude_maxima(c[i:i + 1024], t[i:i + 1024], derivative)
            for i in range(0, t.shape[0], 1024)])
        return Extremum(None, value.to(traj.times.device), None)
    return max_magnitude


@contextlib.contextmanager
def planted(name: str):
    """Open the control, fault or witness ``name`` of the screen."""
    if name == "none":
        yield
    elif name == "program_tf32":
        with _tf32(True):
            yield
    elif name == "reference_tf32":
        with _tf32(True), \
                _patched("solver.linear", "solve_linear", _reference_solve), \
                _patched("models.trajectory", "max_magnitude",
                         _reference_max):
            yield
    elif name in ("grid_2", "grid_4"):
        with _patched("models.trajectory", "min_max_magnitude",
                      _coarse_grid(int(name[-1]))):
            yield
    elif name == "endpoints_only":
        with _patched("ops.roots", "magnitude_minmax_candidates",
                      _endpoints_only):
            yield
    elif name == "slice_times_stretched":
        with _patched("solver.linear", "solve_linear", _times_stretched):
            yield
    elif name == "answer_altered":
        with _patched("solver.linear", "solve_linear", _altered):
            yield
    elif name == "slice_rejected":
        with _patched("models.trajectory", "max_magnitude", _rejected):
            yield
    else:
        raise ValueError(f"unknown control or fault {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # the program switches TF32 off when it is imported: import it before
    # a control switches it on
    import mav_tube_trajectory_generation_tpu_torch  # noqa: F401
    from portbench import core

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(core.read_bench(ROOT), CELL, ROOT)
    calls = args.calls or int(cell.traffic["pool"])
    out_fh = open(args.out, "a") if args.out else None
    try:
        for variant in args.variants.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                with planted(variant):
                    res = core.run_cell(cell, seed, 0.0, False,
                                        device="cuda", calls=calls)
                line = dict(workload=CELL, variant=variant, seed=seed,
                            batch=int(cell.traffic["batch"]), calls=calls,
                            correct=res["correct"],
                            attempted=res["attempted"], failed=res["failed"],
                            readings=res["readings"],
                            memory_peak_bytes=res["device"]["memory_peak_bytes"],
                            seconds=time.perf_counter() - t0)
                text = json.dumps(line)
                print(text, flush=True)
                if out_fh:
                    out_fh.write(text + "\n")
                    out_fh.flush()
    finally:
        if out_fh:
            out_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
