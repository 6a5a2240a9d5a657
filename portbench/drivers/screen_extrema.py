"""Driver of the feasibility screen: the linear planner's closed-form solve
and the analytic maxima of speed and acceleration (BASELINE config 5).

A call screens one batch of the pool through the program's public entry
points, as a planner would: ``solve_linear`` on the standard mask (its
default Cholesky route), ``Trajectory``, ``max_magnitude`` of the velocity
and of the acceleration at the configuration's grid, and the comparison
with the configuration's limits.  It returns cost, coefficients, the two
maxima and the verdicts, which the harness brings to the host.  A scenario
fails where its cost, a coefficient or a maximum is not finite.

The check holds a sample of rows of every batch, drawn from the seed,
against the plain float64 reference of
``portbench/reference/min_snap_extrema.py`` run on the host on the same raw
waypoints and times (each distinct answer of a sampled row once: calls on
one batch give the same answers), and every kept row against its own
waypoints:

  * ``max_gap_p99``, ``max_gap_max`` (sampled rows): the 99th percentile and
    the largest over rows of max(|vmax - vmax_ref| / vmax_ref,
    |amax - amax_ref| / amax_ref).  The float32 solve alone moves the
    maxima by ~4e-4 at the 99th percentile;
  * ``cost_gap_max`` (sampled rows): the largest |cost - cost_ref| /
    cost_ref;
  * ``coef_gap_max`` (sampled rows): the largest distance (m) between a
    control point of the returned coefficients and of the reference's;
  * ``missed_max_rows`` (sampled rows): rows whose returned vmax or amax
    falls short of the float64 maximum of the returned trajectory sampled
    at ``SAMPLES_A_SEGMENT`` points a segment by more than ``MISSED_RTOL``;
  * ``false_feasible_rows`` (sampled rows): rows reported feasible whose
    reference maximum exceeds a limit (the guarantee: never falsely
    feasible);
  * ``verdict_mismatch_rows`` (sampled rows): rows whose verdict differs
    from the reference's verdict, in either direction, so that a screen
    that rejects feasible paths is seen too.  On traffic whose rows all
    lie far inside the limits, the two verdict readings cannot see a
    maximum that is wrong but still inside them: the maxima readings carry
    that;
  * ``vertex_gap_max`` (every kept row): the largest distance (m) between
    the returned trajectory's position at a segment's ends and the
    waypoints there, so that a row answered with another row's answer is
    seen wherever it lies;
  * ``reference_excess_max``: the largest relative excess of the
    reference's own sampled maxima over its analytic ones (the analytic
    maximum is a maximum over points of the segment, the sampled one a
    lower bound of the same).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import min_snap_extrema as ref
from portbench.reference.tube_qcqp import control_points

#: Rows the float64 reference solves at once.
REFERENCE_BLOCK = 1024

#: Points a segment of the dense sampling the returned maxima are held to.
SAMPLES_A_SEGMENT = 2048

#: The relative shortfall of a returned maximum under the sampled maximum
#: of its own trajectory that counts as a missed maximum.  The program
#: evaluates the magnitude in float32 at local times up to T, where the
#: terms of x^(d) cancel: its maxima read up to ~8e-5 under the float64
#: evaluation of the same coefficients (host runs at 1024 rows); a maximum
#: the candidates miss reads 1e-2 to 1 under it.
MISSED_RTOL = 1e-3

#: The answers a call returns, in the order the check stacks them.
FIELDS = ("coefficients", "cost", "vmax", "amax", "feasible")

#: (module of the program, attribute, span name) wrapped in a traced run.
SPANS = (("solver.linear", "solve_linear", "solve_linear"),
         ("models.trajectory", "min_max_magnitude", "min_max_magnitude"))


class Driver:
    def __init__(self, mtg, cell, device):
        from mav_tube_trajectory_generation_tpu_torch.models import trajectory
        from mav_tube_trajectory_generation_tpu_torch.ops import roots
        from mav_tube_trajectory_generation_tpu_torch.solver import linear
        self.linear = linear
        self.trajectory = trajectory
        self.cfg = cfg = cell.config
        self.cell = cell
        self.device = device
        k, n = int(cfg["n_segments"]), int(cfg["n_coefficients"])
        self.structure = mtg.make_structure(
            mtg.standard_mask(k + 1, n), int(cfg["dimension"]), n,
            int(cfg["derivative"]))
        ext = cfg["extrema"]
        # the program's grid is an argument, its bisections a constant and
        # its derivatives the call's: the configuration has to state them
        if int(ext["bisections"]) != roots.DEFAULT_BISECTIONS:
            raise ValueError(f"the program bisects {roots.DEFAULT_BISECTIONS}"
                             f" times, the configuration says "
                             f"{ext['bisections']}")
        if list(ext["derivatives"]) != [1, 2]:
            raise ValueError("the screen bounds the velocity and the "
                             "acceleration: derivatives [1, 2]")
        self.n_grid = int(ext["n_grid"])
        self.v_limit = float(cfg["limits"]["velocity"])
        self.a_limit = float(cfg["limits"]["acceleration"])

    def to_device(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The standard mask's fixed derivatives from the vertex values, and
        the times, on the device (outside the timed call)."""
        values = b["values"].to(self.device)
        return {"d_fixed": self.linear.extract_fixed_values(self.structure,
                                                            values),
                "times": b["times"].to(self.device)}

    def call(self, b):
        """One screen of a batch; the harness brings the answers to the
        host."""
        sol = self.linear.solve_linear(self.structure, b["d_fixed"],
                                       b["times"])
        traj = self.trajectory.Trajectory(sol.coefficients, sol.times)
        vmax = self.trajectory.max_magnitude(traj, 1, n_grid=self.n_grid).value
        amax = self.trajectory.max_magnitude(traj, 2, n_grid=self.n_grid).value
        return {"coefficients": sol.coefficients, "cost": sol.cost,
                "vmax": vmax, "amax": amax,
                "feasible": (vmax <= self.v_limit) & (amax <= self.a_limit)}

    def tally(self, res):
        # a row sum is finite exactly where every entry is (the entries are
        # far from overflow); one pass over the answers on the host
        finite = (torch.isfinite(res["coefficients"].flatten(1).sum(1))
                  & torch.isfinite(res["cost"]) & torch.isfinite(res["vmax"])
                  & torch.isfinite(res["amax"]))
        n = int(finite.shape[0])
        return n, n - int(finite.sum()), {}

    def sample_rows(self, pool_host: List[Dict], seed: int) -> List[np.ndarray]:
        """Rows of each pool batch that the check compares, drawn from the
        seed."""
        s = int(self.cell.check["rows_per_batch"])
        rng = np.random.default_rng([int(seed), 99])
        return [np.sort(rng.choice(b["times"].shape[0],
                                   size=min(s, b["times"].shape[0]),
                                   replace=False)) for b in pool_host]

    def check(self, pool_host, keep_rows, kept, device) -> Dict[str, float]:
        """The check's readings (module docstring)."""
        f64 = torch.float64
        cfg = self.cfg
        batches = sorted({kp["batch"] for kp in kept})
        sample = {i: torch.as_tensor(keep_rows[i], dtype=torch.long)
                  for i in batches}
        refs = {i: ref.screen(pool_host[i]["waypoints"][sample[i]].to(f64),
                              pool_host[i]["times"][sample[i]].to(f64),
                              int(cfg["n_coefficients"]),
                              int(cfg["derivative"]), (1, 2), REFERENCE_BLOCK)
                for i in batches}

        vertex_gap, answers = [], {i: [] for i in batches}
        for kp in kept:
            i = kp["batch"]
            rows = (slice(None) if kp["rows"] is None
                    else torch.as_tensor(kp["rows"], dtype=torch.long))
            vertex_gap.append(_vertex_gap(
                kp["coefficients"].to(device=device, dtype=f64),
                pool_host[i]["times"][rows].to(device=device, dtype=f64),
                pool_host[i]["waypoints"][rows].to(device=device, dtype=f64)))
            s_idx = sample[i] if kp["rows"] is None else torch.arange(
                len(kp["rows"]))
            answers[i].append(torch.cat(
                [kp[f][s_idx].reshape(len(s_idx), -1).to(f64)
                 for f in FIELDS], dim=1))

        gaps, cost_gap, coef_gap, missed, shortfall = [], [], [], [], []
        false_feasible, mismatch = [], []
        for i in batches:
            n_rows = len(sample[i])
            stacked = torch.cat(answers[i])
            row = torch.arange(n_rows).repeat(len(answers[i]))
            # each distinct answer of a sampled row once
            uniq = torch.unique(torch.cat([row[:, None].to(f64), stacked], 1),
                                dim=0)
            row = uniq[:, 0].long()
            coeffs = uniq[:, 1:-4].reshape(len(row), -1,
                                           int(cfg["n_coefficients"]), 3)
            cost, vmax, amax, feasible = uniq[:, -4:].unbind(1)
            r = {k: v[row] for k, v in refs[i].items()}
            times = pool_host[i]["times"][sample[i][row]].to(f64)
            gaps.append(torch.maximum((vmax - r["max_1"]).abs() / r["max_1"],
                                      (amax - r["max_2"]).abs() / r["max_2"]))
            cost_gap.append((cost - r["cost"]).abs() / r["cost"].abs())
            coef_gap.append(torch.linalg.vector_norm(
                control_points(coeffs, times)
                - control_points(r["coefficients"], times), dim=-1)
                .flatten(1).amax(1))
            short = torch.stack([
                1.0 - m / ref.sampled_maxima(coeffs.to(device), times.to(device),
                                             d, SAMPLES_A_SEGMENT).cpu()
                for d, m in ((1, vmax), (2, amax))]).amax(0)
            shortfall.append(short)
            missed.append(~(short <= MISSED_RTOL))
            ref_feasible = ((r["max_1"] <= self.v_limit)
                            & (r["max_2"] <= self.a_limit))
            false_feasible.append((feasible != 0) & ~ref_feasible)
            mismatch.append((feasible != 0) != ref_feasible)

        excess = []
        for i in batches:
            times = pool_host[i]["times"][sample[i]].to(device=device,
                                                        dtype=f64)
            c = refs[i]["coefficients"].to(device)
            excess.append(torch.stack([
                ref.sampled_maxima(c, times, d, SAMPLES_A_SEGMENT).cpu()
                / refs[i][f"max_{d}"] - 1.0 for d in (1, 2)]).amax(0))

        g = torch.cat(gaps).nan_to_num(float("inf"))
        return {
            "max_gap_median": float(g.median()),
            "max_gap_p99": float(torch.quantile(g, 0.99)),
            "max_gap_max": float(g.max()),
            "cost_gap_max": _nanmax(torch.cat(cost_gap)),
            "coef_gap_max": _nanmax(torch.cat(coef_gap)),
            "missed_max_rows": int(torch.cat(missed).sum()),
            "missed_shortfall_max": _nanmax(torch.cat(shortfall)),
            "false_feasible_rows": int(torch.cat(false_feasible).sum()),
            "verdict_mismatch_rows": int(torch.cat(mismatch).sum()),
            "vertex_gap_max": _nanmax(torch.cat(vertex_gap)),
            "reference_excess_max": _nanmax(torch.cat(excess)),
            "feasible_share": float(torch.cat(
                [a[:, -1] for i in batches for a in answers[i]]).mean()),
        }


def _vertex_gap(coeffs: torch.Tensor, times: torch.Tensor,
                waypoints: torch.Tensor) -> torch.Tensor:
    """(B,) on the host: the largest distance between each segment's
    position at its start and end and the waypoints there."""
    n = coeffs.shape[-2]
    tpow = times[..., None] ** torch.arange(n, dtype=times.dtype,
                                            device=times.device)
    start = coeffs[..., 0, :]                              # (B, K, 3)
    end = torch.einsum('bki,bkid->bkd', tpow, coeffs)
    gap = torch.maximum(
        torch.linalg.vector_norm(start - waypoints[:, :-1], dim=-1),
        torch.linalg.vector_norm(end - waypoints[:, 1:], dim=-1))
    return gap.amax(1).cpu()


def _nanmax(t: torch.Tensor) -> float:
    """The largest entry, infinity where any is not finite."""
    if not bool(torch.isfinite(t).all()):
        return float("inf")
    return float(t.max())
