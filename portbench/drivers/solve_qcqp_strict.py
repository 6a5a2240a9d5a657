"""Driver of the certified deployment: ``solve_qcqp_strict`` (the verdict
router with its defaults).

A call routes one batch of the pool and brings its answers to the host:
verdicts, the tier that settled each row, coefficients, free derivatives
and max violation.  A scenario fails the configuration's guarantee where its
verdict is not determinate, or it is FEASIBLE and its returned coefficients
violate the corridor by the strict gate or more, in float64.  The check
keeps every call whole and counts ``failed`` so.

The check judges every answer of the window by what it says, with the
plain float64 functions of ``portbench/reference/tube_qcqp.py`` on the same
raw inputs (tier 0's rows and the rows every escalation tier settled alike):

  * ``feasible_viol64_max``: the largest violation of the corridor, worked
    out in float64, by the returned coefficients of a FEASIBLE row; the
    configuration's gate is its limit;
  * ``viol_report_gap_max``: the largest gap, over FEASIBLE rows, between
    the reported max violation and the violation of the trajectory that
    the row's free derivatives define, worked out again in float64;
  * ``not_feasible_rows``: rows with another verdict than FEASIBLE although
    the rest-to-rest witness shows their corridor feasible;
  * ``coef_gap_max``: the largest distance (m) between a control point of
    the returned coefficients and of the trajectory of the returned free
    derivatives;
  * ``cost_excess_max``: the largest ratio, less 1, of a row's cost (worked
    out again from its free derivatives) to the cost of the float64
    reference ADMM of tier 0's configuration, over the sampled rows.

Also read, not compared: ``feasible_reported_viol_max`` (the program's own
number for its FEASIBLE rows) and ``feasible_traj_viol64_max`` (the float64
violation of the free derivatives' trajectory).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.drivers import solve_qcqp_batch as batch_driver
from portbench.drivers.solve_qcqp_batch import (_max_dist, _nanmax,
                                                free_structure, kept_rows,
                                                reference_config,
                                                reference_costs, trajectory_of)
from portbench.reference import tube_qcqp as ref

SPANS = (("solver.auto", "solve_qcqp_strict", "entry"),
         ("solver.ipm_lanes", "solve_qcqp_polished_batch", "tier0"),
         ("solver.ipm_lanes", "solve_qcqp_ipm_lanes", "lanes"),
         ("solver.auto", "_run_tier2_f64", "tier2"))


class Driver(batch_driver.Driver):
    #: every call is kept whole: ``failed`` is counted by the check
    KEEP_EVERY_CALL = True

    def __init__(self, mtg, cell, device):
        from mav_tube_trajectory_generation_tpu_torch.solver import auto
        self.mtg = mtg
        self.auto = auto
        self.cfg = cell.config
        self.cell = cell
        self.device = device
        self.n = int(self.cfg["n_coefficients"])
        self.structure = free_structure(mtg, self.cfg)
        self.gate = float(self.cfg["guarantee"]["feasible_violation_below"])
        self.cost_gate = float(cell.check["cost_yardstick_violation_below"])
        self.feasible = int(mtg.FEASIBLE)

    def call(self, b):
        res = self.auto.solve_qcqp_strict(
            self.structure, b["d_fixed"], b["times"], b["waypoints"],
            b["radii"], warmstart_values=b["values"], device=self.device)
        sol = res.solution
        return {"verdict": torch.from_numpy(np.asarray(res.verdict)),
                "tier": torch.from_numpy(np.asarray(res.tier)),
                "n_escalated": int(res.n_escalated),
                "coefficients": sol.coefficients, "d_free": sol.d_free,
                "max_violation": sol.max_violation}

    def tally(self, res):
        # the guarantee is judged after the window, from the kept answers
        return int(res["verdict"].shape[0]), 0, {
            "n_escalated": res["n_escalated"]}

    def check(self, pool_host, keep_rows, kept, device) -> Dict[str, float]:
        f64 = torch.float64
        refs = reference_costs(pool_host, keep_rows, kept,
                               reference_config(self.cfg), device)
        full = {i: {k: v.to(device=device, dtype=f64)
                    for k, v in pool_host[i].items()} for i in refs}
        none = -1e30
        viol_ret, viol_traj, rep_max = [], [], []
        coef_gap, rep_gap, cost_ratio = [], [], []
        not_feasible = failed = 0
        for kp in kept:
            inp, s_idx = kept_rows(full[kp["batch"]], kp["rows"],
                                   keep_rows[kp["batch"]], device)
            feas = (kp["verdict"] == self.feasible).to(device)
            coeffs = kp["coefficients"].to(device=device, dtype=f64)
            v_ret = ref.corridor_violation(coeffs, inp["times"],
                                           inp["waypoints"], inp["radii"])
            traj = trajectory_of(kp["d_free"].to(device=device, dtype=f64), inp)
            v_traj = ref.corridor_violation(traj, inp["times"],
                                            inp["waypoints"], inp["radii"])
            rep = kp["max_violation"].to(device=device, dtype=f64)
            witness_ok = ref.rest_to_rest_violation(
                inp["waypoints"], inp["radii"], self.n) < 0
            not_feasible += int((~feas & witness_ok).sum())
            determinate = feas | (kp["verdict"] == int(self.mtg.INFEASIBLE)
                                  ).to(device)
            failed += int((~determinate | (feas & ~(v_ret < self.gate))).sum())
            viol_ret.append(torch.where(feas, v_ret, none).cpu())
            viol_traj.append(torch.where(feas, v_traj, none).cpu())
            rep_max.append(torch.where(feas, rep, none).cpu())
            rep_gap.append(torch.where(feas, (rep - v_traj).abs(), 0.0).cpu())
            coef_gap.append(_max_dist(ref.control_points(coeffs, inp["times"]),
                                      ref.control_points(traj, inp["times"])))
            r = refs[kp["batch"]]
            cost = ref.snap_cost(traj[s_idx], inp["times"][s_idx])
            # the ADMM's cost is a yardstick only where its answer is near
            # feasible (tier 0's own gate)
            cost_ratio.append((cost / r["cost"])[r["violation"]
                                                  < self.cost_gate].cpu())
        return {
            "failed": failed,
            "not_feasible_rows": float(not_feasible),
            "feasible_viol64_max": _nanmax(torch.cat(viol_ret)),
            "viol_report_gap_max": _nanmax(torch.cat(rep_gap)),
            "coef_gap_max": _nanmax(torch.cat(coef_gap)),
            "cost_excess_max": _nanmax(torch.cat(cost_ratio)) - 1.0,
            "feasible_reported_viol_max": _nanmax(torch.cat(rep_max)),
            "feasible_traj_viol64_max": _nanmax(torch.cat(viol_traj)),
        }
