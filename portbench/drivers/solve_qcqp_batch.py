"""Driver of the approximate tube planner: ``solve_qcqp_batch`` (ADMM).

A call solves one batch of the pool and brings its answers to the host:
coefficients, free derivatives, cost and max violation.  A scenario fails
the configuration's guarantee where its coefficients are not finite or its
max violation is at or above the gate.

The check judges every answer of the window, and holds a sample of rows
of every batch, drawn from the seed, against the plain float64 ADMM of
``portbench/reference/tube_qcqp.py`` run on the same raw inputs:

  * ``cost_gap_median`` (sampled rows): the median over rows of
    |cost - cost_ref| / cost_ref;
  * ``cost_gap_p99``, ``cost_gap_max`` (sampled rows): the 99th percentile
    and the largest of the same gap, which a fault in a minority of the
    rows moves where the median does not;
  * ``coef_gap_max`` (every row): the largest distance (m) between a control
    point of the returned coefficients and of the trajectory of the returned
    free derivatives (the coefficients are that trajectory, rounded);
  * ``viol_report_gap_max`` (every row): the largest gap between the
    reported max violation and the violation worked out again in float64
    from the answer's free derivatives.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import tube_qcqp as ref

#: Rows the float64 reference solves at once.
REFERENCE_BLOCK = 1024

#: (module of the program, attribute, span name) wrapped in a traced run.
SPANS = (("solver.qcqp", "solve_qcqp_batch", "entry"),
         ("ops.admm_kernel", "admm_stage_fused_factored", "stage"))


def reference_config(cfg: Dict) -> Dict:
    """The configuration file's solver settings as the reference takes
    them."""
    a = cfg["admm"]
    return dict(rho=a["rho"], sigma=a.get("sigma", 1e-8),
                alpha=a.get("alpha", 1.6), n_iters=a["n_iters"],
                n_stages=a["n_stages"], rho_min=a.get("rho_min", 1e-4),
                rho_max=a.get("rho_max", 1e4),
                rho_sphere_factor=a.get("rho_sphere_factor", 1.0),
                rho_tube_factor=a.get("rho_tube_factor", 1.0),
                rho_half_factor=a.get("rho_half_factor", 1.0),
                n_coefficients=cfg["n_coefficients"],
                derivative=cfg["derivative"])


def trajectory_of(d_free, inputs) -> torch.Tensor:
    """The coefficients (the inputs' dtype) of the trajectory an answer's
    free derivatives define."""
    return ref.trajectory(inputs["d_fixed"], d_free, inputs["times"])


def rows_of(batch: Dict[str, torch.Tensor], rows, dtype, device):
    idx = torch.as_tensor(rows, dtype=torch.long)
    return {k: v[idx].to(device=device, dtype=dtype) for k, v in batch.items()}


def kept_rows(full: Dict[str, torch.Tensor], rows, sample, device):
    """(the inputs of the rows a kept call holds, the positions of the
    sampled rows among them): a call kept whole holds every row (``rows``
    None), the others the sampled rows only."""
    if rows is None:
        return full, torch.as_tensor(sample, dtype=torch.long, device=device)
    idx = torch.as_tensor(rows, dtype=torch.long, device=device)
    return ({k: v[idx] for k, v in full.items()},
            torch.arange(len(rows), device=device))


def free_structure(mtg, cfg: Dict):
    """The program's structure of the configuration's free-interior family."""
    n = int(cfg["n_coefficients"])
    return mtg.make_structure(
        mtg.free_interior_mask(int(cfg["n_segments"]) + 1, n),
        int(cfg["dimension"]), n, int(cfg["derivative"]))


def reference_costs(pool_host, keep_rows, kept, rcfg, device):
    """The float64 reference ADMM of the sampled rows of every batch that a
    kept call ran: batch index -> dict of (rows,) tensors (cost,
    violation)."""
    out = {}
    for i in sorted({kp["batch"] for kp in kept}):
        rows = keep_rows[i]
        inp = rows_of(pool_host[i], rows, torch.float64, device)
        parts = [ref.admm(inp["waypoints"][i:i + REFERENCE_BLOCK],
                          inp["times"][i:i + REFERENCE_BLOCK],
                          inp["radii"][i:i + REFERENCE_BLOCK],
                          inp["d_fixed"][i:i + REFERENCE_BLOCK], rcfg)
                 for i in range(0, len(rows), REFERENCE_BLOCK)]
        out[i] = {k: torch.cat([p[k] for p in parts])
                  for k in ("cost", "violation")}
    return out


class Driver:
    def __init__(self, mtg, cell, device):
        from mav_tube_trajectory_generation_tpu_torch.solver import qcqp
        self.mtg = mtg
        self.qcqp = qcqp
        self.cfg = cell.config
        self.cell = cell
        self.device = device
        self.structure = free_structure(mtg, self.cfg)
        self.config = mtg.ADMMConfig(**self.cfg["admm"])
        self.gate = float(self.cfg["guarantee"]["max_violation_below"])

    def to_device(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in b.items()}

    def call(self, b):
        """One call of the entry point; the harness brings the answers to
        the host."""
        sol = self.qcqp.solve_qcqp_batch(
            self.structure, b["d_fixed"], b["times"], b["waypoints"],
            b["radii"], config=self.config, warmstart_values=b["values"],
            device=self.device)
        return {"coefficients": sol.coefficients, "d_free": sol.d_free,
                "cost": sol.cost, "max_violation": sol.max_violation}

    def tally(self, res):
        # a row sum is finite exactly where every entry is (the entries are
        # far from overflow); one pass over the answers on the host
        finite = torch.isfinite(res["coefficients"].flatten(1).sum(1))
        ok = finite & (res["max_violation"] < self.gate)
        n = int(ok.shape[0])
        return n, n - int(ok.sum()), {}

    def sample_rows(self, pool_host: List[Dict], seed: int) -> List[np.ndarray]:
        """Rows of each pool batch that the check compares, drawn from the
        seed."""
        s = int(self.cell.check["rows_per_batch"])
        rng = np.random.default_rng([int(seed), 99])
        return [np.sort(rng.choice(b["times"].shape[0],
                                   size=min(s, b["times"].shape[0]),
                                   replace=False)) for b in pool_host]

    def check(self, pool_host, keep_rows, kept, device) -> Dict[str, float]:
        """The check's readings.  Every kept row of every call: the
        coefficients against the trajectory of the free derivatives, the
        reported violation against the one worked out again; the sampled
        rows' cost also against the reference's."""
        f64 = torch.float64
        refs = reference_costs(pool_host, keep_rows, kept,
                               reference_config(self.cfg), device)
        full = {i: {k: v.to(device=device, dtype=f64)
                    for k, v in pool_host[i].items()} for i in refs}
        cost_gap, coef_gap, viol_gap = [], [], []
        for kp in kept:
            inp, s_idx = kept_rows(full[kp["batch"]], kp["rows"],
                                   keep_rows[kp["batch"]], device)
            traj = trajectory_of(kp["d_free"].to(device=device, dtype=f64), inp)
            cp_ret = ref.control_points(
                kp["coefficients"].to(device=device, dtype=f64), inp["times"])
            coef_gap.append(_max_dist(cp_ret, ref.control_points(
                traj, inp["times"])))
            viol = ref.corridor_violation(traj, inp["times"], inp["waypoints"],
                                          inp["radii"])
            viol_gap.append((kp["max_violation"].to(device=device, dtype=f64)
                             - viol).abs().cpu())
            r = refs[kp["batch"]]["cost"]
            cost = kp["cost"].to(device=device, dtype=f64)[s_idx]
            cost_gap.append(((cost - r).abs() / r.abs()).cpu())
        gaps = torch.cat(cost_gap).nan_to_num(float("inf"))
        return {
            "cost_gap_median": float(gaps.median()),
            "cost_gap_p99": float(torch.quantile(gaps, 0.99)),
            "cost_gap_max": float(gaps.max()),
            "coef_gap_max": _nanmax(torch.cat(coef_gap)),
            "viol_report_gap_max": _nanmax(torch.cat(viol_gap)),
        }


def _max_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) the largest Euclidean distance between matching control
    points."""
    return torch.linalg.vector_norm(a - b, dim=-1).flatten(1).amax(1).cpu()


def _nanmax(t: torch.Tensor) -> float:
    """The largest entry, infinity where any is not finite."""
    if not bool(torch.isfinite(t).all()):
        return float("inf")
    return float(t.max())
