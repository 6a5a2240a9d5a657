"""The plain reference agrees with the program's plain path on the host, in
float64, at a tiny batch."""

import pytest
import torch

from _util import ROOT  # noqa: F401
from portbench.drivers.solve_qcqp_batch import reference_config, trajectory_of
from portbench.gen import scenarios
from portbench.reference import tube_qcqp as ref

F64 = torch.float64
CFG = {"admm": {"rho": 0.005, "n_stages": 1, "n_iters": 48,
                "rho_tube_factor": 0.125, "rho_half_factor": 0.125},
       "n_coefficients": 10, "derivative": 4}


def _program_f64(b, cfg):
    import mav_tube_trajectory_generation_tpu_torch as mtg
    free = mtg.make_structure(mtg.free_interior_mask(11, 10), 3, 10)
    return mtg.solve_qcqp_batch(
        free, b["d_fixed"].double(), b["times"].double(),
        b["waypoints"].double(), b["radii"].double(),
        config=mtg.ADMMConfig(**cfg["admm"]),
        warmstart_values=b["values"].double(), device="cpu")


@pytest.mark.parametrize("n_stages", [1, 2])
def test_admm_matches_program_in_float64(n_stages):
    cfg = dict(CFG, admm=dict(CFG["admm"], n_stages=n_stages, n_iters=24))
    b = scenarios.make_batch(10, 6, 5)
    sol = _program_f64(b, cfg)
    r = ref.admm(b["waypoints"].double(), b["times"].double(),
                 b["radii"].double(), b["d_fixed"].double(),
                 reference_config(cfg))
    t = b["times"].double()
    gap = (ref.control_points(sol.coefficients, t)
           - ref.control_points(r["coefficients"], t)).abs().max()
    assert gap < 1e-8
    assert torch.allclose(sol.cost, r["cost"], rtol=1e-9)
    assert torch.allclose(sol.max_violation, r["violation"], atol=1e-9)


def test_checks_of_given_coefficients():
    b = scenarios.make_batch(10, 6, 7)
    sol = _program_f64(b, CFG)
    inp = {k: v.double() for k, v in b.items()}
    traj = trajectory_of(sol.d_free, inp)
    t = inp["times"]
    assert (ref.control_points(traj, t)
            - ref.control_points(sol.coefficients, t)).abs().max() < 1e-9
    assert torch.allclose(ref.snap_cost(traj, t), sol.cost, rtol=1e-9)
    assert torch.allclose(ref.corridor_violation(traj, t, inp["waypoints"],
                                                 inp["radii"]),
                          sol.max_violation, atol=1e-9)
    # the rest-to-rest witness lies inside every corridor of positive radius
    w = ref.rest_to_rest_violation(inp["waypoints"], inp["radii"], 10)
    assert torch.allclose(w, torch.full_like(w, -0.8))
    assert (ref.rest_to_rest_violation(inp["waypoints"], 0 * inp["radii"], 10)
            >= 0).all()
