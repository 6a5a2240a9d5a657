"""Receding-horizon replanning with the PyTorch/CUDA port, as the JAX
package's examples/replanning.py: a fleet of agents re-solving tube QCQPs
tick after tick, each warm-started from its previous solution.

Every tick
  1. re-anchors each agent's start state from its current trajectory
     (position..snap at the flight time, ``get_vertex_at_time``, the
     reference's Trajectory::getVertexAtTime workflow for replanning),
  2. moves the goal,
  3. re-solves the tube QCQP warm-started from the previous tick's free
     derivatives (``solve_qcqp_batch``).

The loop measures the sustained replan rate (agents x Hz) on one device.

Usage: python examples/replanning_torch.py [--agents=N] [--ticks=N] [--cpu]
(on the CUDA card unless --cpu is given).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np                                              # noqa: E402
import torch                                                    # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from mav_tube_trajectory_generation_tpu_torch._tensors import (
        resolve_device)
    from mav_tube_trajectory_generation_tpu_torch.models import (
        trajectory as tj)
    from mav_tube_trajectory_generation_tpu_torch.models.vertex import (
        segment_times_nfabian)
    from mav_tube_trajectory_generation_tpu_torch.solver import linear, qcqp
    from mav_tube_trajectory_generation_tpu_torch.solver import (
        structure as sm)

    agents, ticks, k = 2048, 20, 10
    for a in argv:
        if a.startswith("--agents="):
            agents = int(a.split("=")[1])
        if a.startswith("--ticks="):
            ticks = int(a.split("=")[1])
    dev = resolve_device("cpu" if "--cpu" in argv else None)

    free = sm.make_structure(sm.free_interior_mask(k + 1, 10), 3, 10)
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.8, 1.6, size=(agents, k + 1, 3)),
                          axis=1).astype(np.float32)
    times = torch.as_tensor(np.asarray(segment_times_nfabian(
        waypoints, 3.0, 5.0), dtype=np.float32), device=dev)
    radii = torch.full((agents, k, 2), 0.8, dtype=torch.float32, device=dev)
    waypoints = torch.as_tensor(waypoints, device=dev)

    n_fixed_d = 5   # start and goal each pin derivatives 0..4
    values0 = torch.zeros((agents, k + 1, n_fixed_d, 3), dtype=torch.float32,
                          device=dev)
    values0[:, :, 0, :] = waypoints
    d_fixed0 = linear.extract_fixed_values(free, values0)
    x00 = qcqp.position_constrained_warmstart(free, values0, times)

    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125)
    drift = torch.tensor([0.05, 0.03, 0.0], dtype=torch.float32, device=dev)

    def tick(d_fixed, x_prev, wps, t_fly):
        """One replan: solve, fly t_fly along it, re-anchor, move the
        goal."""
        sol = qcqp.solve_qcqp_batch(free, d_fixed, times, wps, radii,
                                    config=admm, x0=x_prev, device=dev)
        traj = tj.Trajectory(sol.coefficients, sol.times)
        # re-anchor the start at the flown state (pos..snap)
        start_state = tj.get_vertex_at_time(traj, t_fly, n_fixed_d - 1)
        # moving goal: drift the last waypoint; goal state = position only
        new_wps = wps.clone()
        new_wps[:, -1, :] += drift
        goal_state = torch.zeros_like(start_state)
        goal_state[:, 0, :] = new_wps[:, -1, :]
        new_wps[:, 0, :] = start_state[:, 0, :]
        d_new = torch.cat([start_state, goal_state], dim=-2)
        return d_new, sol.d_free, new_wps, sol.cost, sol.max_violation

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    d_fixed, x_prev, wps = d_fixed0, x00, waypoints
    t_fly = 0.25
    # warm-up (builds the kernels on the card)
    d_fixed, x_prev, wps, cost, viol = tick(d_fixed, x_prev, wps, t_fly)
    wait()

    t0 = time.perf_counter()
    for _ in range(ticks):
        d_fixed, x_prev, wps, cost, viol = tick(d_fixed, x_prev, wps, t_fly)
    wait()
    dt = (time.perf_counter() - t0) / ticks
    n_feasible = int((viol < 1e-2).sum())
    print(f"[replan] {agents} agents x {1.0 / dt:,.1f} Hz replan rate "
          f"({dt * 1e3:.1f} ms/tick, {agents / dt:,.0f} replans/s); final "
          f"tick: {n_feasible}/{agents} feasible, median viol "
          f"{float(viol.median()):.1e}, median cost "
          f"{float(cost.median()):.3f}", flush=True)


if __name__ == "__main__":
    main()
