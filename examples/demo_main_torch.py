"""End-to-end demo of the PyTorch/CUDA port, mirroring the reference's
mav_main executable (the reference's src/main.cpp:15-126) as the JAX
package's examples/demo_main.py does: collision-aware nonlinear trajectory
optimization through a forest-like map -- the same waypoints, radii and
weights -- on one scenario and then on 1024 perturbed copies at once.

The map is a procedurally generated obstacle forest (seed 12345678),
rasterized at 0.1 m into a 100 x 100 x 50 occupancy grid and turned into a
signed ESDF.

Run: python examples/demo_main_torch.py [--cpu] [--out PATH]
(on the CUDA card unless --cpu is given; the sampled trajectory goes to
PATH, by default build/demo_trajectory_torch.txt under the checkout).
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np                                              # noqa: E402
import torch                                                    # noqa: E402

import mav_tube_trajectory_generation_tpu_torch as mtg          # noqa: E402
from mav_tube_trajectory_generation_tpu_torch.solver import (   # noqa: E402
    nonlinear)
from mav_tube_trajectory_generation_tpu_torch.utils import (    # noqa: E402
    export, timing)

MAP_SHAPE = (100, 100, 50)
MAP_ORIGIN = (1.4, 1.4, 3.9)
MAP_RESOLUTION = 0.1
BATCH = 1024
PERTURBATION = 0.05


def forest_occupancy():
    """The forest around the reference's flight corridor: (occupancy
    (100, 100, 50) bool, origin, resolution)."""
    rng = np.random.RandomState(12345678)
    waypoints = np.array([[2.7, 9.5], [3.50796, 4.34802],
                          [3.95552, 3.23008], [5.06673, 2.31032],
                          [7.0, 2.2]])

    def near_corridor(p, margin=0.7):
        for a, b in zip(waypoints[:-1], waypoints[1:]):
            ab = b - a
            t = np.clip((p - a) @ ab / (ab @ ab), 0.0, 1.0)
            if np.linalg.norm(p - (a + t * ab)) < margin:
                return True
        return False

    trees = []
    for _ in range(40):
        x = 1.4 + rng.rand() * 9.0
        y = 1.4 + rng.rand() * 9.0
        if near_corridor(np.array([x, y])):
            continue  # keep the flight corridor free of trees
        trees.append(((x - 0.15, y - 0.15, 3.9),
                      (x + 0.15, y + 0.15, 8.8)))
    occ = mtg.make_obstacle_grid(MAP_SHAPE, MAP_ORIGIN, MAP_RESOLUTION,
                                 boxes=trees)
    return occ, MAP_ORIGIN, MAP_RESOLUTION


def build_map(method="auto", device=None, dtype=torch.float32):
    occ, origin, res = forest_occupancy()
    return mtg.esdf_from_occupancy(occ, origin, res, dtype=dtype,
                                   method=method, device=device)


def demo_problem(device=None, dtype=torch.float32):
    """The waypoints of main.cpp:26-48: (structure, d_fixed (n_fixed, 3),
    times (4,), vertices)."""
    dimension = 3
    start = mtg.Vertex(dimension)
    start.make_start_or_end([2.7, 9.5, 4.8], mtg.SNAP)
    middles = [[3.50796, 4.34802, 4.56653],
               [3.95552, 3.23008, 4.75131],
               [5.06673, 2.31032, 4.79433]]
    verts = [start]
    for m in middles:
        v = mtg.Vertex(dimension)
        v.add_constraint(mtg.POSITION, m)
        verts.append(v)
    end = mtg.Vertex(dimension)
    end.make_start_or_end([7.0, 2.2, 4.8], mtg.SNAP)
    verts.append(end)
    times = mtg.estimate_segment_times_nfabian(verts, v_max=2.0, a_max=2.0)
    structure, values = mtg.structure_from_vertices(verts, 10, mtg.SNAP)
    d_fixed = mtg.extract_fixed_values(
        structure, torch.as_tensor(values, dtype=dtype, device=device))
    return (structure, d_fixed,
            torch.as_tensor(np.asarray(times), dtype=dtype, device=device),
            verts)


def demo_params(**over):
    """The parameter block of main.cpp:75-110 (the fields that apply)."""
    kw = dict(objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_COLLISION,
              max_iterations=25, use_soft_constraints=False,
              time_penalty=500.0, epsilon=0.3, robot_radius=0.15,
              coll_pot_multiplier=20.0,
              weights=nonlinear.CostWeights(w_d=50.0, w_c=50.0, w_t=0.1,
                                            w_sc=1.0))
    kw.update(over)
    return nonlinear.NonlinearParameters(**kw)


def perturbed_batch(d_fixed, times, batch=BATCH, seed=0):
    """The demo's megabatch: d_fixed plus 0.05 N(0, 1) noise per entry
    (seeded NumPy), the times repeated."""
    rng = np.random.RandomState(seed)
    base = d_fixed.detach().cpu().numpy().astype(np.float64)
    d = base[None] + PERTURBATION * rng.randn(batch, *base.shape)
    d_batch = torch.as_tensor(d, dtype=d_fixed.dtype, device=d_fixed.device)
    return d_batch, times[None].expand(batch, -1).contiguous()


def min_clearance(field, res, n=200):
    """Smallest ESDF distance over n evenly spaced times of each
    trajectory of ``res``: (...,)."""
    traj = mtg.Trajectory(res.coefficients, res.times)
    total = res.times.sum(-1, keepdim=True)
    ts = (total - 1e-9) * torch.linspace(0.0, 1.0, n, dtype=total.dtype,
                                         device=total.device)
    return mtg.distance_at(field, mtg.evaluate(traj, ts, 0)).amin(dim=-1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    out = os.path.join(_ROOT, "build", "demo_trajectory_torch.txt")
    if "--out" in argv:
        out = argv[argv.index("--out") + 1]

    with timing.Timer("demo/build_map"):
        field = build_map(device=device)
    print(f"map {MAP_SHAPE} at {MAP_RESOLUTION} m, ESDF by "
          f"{field.method!r} on {field.distance.device}")
    structure, d_fixed, times, _ = demo_problem(device=device)
    params = demo_params()

    res = timing.time_torch("demo/optimize", nonlinear.optimize, structure,
                            d_fixed, times, params, field=field,
                            device=device)
    print(f"cost: {float(res.initial_cost.total):.4f} -> "
          f"{float(res.cost.total):.4f} "
          f"(J_d {float(res.cost.trajectory):.4f}, "
          f"J_c {float(res.cost.collision):.6f})")
    print(f"min clearance along path: {float(min_clearance(field, res)):.3f}"
          f" m (robot radius {params.robot_radius} m)")

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    export.write_matlab_sampled_trajectory(
        mtg.Trajectory(res.coefficients, res.times), out)
    print(f"sampled trajectory written to {out}")

    # Megabatch: the same optimization over 1024 perturbed scenarios.
    d_batch, t_batch = perturbed_batch(d_fixed, times)
    nonlinear.optimize(structure, d_batch, t_batch, params, field=field,
                       device=device)                           # warm-up
    costs = timing.time_torch("demo/optimize_batch", nonlinear.optimize,
                              structure, d_batch, t_batch, params,
                              field=field, device=device).cost.total
    dt = timing.Timing.get_mean("demo/optimize_batch")
    print(f"batched: {BATCH} scenarios in {dt:.2f} s "
          f"({BATCH / dt:,.0f} nonlinear optimizations/s), median final "
          f"cost {float(costs.median()):.4f}")
    print()
    print(timing.Timing.print())


if __name__ == "__main__":
    main()
