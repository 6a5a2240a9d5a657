"""The JAX package's own results on the inputs of chip_smoke.py's nonlinear
gates, on the host CPU: the constants those gates hold the port to.

    JAX_PLATFORMS=cpu python tests/torch_nonlinear_witness.py al|box|time

``al`` and ``box`` run the augmented-Lagrangian case (64 rows, float64) and
tests/test_nonlinear.py's box obstacle with w_c = 1000 (256 rows, float64)
through the JAX package, on the exact inputs and on ``--draws`` copies whose
fixed derivatives are scaled by 1 + 1e-15 N(0, 1) (seed 0): rounding-level
changes of the inputs, as a float64 run on another device makes.  They print
the rows that miss the bar on the exact inputs and in any draw, each with
its count of misses.  ``time`` prints the medians over the first 64 rows of
benchmarks/nonlinear_bench.py's batch (float32) of the four TIME lines.

The inputs are built as chip_smoke.py builds them (the augmented-Lagrangian
case's with the port's functions, in float64), on the host.  Nothing here
runs on a card.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import mav_tube_trajectory_generation_tpu as jmtg  # noqa: E402
import mav_tube_trajectory_generation_tpu_torch as mtt  # noqa: E402
from mav_tube_trajectory_generation_tpu.solver import nonlinear as jnl  # noqa: E402
from mav_tube_trajectory_generation_tpu.solver import structure as jsm  # noqa: E402

RELATIVE = 1e-15


def draws(d_fixed, n):
    """The exact inputs, then n copies scaled by 1 + 1e-15 N(0, 1)."""
    rng = np.random.RandomState(0)
    out = [d_fixed]
    for _ in range(n):
        out.append(d_fixed * (1.0 + RELATIVE * rng.randn(*d_fixed.shape)))
    return np.concatenate(out)


def al_inputs():
    """chip_smoke.constraint_cases's hard case: (structure, scaled d_fixed,
    times), float64 numpy."""
    nl = mtt.solver.nonlinear
    vals, ts = [], []
    for seed in range(chip_smoke.CONSTRAINT_BATCH):
        verts = mtt.create_random_vertices(4, 4, np.zeros(3),
                                           6 * np.ones(3), seed)
        st, v = mtt.structure_from_vertices(verts, 10, mtt.SNAP)
        vals.append(v)
        ts.append(np.asarray(mtt.estimate_segment_times(verts, 2.0, 2.0)))
    df = mtt.extract_fixed_values(st, torch.as_tensor(np.stack(vals)))
    t = torch.as_tensor(np.stack(ts))
    sol0 = mtt.solve_linear(st, df, t)
    v0 = nl.max_magnitude_from_d(st, df, sol0.d_free, t, 1)
    verts = jmtg.create_random_vertices(4, 4, np.zeros(3), 6 * np.ones(3), 0)
    js, _ = jmtg.structure_from_vertices(verts, 10, jmtg.SNAP)
    return js, (df / v0[:, None, None]).numpy(), t.numpy()


def al(n_draws):
    js, dfs, t = al_inputs()
    rows = dfs.shape[0]
    p = jnl.NonlinearParameters(objective=jnl.Objective.FREE_CONSTRAINTS,
                                max_iterations=40, use_soft_constraints=False)
    bound = chip_smoke.AL_BOUND
    cons = [jnl.MagnitudeConstraint(1, bound)]

    def vmax(d, tt):
        res = jnl.optimize(js, d, tt, p, constraints=cons)
        return jnl.max_magnitude_from_d(js, d, res.d_free, tt, 1)
    d_all = draws(dfs, n_draws)
    t_all = np.concatenate([t] * (n_draws + 1))
    v = np.asarray(jax.jit(jax.vmap(vmax))(jnp.asarray(d_all),
                                            jnp.asarray(t_all)))
    miss = (v > bound * (1.0 + p.inequality_constraint_tolerance))
    return report(miss.reshape(n_draws + 1, rows),
                  v.reshape(n_draws + 1, rows), "vmax", max)


def box(n_draws):
    n, h = 10, 5
    js = jsm.make_structure(jsm.standard_mask(3, n), 3, n)
    values = np.zeros((3, h, 3))
    values[0, 0] = [0.2, 1.0, 1.0]
    values[1, 0] = [1.0, 1.0, 1.0]
    values[2, 0] = [1.8, 1.0, 1.0]
    df = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    rng = np.random.RandomState(1)
    dfb = df[None] + chip_smoke.BOX_NOISE * rng.randn(chip_smoke.BOX_BATCH,
                                                      *df.shape)
    occ = jmtg.make_obstacle_grid((20, 20, 20), (0, 0, 0), 0.1,
                                  boxes=[((1.15, 0.9, 0.85),
                                          (1.45, 1.35, 1.3))])
    field = jmtg.esdf_from_occupancy(occ, (0, 0, 0), 0.1, dtype=jnp.float64)
    p = jnl.NonlinearParameters(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=100, use_soft_constraints=False, robot_radius=0.1,
        epsilon=0.3, collision_samples_per_segment=64,
        weights=jnl.CostWeights(w_d=0.1, w_c=1000.0))
    times = jnp.asarray([3.0, 3.0])

    def clearance(d):
        res = jnl.optimize(js, d, times, p, field=field)
        traj = jmtg.Trajectory(res.coefficients, res.times)
        ts = jnp.linspace(0, jnp.sum(res.times) - 1e-9, 200)
        return jnp.min(jmtg.distance_at(field, jmtg.evaluate(traj, ts, 0)))
    c = np.asarray(jax.jit(jax.vmap(clearance))(
        jnp.asarray(draws(dfb, n_draws))))
    rows = chip_smoke.BOX_BATCH
    return report((c <= p.robot_radius).reshape(n_draws + 1, rows),
                  c.reshape(n_draws + 1, rows), "clearance", min)


def report(miss, value, name, worst):
    any_row = np.nonzero(miss.any(axis=0))[0]
    return dict(
        draws=miss.shape[0] - 1, relative=RELATIVE,
        exact_rows_missing=np.nonzero(miss[0])[0].tolist(),
        rows_missing_in_any=any_row.tolist(),
        misses_of_row={int(r): int(miss[:, r].sum()) for r in any_row},
        **{f"worst_{name}_of_row": {int(r): float(worst(value[:, r]))
                                    for r in any_row}},
        misses_a_draw=miss.sum(axis=1).tolist())


def time_medians():
    from mav_tube_trajectory_generation_tpu.models.vertex import (
        segment_times_nfabian)
    k, rows = 10, chip_smoke.TIME_ROWS
    std = jsm.make_structure(jsm.standard_mask(k + 1, 10), 3, 10)
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(chip_smoke.TIME_BATCH,
                                                      k + 1, 3)),
                          axis=1).astype(np.float32)[:rows]
    values = np.zeros((rows, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = jnp.asarray(np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0),
                                   dtype=np.float32))
    d_fixed = jnp.asarray(np.asarray(jmtg.extract_fixed_values(
        std, jnp.asarray(values)), dtype=np.float32))
    base = dict(objective=jnl.Objective.TIME,
                max_iterations=chip_smoke.TIME_ITERS, time_penalty=500.0,
                use_soft_constraints=False)
    lines = {"nelder_mead": {}, "zoom": {},
             "backtracking": dict(lbfgs_linesearch="backtracking"),
             "hybrid4": dict(lbfgs_linesearch="hybrid", hybrid_zoom_iters=4)}
    out = {}
    for name, extra in lines.items():
        p = jnl.NonlinearParameters(**base, **extra)
        if name == "nelder_mead":
            r = jax.jit(jax.vmap(lambda a, b: jnl.optimize(std, a, b, p)))(
                d_fixed, times)
            init, final = r.initial_cost.total, r.cost.total
        else:
            _, hist = jax.jit(jax.vmap(
                lambda a, b: jnl.optimize_time_gradient(
                    std, a, b, p, n_iters=chip_smoke.TIME_ITERS)))(
                d_fixed, times)
            init, final = hist[:, 0], hist[:, -1]
        out[name] = (float(jnp.median(init)), float(jnp.median(final)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=("al", "box", "time"))
    ap.add_argument("--draws", type=int, default=16)
    args = ap.parse_args()
    # float64 for the gates' float64 cases; the TIME lines run in float32,
    # as the bench does
    jax.config.update("jax_enable_x64", args.case != "time")
    torch.set_num_threads(4)
    if args.case == "al":
        out = al(args.draws)
    elif args.case == "box":
        out = box(args.draws)
    else:
        out = time_medians()
    print(json.dumps({args.case: out}))


if __name__ == "__main__":
    main()
