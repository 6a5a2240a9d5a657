"""The port's nonlinear objectives beyond the plain L-BFGS and Nelder-Mead
paths, on test_nonlinear.py's inputs, float64: the collision objective, the
joint (d_free, time) objective through an ESDF, the soft and the hard
(augmented-Lagrangian) magnitude constraints, and the hard box bounds.

Each case passes test_nonlinear.py's own bars in the port and ends within
2 % of the JAX package's final total, or lower; the first 5 entries of the
cost history agree to rtol 1e-6 where the run is smooth.

The collision case here starts both packages from the JAX package's linear
solve.  Its straight start path lies on voxel planes, where the trilinear
field has kinks; test_torch_nonlinear_collision.py runs it from the port's
own start and from either side of the planes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.solver import nonlinear as jnl
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch import convert
from mav_tube_trajectory_generation_tpu_torch.solver import nonlinear as tnl

from test_torch_nonlinear import build, params_pair
from torch_port_util import N, to_np, tt

H = N // 2
FIRST = 5


def _fields(occ, origin, res):
    return (jmtg.esdf_from_occupancy(occ, origin, res, dtype=jnp.float64),
            mtt.esdf_from_occupancy(occ, origin, res, dtype=torch.float64,
                                    device="cpu"))


def _clearance(field, res, n=200):
    traj = mtt.Trajectory(res.coefficients, res.times)
    ts = np.linspace(0, float(res.times.sum()) - 1e-9, n)
    return float(mtt.distance_at(field, mtt.evaluate(traj, tt(ts), 0)).min())


def _close_or_lower(ours, ref, rtol=0.02):
    assert float(ours.cost.total) <= (1.0 + rtol) * float(ref.cost.total), (
        float(ours.cost.total), float(ref.cost.total))


def test_collision_objective_avoids_obstacle():
    dim, k = 3, 2
    js = jsm.make_structure(jsm.standard_mask(k + 1, N), dim, N)
    ts = convert.structure_from_fields(js)
    values = np.zeros((k + 1, H, dim))
    values[0, 0] = [0.2, 1.0, 1.0]
    values[1, 0] = [1.0, 1.0, 1.0]
    values[2, 0] = [1.8, 1.0, 1.0]
    d_fixed = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    times = np.array([3.0, 3.0])
    occ = jmtg.make_obstacle_grid((20, 20, 20), (0, 0, 0), 0.1,
                                  boxes=[((1.15, 0.9, 0.85),
                                          (1.45, 1.35, 1.3))])
    jfield, tfield = _fields(occ, (0, 0, 0), 0.1)
    jp, tp = params_pair(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=100, use_soft_constraints=False, robot_radius=0.1,
        epsilon=0.3, collision_samples_per_segment=64,
        weights=jnl.CostWeights(w_d=0.1, w_c=1000.0))
    d0 = np.asarray(jmtg.solve_linear(js, jnp.asarray(d_fixed),
                                      jnp.asarray(times)).d_free)
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       field=jfield, d_free_init=jnp.asarray(d0))
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp, field=tfield,
                        d_free_init=tt(d0), device="cpu")
    assert float(ours.initial_cost.total) == pytest.approx(
        float(ref.initial_cost.total), rel=1e-12)
    _close_or_lower(ours, ref)
    assert float(ours.cost.collision) < 0.5 * float(
        ours.initial_cost.collision)
    assert _clearance(tfield, ours) > tp.robot_radius


def test_collision_and_time_joint_objective():
    js, ts, d_fixed, times = build(k=2, seed=11)
    occ = jmtg.make_obstacle_grid((16, 16, 16), (0, 0, 0), 0.4, spheres=[
        ((3.0, 3.0, 3.0), 0.5)])
    jfield, tfield = _fields(occ, (0, 0, 0), 0.4)
    jp, tp = params_pair(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME,
        max_iterations=15, time_penalty=10.0, use_soft_constraints=False,
        weights=jnl.CostWeights(w_d=0.1, w_c=10.0, w_t=1.0))
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       field=jfield)
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp, field=tfield,
                        device="cpu")
    np.testing.assert_allclose(to_np(ours.cost_history)[:FIRST],
                               np.asarray(ref.cost_history)[:FIRST],
                               rtol=1e-6)
    _close_or_lower(ours, ref)
    assert float(ours.cost.total) <= 1.1 * float(ours.initial_cost.total)
    assert np.all(np.isfinite(to_np(ours.times)))


def test_soft_constraints_reduce_max_velocity():
    js, ts, d_fixed, times = build(seed=9)
    v_limit = 1.5
    jp, tp = params_pair(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_TIME,
        max_iterations=60, time_penalty=0.0, use_soft_constraints=True,
        soft_constraint_weight=10.0,
        weights=jnl.CostWeights(w_d=0.1, w_sc=10.0))
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       constraints=[jnl.MagnitudeConstraint(1, v_limit)])
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp,
                        constraints=[tnl.MagnitudeConstraint(1, v_limit)],
                        device="cpu")
    np.testing.assert_allclose(to_np(ours.cost_history)[:FIRST],
                               np.asarray(ref.cost_history)[:FIRST],
                               rtol=1e-6)
    _close_or_lower(ours, ref)
    sol0 = mtt.solve_linear(ts, tt(d_fixed), tt(times))
    vmax0 = float(tnl.max_magnitude_from_d(ts, tt(d_fixed), sol0.d_free,
                                           tt(times), 1))
    vmax1 = float(tnl.max_magnitude_from_d(ts, tt(d_fixed), ours.d_free,
                                           ours.times, 1))
    if vmax0 > v_limit:
        assert vmax1 < vmax0 * 1.001
    assert vmax1 <= 1.5 * v_limit
    assert float(ours.maxima[1]) == pytest.approx(vmax1, rel=1e-12)


def test_hard_magnitude_constraint_augmented_lagrangian():
    js, ts, d_fixed, times = build(seed=7)
    jp, tp = params_pair(objective=jnl.Objective.FREE_CONSTRAINTS,
                         max_iterations=40, use_soft_constraints=False)
    free0 = tnl.optimize(ts, tt(d_fixed), tt(times), tp, device="cpu")
    vmax0 = float(tnl.max_magnitude_from_d(ts, tt(d_fixed), free0.d_free,
                                           tt(times), 1))
    bound = 0.8 * vmax0
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       constraints=[jnl.MagnitudeConstraint(1, bound)])
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp,
                        constraints=[tnl.MagnitudeConstraint(1, bound)],
                        device="cpu")
    assert ours.cost_history.shape == (40,)
    np.testing.assert_allclose(to_np(ours.cost_history)[:FIRST],
                               np.asarray(ref.cost_history)[:FIRST],
                               rtol=1e-6)
    _close_or_lower(ours, ref)
    vmax = float(tnl.max_magnitude_from_d(ts, tt(d_fixed), ours.d_free,
                                          tt(times), 1))
    assert vmax <= bound * (1.0 + tp.inequality_constraint_tolerance)
    assert float(ours.cost.trajectory) >= float(free0.cost.trajectory) - 1e-6
    assert np.isfinite(float(ours.cost.total)) and 1 in ours.maxima
    # the rounds' boundaries are left out of the FTOL rule
    n_ref, _ = jnl.effective_iterations(ref.cost_history, jp.f_rel, 10)
    assert int(ours.n_iterations) == int(n_ref)


def test_hard_map_bounds_confine_free_positions():
    """test_nonlinear.py's case on the port: the unbounded optimizer leaves
    the map, the bounded one stays inside and still cuts J_c."""
    dim, k = 3, 2
    js = jsm.make_structure(jsm.free_interior_mask(k + 1, N), dim, N)
    ts = convert.structure_from_fields(js)
    values = np.zeros((k + 1, H, dim))
    values[0, 0] = [0.2, 0.3, 0.5]
    values[2, 0] = [1.7, 0.3, 0.5]
    d_fixed = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    occ = mtt.make_obstacle_grid((20, 20, 10), (0, 0, 0), 0.1,
                                 spheres=[((0.95, 0.5, 0.5), 0.4)])
    field = mtt.esdf_from_occupancy(occ, (0, 0, 0), 0.1,
                                    dtype=torch.float64, device="cpu")
    pos_rows = ts.free_cols[:, 1] == 0
    mn, mx = tnl.map_bounds(field)
    out = {}
    for hard in (False, True):
        _, tp = params_pair(
            objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION,
            max_iterations=80, use_soft_constraints=False, robot_radius=0.1,
            epsilon=0.3, collision_samples_per_segment=64,
            weights=jnl.CostWeights(w_d=0.1, w_c=1000.0),
            use_hard_bounds=hard)
        out[hard] = tnl.optimize(ts, tt(d_fixed), tt([3.0, 3.0]), tp,
                                 field=field, device="cpu")
    free_nb = to_np(out[False].d_free)[pos_rows]
    assert np.any((free_nb < mn) | (free_nb > mx)), free_nb
    free_b = to_np(out[True].d_free)[pos_rows]
    assert np.all((free_b >= mn) & (free_b <= mx)), free_b
    assert float(out[True].cost.collision) < 0.3 * float(
        out[True].initial_cost.collision)


def test_hard_bounds_box_magnitude_constraints():
    js, ts, d_fixed, times = build(seed=7)
    v_limit = 1.5
    _, tp = params_pair(objective=jnl.Objective.FREE_CONSTRAINTS,
                        max_iterations=40, use_soft_constraints=False)
    res = tnl.optimize(ts, tt(d_fixed), tt(times), tp,
                       [tnl.MagnitudeConstraint(1, v_limit)], device="cpu")
    vel = to_np(res.d_free)[ts.free_cols[:, 1] == 1]
    assert np.all(np.abs(vel) <= v_limit + 1e-9), vel
