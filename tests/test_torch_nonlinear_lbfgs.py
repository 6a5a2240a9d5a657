"""The port's batched L-BFGS (``solver.lbfgs``) held against the JAX
package's optax chains, float64: on a batch of Rosenbrock functions against
optax itself, on the FREE_CONSTRAINTS objective from a perturbed start, on
``optimize_time_gradient`` with each line search, and on the TIME
objective's inner solve through the QCQP.

Tolerances: against optax on Rosenbrock the whole value history to rtol
1e-8 (25 iterations; the dot products sum in another order); on the
planner's objectives the first 5 entries of the cost history to rtol 1e-6
and the final cost within 1 % of the JAX package's, or lower; the
QCQP-inner TIME objective (Nelder-Mead, 3 iterations) to rtol 1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import nonlinear as jnl
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch import convert
from mav_tube_trajectory_generation_tpu_torch.solver import lbfgs as tlbfgs
from mav_tube_trajectory_generation_tpu_torch.solver import linear as tlinear
from mav_tube_trajectory_generation_tpu_torch.solver import nonlinear as tnl

from test_torch_nonlinear import build, params_pair
from torch_port_util import N, to_np, tt

H = N // 2
FIRST = 5


def _rosenbrock_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosenbrock_t(x):
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
            + (1.0 - x[:, :-1]) ** 2).sum(-1)


def _optax_run(chain, fn, x0, n, project=None):
    """The JAX package's scan body, per scenario: optax's own chain."""
    vg = optax.value_and_grad_from_state(fn)

    def step(carry, _):
        x, state = carry
        value, grad = vg(x, state=state)
        upd, state = chain.update(grad, state, x, value=value, grad=grad,
                                  value_fn=fn)
        x = optax.apply_updates(x, upd)
        if project is not None:
            x = project(x)
        return (x, state), value
    (x, _), values = jax.lax.scan(step, (x0, chain.init(x0)), None,
                                  length=n)
    return x, values


def _chain(linesearch):
    if linesearch == "zoom":
        return optax.lbfgs()
    return optax.chain(optax.scale_by_lbfgs(), optax.scale(-1.0),
                       optax.scale_by_backtracking_linesearch(
                           max_backtracking_steps=12, store_grad=True))


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_against_optax_on_rosenbrock(linesearch):
    """Eight starts of a 5-D Rosenbrock function (some far out, so that the
    zoom's interval search, cubic, quadratic and bisection steps and the
    backtracking's shrinking all run), with and without a box."""
    rng = np.random.RandomState(0)
    x0 = rng.randn(8, 5) * np.array([[0.5], [1.0], [2.0], [3.0],
                                     [0.1], [1.5], [2.5], [0.8]])
    n = 25
    for box in (None, (-1.5, 2.0)):
        proj_j = None if box is None else (lambda x: jnp.clip(x, *box))
        proj_t = None if box is None else (
            lambda x: torch.clamp(x, box[0], box[1]))
        chain = _chain(linesearch)
        ref_x, ref_v = jax.jit(jax.vmap(lambda x: _optax_run(
            chain, _rosenbrock_j, x, n,
            proj_j)))(jnp.asarray(x0 if box is None else np.clip(x0, *box)))
        x, v = tlbfgs.lbfgs_minimize(_rosenbrock_t, tt(x0), n,
                                     project=proj_t, linesearch=linesearch)
        assert v.shape == (8, n)
        np.testing.assert_allclose(to_np(v), np.asarray(ref_v), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(to_np(x), np.asarray(ref_x), rtol=1e-8,
                                   atol=1e-10)


def test_hybrid_and_bad_linesearch():
    x0 = np.random.RandomState(1).randn(3, 4)
    ref_bt = jax.vmap(lambda x: _optax_run(_chain("backtracking"),
                                           _rosenbrock_j, x, 6))(
        jnp.asarray(x0))
    ref_z = jax.vmap(lambda x: _optax_run(_chain("zoom"), _rosenbrock_j, x,
                                          4))(ref_bt[0])
    x, v = tlbfgs.lbfgs_minimize(_rosenbrock_t, tt(x0), 10,
                                 linesearch="hybrid", hybrid_zoom_iters=4)
    np.testing.assert_allclose(
        to_np(v), np.concatenate([ref_bt[1], ref_z[1]], axis=1), rtol=1e-9)
    np.testing.assert_allclose(to_np(x), np.asarray(ref_z[0]), rtol=1e-8)
    with pytest.raises(ValueError, match="linesearch"):
        tlbfgs.lbfgs_minimize(_rosenbrock_t, tt(x0), 2, linesearch="wolfe")


@pytest.fixture(scope="module")
def free_constraints_runs():
    js, ts, d_fixed, times = build()
    sol = jlinear.solve_linear(js, jnp.asarray(d_fixed), jnp.asarray(times))
    d_free0 = np.asarray(sol.d_free) + 0.5 * np.random.RandomState(0).randn(
        *np.asarray(sol.d_free).shape)
    jp, tp = params_pair(objective=jnl.Objective.FREE_CONSTRAINTS,
                         max_iterations=40, use_soft_constraints=False)
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       d_free_init=jnp.asarray(d_free0))
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp,
                        d_free_init=tt(d_free0), device="cpu")
    return js, ts, d_fixed, times, np.asarray(sol.d_free), d_free0, ref, ours


def test_free_constraints_zoom_matches_jax(free_constraints_runs):
    js, ts, d_fixed, times, d_opt, d_free0, ref, ours = free_constraints_runs
    np.testing.assert_allclose(to_np(ours.cost_history)[:FIRST],
                               np.asarray(ref.cost_history)[:FIRST],
                               rtol=1e-6)
    assert float(ours.cost.total) <= 1.01 * float(ref.cost.total)
    # test_nonlinear.py's bar: back to (near) the closed-form minimum
    jd = lambda d: float(tnl.derivative_cost(ts, tt(d_fixed), d, tt(times)))
    assert jd(ours.d_free) < jd(tt(d_free0))
    assert jd(ours.d_free) <= jd(tt(d_opt)) * 1.01 + 1e-9
    # and it converged by the FTOL rule before its budget
    assert int(ours.n_iterations) < 40
    assert int(ours.stopping_reason) == tnl.STOP_FTOL_REACHED


@pytest.fixture(scope="module")
def time_gradient_runs():
    js, ts, d_fixed, times = build()
    runs = {}
    for ls in ("zoom", "backtracking", "hybrid"):
        jp, tp = params_pair(objective=jnl.Objective.TIME, max_iterations=30,
                             time_penalty=500.0, use_soft_constraints=False,
                             lbfgs_linesearch=ls)
        ref = jnl.optimize_time_gradient(js, jnp.asarray(d_fixed),
                                         jnp.asarray(times), jp)
        ours = tnl.optimize_time_gradient(ts, tt(d_fixed), tt(times), tp,
                                          device="cpu")
        runs[ls] = (ref, ours)
    return js, ts, d_fixed, times, runs


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking", "hybrid"])
def test_time_gradient_matches_jax(time_gradient_runs, linesearch):
    js, ts, d_fixed, times, runs = time_gradient_runs
    (t_ref, h_ref), (t_ours, h_ours) = runs[linesearch]
    assert h_ours.shape == (30,)
    np.testing.assert_allclose(to_np(h_ours)[:FIRST],
                               np.asarray(h_ref)[:FIRST], rtol=1e-6)

    def final(t):
        sol = tlinear.solve_linear(ts, tt(d_fixed), tt(np.asarray(t)))
        return float(sol.cost) + float(tnl.time_cost(tt(np.asarray(t)),
                                                     500.0))
    assert final(to_np(t_ours)) <= 1.01 * final(np.asarray(t_ref))
    assert final(to_np(t_ours)) < final(times)
    t = to_np(t_ours)
    assert np.all(t >= 0.1 - 1e-9) and np.all(t <= 2.0 * times + 1e-9)


def test_time_gradient_beats_nelder_mead(time_gradient_runs):
    """test_nonlinear.py's bar on the port: the gradient through the solve
    matches or beats the simplex after 30 iterations each."""
    js, ts, d_fixed, times, runs = time_gradient_runs
    _, tp = params_pair(objective=jnl.Objective.TIME, max_iterations=30,
                        time_penalty=500.0, use_soft_constraints=False)
    nm = tnl.optimize(ts, tt(d_fixed), tt(times), tp, device="cpu")

    def cost(t):
        sol = tlinear.solve_linear(ts, tt(d_fixed), t)
        return float(sol.cost) + float(tnl.time_cost(t, 500.0))
    t_gd = runs["zoom"][1][0]
    assert cost(t_gd) <= cost(nm.times) * 1.05
    assert cost(t_gd) < cost(tt(times))


def test_time_objective_with_qcqp_inner():
    """The TIME objective re-solving the tube QCQP at every evaluation
    (objectiveFunctionTime, stack 3.4 of SURVEY.md), Nelder-Mead for 3
    iterations: history, times and cost to rtol 1e-9, and
    test_nonlinear.py's bars."""
    k = 3
    rng = np.random.RandomState(5)
    waypoints = np.cumsum(rng.uniform(0.8, 1.5, size=(k + 1, 3)), axis=0)
    js = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    ts = convert.structure_from_fields(js)
    values = np.zeros((k + 1, H, 3))
    values[0, 0] = waypoints[0]
    values[-1, 0] = waypoints[-1]
    d_fixed = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    times = np.asarray(jmtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    radii = np.full((k, 2), 0.6)
    jp, tp = params_pair(objective=jnl.Objective.TIME, max_iterations=3,
                         time_penalty=100.0, use_soft_constraints=False)
    jcfg = jqcqp.ADMMConfig(rho=0.01, n_stages=2, n_iters=60)
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       waypoints=jnp.asarray(waypoints),
                       radii=jnp.asarray(radii), admm_config=jcfg)
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp, waypoints=waypoints,
                        radii=radii,
                        admm_config=convert.admm_config_from_fields(jcfg),
                        device="cpu")
    np.testing.assert_allclose(to_np(ours.cost_history),
                               np.asarray(ref.cost_history), rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.times), np.asarray(ref.times),
                               rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.cost.total),
                               np.asarray(ref.cost.total), rtol=1e-9)
    assert float(ours.cost.total) <= 1.1 * float(ours.initial_cost.total)
    assert np.all(np.isfinite(to_np(ours.coefficients)))
