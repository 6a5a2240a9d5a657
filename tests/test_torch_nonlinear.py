"""The port's nonlinear optimizer (``solver.nonlinear``) held against the JAX
package on the same NumPy inputs, float64: the cost terms and their
gradients, the bounds, the stopping report, Nelder-Mead on the TIME
objective, a batch against its scenarios run alone, and the linear solve's
failed-factor rows the optimizer meets near the time box's edge.

Tolerances: each cost term to rtol 1e-10 and its gradient (against
``jax.grad``) to rtol 1e-8 of the gradient's scale; the integer and box
outputs exactly; Nelder-Mead's whole cost history and final times to rtol
1e-9 over 10 iterations; a batch of three equal to its scenarios alone to
rtol 1e-10.  The L-BFGS paths are in test_torch_nonlinear_lbfgs.py, the
other objectives in test_torch_nonlinear_objectives.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import nonlinear as jnl
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch import convert
from mav_tube_trajectory_generation_tpu_torch.solver import linear as tlinear
from mav_tube_trajectory_generation_tpu_torch.solver import nonlinear as tnl

from torch_port_util import N, to_np, tt

H = N // 2
TERMS = dict(rtol=1e-10, atol=0)


def build(dim=3, k=4, seed=3):
    """test_nonlinear.py's scenario: (JAX structure, port structure,
    d_fixed, times) as NumPy float64."""
    verts = jmtg.create_random_vertices(H - 1, k, np.zeros(dim),
                                        6 * np.ones(dim), seed)
    structure, values = jmtg.structure_from_vertices(verts, N, jmtg.SNAP)
    times = np.asarray(jmtg.estimate_segment_times(verts, 2.0, 2.0))
    d_fixed = np.asarray(jmtg.extract_fixed_values(structure,
                                                   jnp.asarray(values)))
    return (structure, convert.structure_from_fields(structure), d_fixed,
            times)


def params_pair(**kw):
    """The same parameters in both packages."""
    j = jnl.NonlinearParameters(**kw)
    return j, convert.nonlinear_parameters_from_fields(j)


@pytest.fixture(scope="module")
def term_case():
    """A perturbed solution whose path passes through a sphere (so that
    every term is live), and the JAX package's values and gradients of
    every term, from one compiled function."""
    js, ts, d_fixed, times = build()
    rng = np.random.RandomState(0)
    sol = jlinear.solve_linear(js, jnp.asarray(d_fixed), jnp.asarray(times))
    d_free = np.asarray(sol.d_free) + 0.3 * rng.randn(*sol.d_free.shape)
    traj = jmtg.Trajectory(sol.coefficients, sol.times)
    center = np.asarray(jmtg.evaluate(traj, 0.4 * times.sum(), 0))[0]
    occ = jmtg.make_obstacle_grid((16, 16, 16), (0, 0, 0), 0.4,
                                  spheres=[(tuple(center), 0.8)])
    jfield = jmtg.esdf_from_occupancy(occ, (0, 0, 0), 0.4,
                                      dtype=jnp.float64)
    tfield = mtt.esdf_from_occupancy(occ, (0, 0, 0), 0.4,
                                     dtype=torch.float64, device="cpu")
    cons = [(1, 1.5), (2, 2.0)]
    c = dict(js=js, ts=ts, d_fixed=d_fixed, times=times, d_free=d_free,
             jfield=jfield, tfield=tfield,
             jcons=[jnl.MagnitudeConstraint(*c) for c in cons],
             tcons=[tnl.MagnitudeConstraint(*c) for c in cons])
    jfix = jnp.asarray(d_fixed)
    jp = jnl.NonlinearParameters(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME,
        soft_constraint_weight=10.0)

    def all_terms(d, t):
        totals = {o: jnl.total_cost(
            js, jfix, d, t, jnl.NonlinearParameters(
                objective=jnl.Objective[o], soft_constraint_weight=10.0),
            c["jcons"], jfield) for o in OBJECTIVES}
        grads = {}
        for name, f in TERM_FNS.items():
            g = lambda d, t, f=f: f(jnl, js, jp, (jfix, d), t, c["jcons"],
                                    jfield)
            grads[name] = (g(d, t),) + jax.grad(g, argnums=(0, 1))(d, t)
        return totals, grads
    c["jax"] = jax.jit(all_terms)(jnp.asarray(d_free), jnp.asarray(times))
    return c


OBJECTIVES = ("FREE_CONSTRAINTS", "FREE_CONSTRAINTS_AND_TIME", "TIME",
              "FREE_CONSTRAINTS_AND_COLLISION",
              "FREE_CONSTRAINTS_AND_COLLISION_AND_TIME")


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_total_cost_and_terms_f64(term_case, objective):
    c = term_case
    _, tp = params_pair(objective=jnl.Objective[objective],
                        soft_constraint_weight=10.0)
    ref = c["jax"][0][objective]
    ours = tnl.total_cost(c["ts"], tt(c["d_fixed"]), tt(c["d_free"]),
                          tt(c["times"]), tp, c["tcons"], c["tfield"])
    for name, a, b in zip(ref._fields, ref, ours):
        np.testing.assert_allclose(to_np(b), np.asarray(a), err_msg=name,
                                   **TERMS)
    assert float(ours.collision) > 0 and float(ours.soft_constraints) > 0


TERM_FNS = {
    "derivative": lambda m, c, p, d, t, cons, f: m.derivative_cost(
        c, d[0], d[1], t),
    "time": lambda m, c, p, d, t, cons, f: m.time_cost(t, 500.0),
    "collision": lambda m, c, p, d, t, cons, f: m.collision_cost(
        c, d[0], d[1], t, f, p),
    "soft": lambda m, c, p, d, t, cons, f: m.soft_constraint_cost(
        c, d[0], d[1], t, cons, p),
    "max_velocity": lambda m, c, p, d, t, cons, f: m.max_magnitude_from_d(
        c, d[0], d[1], t, 1, 64),
    "total": lambda m, c, p, d, t, cons, f: m.total_cost(
        c, d[0], d[1], t, p, cons, f).total,
}


@pytest.mark.parametrize("term", sorted(TERM_FNS))
def test_term_gradients_against_jax_grad(term_case, term):
    """Each term and its gradient in d_free and in the segment times:
    through the collision samples, the candidate times held constant in
    the extrema, the soft clamp in log space."""
    c = term_case
    _, tp = params_pair(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME,
        soft_constraint_weight=10.0)
    val_j, gd_j, gt_j = c["jax"][1][term]
    d = tt(c["d_free"]).requires_grad_(True)
    t = tt(c["times"]).requires_grad_(True)
    val_t = TERM_FNS[term](tnl, c["ts"], tp, (tt(c["d_fixed"]), d), t,
                           c["tcons"], c["tfield"])
    np.testing.assert_allclose(to_np(val_t), np.asarray(val_j), **TERMS)
    val_t.backward()
    for ref, x in ((gd_j, d), (gt_j, t)):
        ref = np.asarray(ref)
        ours = torch.zeros_like(x) if x.grad is None else x.grad
        np.testing.assert_allclose(to_np(ours), ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max())
    if term not in ("time", "derivative"):
        assert np.abs(to_np(d.grad)).max() > 0


def test_effective_iterations_equal():
    rng = np.random.RandomState(1)
    hist = np.cumprod(1.0 - rng.rand(5, 12) * np.array(
        [[0.5], [0.02], [0.3], [0.001], [0.9]]), axis=1) * 10.0
    for f_rel in (0.05, 0.01, 1e-4):
        for round_length in (0, 3, 4):
            ref = jnl.effective_iterations(jnp.asarray(hist), f_rel,
                                           round_length)
            ours = tnl.effective_iterations(tt(hist), f_rel, round_length)
            for a, b in zip(ref, ours):
                assert b.dtype == torch.int32
                np.testing.assert_array_equal(to_np(b), np.asarray(a))
    n, r = tnl.effective_iterations(tt([3.0]), 0.05)
    assert int(n) == 1 and int(r) == tnl.STOP_MAX_ITERATIONS


def test_bounds_equal():
    js = jsm.make_structure(jsm.free_interior_mask(4, N), 3, N)
    ts = convert.structure_from_fields(js)
    cases = (((), None, None),
             (((1, 2.5), (2, -4.0)), (0.0, -1.0, 0.0), (6.0, 7.0, 8.0)),
             (((3, 1.0),), None, (1.0, 2.0, 3.0)))
    for cons, mn, mx in cases:
        ref = jnl.free_derivative_bounds(
            js, [jnl.MagnitudeConstraint(*c) for c in cons], mn, mx,
            dtype=jnp.float64)
        ours = tnl.free_derivative_bounds(
            ts, [tnl.MagnitudeConstraint(*c) for c in cons], mn, mx,
            dtype=torch.float64, device="cpu")
        for a, b in zip(ref, ours):
            np.testing.assert_array_equal(to_np(b), np.asarray(a))
    occ = np.zeros((20, 20, 10), bool)
    occ[3, 4, 5] = True
    jf = jmtg.esdf_from_occupancy(occ, (0.5, -1.0, 0.25), 0.1)
    tf = mtt.esdf_from_occupancy(occ, (0.5, -1.0, 0.25), 0.1, device="cpu")
    for a, b in zip(jnl.map_bounds(jf), tnl.map_bounds(tf)):
        np.testing.assert_array_equal(b, a)


def test_format_result_equal():
    js, ts, d_fixed, times = build(k=2, seed=1)
    jp, tp = params_pair(objective=jnl.Objective.FREE_CONSTRAINTS,
                         max_iterations=3, soft_constraint_weight=10.0)
    cons = [(1, 2.0)]
    jcons = [jnl.MagnitudeConstraint(*c) for c in cons]
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp,
                       jcons)
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp,
                        [convert.magnitude_constraint_from_fields(c)
                         for c in jcons], device="cpu")
    assert tnl.format_result(ours) == jnl.format_result(ref)
    as_np = convert.nonlinear_result_to_numpy(ours)
    assert set(as_np) == set(tnl.NonlinearResult._fields)
    assert set(as_np["maxima"]) == {1}
    np.testing.assert_array_equal(as_np["cost"]["total"],
                                  to_np(ours.cost.total))
    np.testing.assert_array_equal(as_np["cost_history"],
                                  to_np(ours.cost_history))
    assert "cost trajectory" in tnl.format_result(ours)
    assert 1 <= int(ours.n_iterations) <= 3


@pytest.fixture(scope="module")
def nelder_mead_runs():
    js, ts, d_fixed, times = build()
    jp, tp = params_pair(objective=jnl.Objective.TIME, max_iterations=10,
                         time_penalty=500.0, use_soft_constraints=False)
    ref = jnl.optimize(js, jnp.asarray(d_fixed), jnp.asarray(times), jp)
    ours = tnl.optimize(ts, tt(d_fixed), tt(times), tp, device="cpu")
    return ref, ours, times


def test_nelder_mead_time_history_f64(nelder_mead_runs):
    ref, ours, times = nelder_mead_runs
    assert ours.cost_history.shape == (10,)
    np.testing.assert_allclose(to_np(ours.cost_history),
                               np.asarray(ref.cost_history), rtol=1e-9)
    np.testing.assert_allclose(to_np(ours.times), np.asarray(ref.times),
                               rtol=1e-9)
    for name, a, b in zip(ref.cost._fields, ref.cost, ours.cost):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(to_np(ours.coefficients),
                               np.asarray(ref.coefficients), rtol=1e-9,
                               atol=1e-9)
    assert int(ours.n_iterations) == int(ref.n_iterations)
    # the reference box [0.1, 2 t_init]
    t = to_np(ours.times)
    assert np.all(t >= 0.1 - 1e-9) and np.all(t <= 2.0 * times + 1e-9)


def test_nelder_mead_standalone_matches_jax():
    """``nelder_mead`` itself on a batched quadratic with a stable sort's
    ties: the JAX function vmapped over the scenarios."""
    rng = np.random.RandomState(2)
    centers = rng.randn(4, 3)
    x0 = np.zeros((4, 3))
    x0[1] = centers[1]                          # a scenario at its optimum

    def fj(x, c):
        return jnp.sum((x - c) ** 2 * jnp.arange(1.0, 4.0), axis=-1)
    ref = jax.vmap(lambda x, c: jnl.nelder_mead(
        lambda y: fj(y, c), x, 12, 0.3))(jnp.asarray(x0),
                                         jnp.asarray(centers))
    ours = tnl.nelder_mead(
        lambda y: (((y - tt(centers)) ** 2) * torch.arange(
            1.0, 4.0, dtype=torch.float64)).sum(-1), tt(x0), 12, 0.3)
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-12,
                                   atol=1e-15)


def test_batch_equals_scenarios_alone():
    """A batch of three (each its own scale of the fixed derivatives and
    times) equals the three scenarios run alone, on the joint objective's
    L-BFGS and on Nelder-Mead."""
    js, ts, d_fixed, times = build()
    df = np.stack([d_fixed, d_fixed * 1.1, d_fixed * 0.9])
    t = np.stack([times, times, times * 1.2])
    for objective, iters in (("FREE_CONSTRAINTS_AND_TIME", 10),
                             ("TIME", 6)):
        _, tp = params_pair(objective=jnl.Objective[objective],
                            max_iterations=iters, use_soft_constraints=False)
        batch = tnl.optimize(ts, tt(df), tt(t), tp, device="cpu")
        assert batch.cost.total.shape == (3,)
        assert batch.cost_history.shape == (3, iters)
        for i in range(3):
            one = tnl.optimize(ts, tt(df[i]), tt(t[i]), tp, device="cpu")
            for name in ("times", "d_free", "cost_history"):
                np.testing.assert_allclose(
                    to_np(getattr(batch, name)[i]),
                    to_np(getattr(one, name)), rtol=1e-10, atol=1e-12,
                    err_msg=f"{objective} {name} {i}")
            np.testing.assert_allclose(to_np(batch.cost.total[i]),
                                       to_np(one.cost.total), rtol=1e-10)


def test_vmapped_optimize_matches_batched():
    """test_nonlinear.py's vmapped case: the JAX package vmapped over three
    scenarios, the port on the batch."""
    js, ts, d_fixed, times = build()
    df = np.stack([d_fixed, d_fixed * 1.1, d_fixed * 0.9])
    t = np.stack([times, times, times * 1.2])
    jp, tp = params_pair(objective=jnl.Objective.FREE_CONSTRAINTS_AND_TIME,
                         max_iterations=10, use_soft_constraints=False)
    ref = jax.vmap(lambda a, b: jnl.optimize(js, a, b, jp))(
        jnp.asarray(df), jnp.asarray(t))
    ours = tnl.optimize(ts, tt(df), tt(t), tp, device="cpu")
    np.testing.assert_allclose(to_np(ours.cost_history)[:, :5],
                               np.asarray(ref.cost_history)[:, :5],
                               rtol=1e-6)
    assert np.all(to_np(ours.cost.total)
                  <= np.asarray(ref.cost.total) * 1.01)
    assert np.all(np.isfinite(to_np(ours.cost.total)))


# ---------------------------------------------------------------------------
# The linear solve's rows that do not factor.
# ---------------------------------------------------------------------------

def _nan_row_batch(dtype):
    k = 10
    std = jsm.make_structure(jsm.standard_mask(k + 1, N), 3, N)
    rng = np.random.RandomState(0)
    wp = np.cumsum(rng.uniform(0.5, 2.0, size=(4, k + 1, 3)), axis=1)
    values = np.zeros((4, k + 1, H, 3))
    values[:, :, 0] = wp
    d_fixed = np.asarray(jlinear.extract_fixed_values(std,
                                                      jnp.asarray(values)))
    times = np.full((4, k), 2.0)
    times[:, 5] = [2.0, -1.0, 1.5, 0.7]    # a negative segment time in row 1
    return std, d_fixed.astype(dtype), times.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_linear_failed_factor_gives_its_row_nan(dtype):
    """A row whose R_pp will not factor is non-finite in both packages and
    does not raise in the port; the other rows equal the JAX package's
    (float64 to rtol 1e-9; in float32 d_free, the coefficients and the cost
    no further from the float64 solve than three times the JAX package's
    float32 error), and the gradient in the times does not raise either."""
    std, d_fixed, times = _nan_row_batch(dtype)
    ts = convert.structure_from_fields(std)
    ref = jlinear.solve_linear(std, jnp.asarray(d_fixed), jnp.asarray(times))
    t = tt(times).requires_grad_(True)
    ours = tlinear.solve_linear(ts, tt(d_fixed), t)
    exact = tlinear.solve_linear(ts, tt(d_fixed, torch.float64),
                                 tt(times, torch.float64))
    good = [0, 2, 3]
    for name in ("d_free", "coefficients", "cost"):
        a, b = np.asarray(getattr(ref, name)), to_np(getattr(ours, name))
        assert not np.all(np.isfinite(a[1])), name
        assert not np.all(np.isfinite(b[1])), name
        if dtype == np.float64:
            np.testing.assert_allclose(b[good], a[good], rtol=1e-9,
                                       atol=1e-9, err_msg=name)
        else:
            e = to_np(getattr(exact, name))[good]
            err_j = np.abs(a[good] - e).max()
            err_t = np.abs(b[good] - e).max()
            assert err_t <= 3.0 * err_j + 1e-6 * np.abs(e).max(), (
                name, err_t, err_j)
    grad, = torch.autograd.grad(ours.cost[good].sum(), t)
    assert np.all(np.isfinite(to_np(grad)[good]))
    # the good rows are the bits of the same batch with the bad row mended
    mended = times.copy()
    mended[1, 5] = 2.0
    fine = tlinear.solve_linear(ts, tt(d_fixed), tt(mended))
    np.testing.assert_array_equal(to_np(fine.d_free)[good],
                                  to_np(ours.d_free)[good])
    np.testing.assert_array_equal(to_np(fine.cost)[good],
                                  to_np(ours.cost)[good])
