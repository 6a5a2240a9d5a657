"""The rest of the port's linear foundations held against the JAX package
on the same NumPy inputs: polynomial helpers (``ops.basis``), the SPD solve,
the cost matrix, the Bernstein basis, the linear solve's ``method``, the
cost gradient, the compact packing, the one-call solve from positions, the
vertex helpers, the QCQP warm start, and the package's public names.

Tolerances: float64 agrees to rtol 1e-9 where both sides compute the same
sums (1e-8 where the JAX package inverts by its matmul-only Schur inverse
and the port by Cholesky); float32 to 1e-4 of scale; NumPy tables and index
maps exactly.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.models import vertex as jvertex
from mav_tube_trajectory_generation_tpu.ops import basis as jbasis
from mav_tube_trajectory_generation_tpu.ops import bezier as jbezier
from mav_tube_trajectory_generation_tpu.ops import linalg as jlinalg
from mav_tube_trajectory_generation_tpu.ops import qmatrix as jqmatrix
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch.models import vertex as tvertex
from mav_tube_trajectory_generation_tpu_torch.ops import basis as tbasis
from mav_tube_trajectory_generation_tpu_torch.ops import bezier as tbezier
from mav_tube_trajectory_generation_tpu_torch.ops import linalg as tlinalg
from mav_tube_trajectory_generation_tpu_torch.ops import qmatrix as tqmatrix
from mav_tube_trajectory_generation_tpu_torch.solver import linear as tlinear

from torch_port_util import N, problem, to_np, tt

H = N // 2
F64 = dict(rtol=1e-9, atol=1e-12)

# The JAX package's public names that belong to modules not ported yet:
# none since the sharded router.
NOT_YET_PORTED = set()


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


def test_package_exports_the_jax_names():
    """Every public name of the JAX package is the port's, except those of
    the modules still to port, and each of those is really absent."""
    missing = _public(jmtg) - _public(mtt)
    assert missing == NOT_YET_PORTED
    for name in ("solve_linear_banded", "block_tridiag_solve", "Trajectory",
                 "Extremum", "max_magnitude", "min_max_magnitude",
                 "solve_from_positions", "position_constrained_warmstart",
                 "derivative_cost_and_grad",
                 "compact_from_segment_derivatives",
                 "create_random_vertices_1d", "create_square_vertices",
                 "optimize", "optimize_time_gradient", "esdf_from_occupancy",
                 "distance_at", "collision_potential", "make_obstacle_grid",
                 "solve_qcqp_strict_sharded"):
        assert callable(getattr(mtt, name)), name


# ---------------------------------------------------------------------------
# ops.basis, ops.linalg, ops.qmatrix, ops.bezier
# ---------------------------------------------------------------------------

def test_polyval_all_f64():
    rng = np.random.RandomState(0)
    coeffs = rng.randn(4, N)
    t = rng.uniform(0.1, 2.0, size=4)
    ours = tbasis.polyval_all(tt(coeffs), tt(t), 4)
    assert ours.shape == (5, 4)
    np.testing.assert_allclose(
        to_np(ours), np.asarray(jbasis.polyval_all(jnp.asarray(coeffs),
                                                   jnp.asarray(t), 4)), **F64)


def test_derivative_coefficients():
    rng = np.random.RandomState(1)
    coeffs = rng.randn(3, 10)
    for d in range(0, 12):
        ours = to_np(tbasis.derivative_coefficients(tt(coeffs), d))
        np.testing.assert_allclose(
            ours, np.asarray(jbasis.derivative_coefficients(
                jnp.asarray(coeffs), d)), rtol=1e-12, atol=0)
        for i in range(3):
            oracle = np.polynomial.Polynomial(coeffs[i]).deriv(d).coef
            if d < 10:
                np.testing.assert_allclose(ours[i, :len(oracle)], oracle,
                                           rtol=1e-12)
                assert np.all(ours[i, len(oracle):] == 0.0)
            else:
                assert np.all(ours[i] == 0.0)
    f32 = tbasis.derivative_coefficients(tt(coeffs, torch.float32), 2)
    assert f32.dtype == torch.float32


def test_convolve_full():
    """Against np.convolve and the JAX function, with broadcasting batch
    dimensions; the exact example of test_polynomial.cpp:68-79."""
    rng = np.random.RandomState(2)
    a = rng.randn(4, 9)
    b = rng.randn(3, 1, 8)
    ours = to_np(tbasis.convolve_full(tt(a), tt(b)))
    assert ours.shape == (3, 4, 16)
    np.testing.assert_allclose(
        ours, np.asarray(jbasis.convolve_full(jnp.asarray(a),
                                              jnp.asarray(b))), **F64)
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(ours[i, j], np.convolve(a[j], b[i, 0]),
                                       rtol=1e-12, atol=1e-14)
    exact = to_np(tbasis.convolve_full(tt([1.0, 2.0, 3.0]), tt([0.0, 1.0])))
    np.testing.assert_array_equal(exact, [0.0, 1.0, 2.0, 3.0])


def test_pad_coefficients_preserves_polynomial():
    """Zero-padding leaves evaluations unchanged; padding down is a no-op
    (polynomial.cpp:183-198)."""
    c = tt([1.0, -2.0, 0.5])
    padded = tbasis.pad_coefficients(c, 7)
    assert padded.shape == (7,)
    np.testing.assert_array_equal(
        to_np(padded), np.asarray(jbasis.pad_coefficients(
            jnp.asarray([1.0, -2.0, 0.5]), 7)))
    ts = tt(np.linspace(-1.0, 2.0, 11))
    np.testing.assert_allclose(to_np(tbasis.polyval(padded[None], ts, 0)),
                               to_np(tbasis.polyval(c[None], ts, 0)),
                               rtol=1e-12)
    assert tbasis.pad_coefficients(c, 2) is c


def _random_spd(rng, batch, n, cond):
    q, _ = np.linalg.qr(rng.randn(batch, n, n))
    eig = np.logspace(0, np.log10(cond), n)
    return np.einsum('bij,j,bkj->bik', q, eig, q)


def test_spd_solve_vector_and_matrix_rhs():
    """float64, cond 1e5, n 33: the solution, and the JAX function's (an
    inverse by another route), to 1e-6 (the JAX test's tolerance)."""
    rng = np.random.RandomState(5)
    a = _random_spd(rng, 2, 33, 1e5)
    x_vec = rng.randn(2, 33)
    x_mat = rng.randn(2, 33, 4)
    b_vec = np.einsum('bij,bj->bi', a, x_vec)
    b_mat = a @ x_mat
    got_vec = to_np(tlinalg.spd_solve(tt(a), tt(b_vec)))
    got_mat = to_np(tlinalg.spd_solve(tt(a), tt(b_mat)))
    assert got_vec.shape == (2, 33) and got_mat.shape == (2, 33, 4)
    np.testing.assert_allclose(got_vec, x_vec, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got_mat, x_mat, rtol=1e-6, atol=1e-8)
    ref = np.asarray(jlinalg.spd_solve(jnp.asarray(a), jnp.asarray(b_mat)))
    np.testing.assert_allclose(got_mat, ref, rtol=1e-6, atol=1e-8)


def test_quadratic_cost():
    """Q(d, T) against the JAX function and the reference formula
    (computeQuadraticCostJacobian, impl:557-573), batched times; float32
    stays float32."""
    t = np.array([0.5, 1.0, 3.2])
    bc = tbasis.base_coefficients(N)
    for derivative in (2, 3, 4):
        ours = to_np(tqmatrix.quadratic_cost(N, derivative, tt(t)))
        np.testing.assert_allclose(
            ours, np.asarray(jqmatrix.quadratic_cost(N, derivative,
                                                     jnp.asarray(t))), **F64)
        for i, ti in enumerate(t):
            ref = np.zeros((N, N))
            for r in range(derivative, N):
                for c in range(derivative, N):
                    e = r + c + 1 - 2 * derivative
                    ref[r, c] = bc[derivative, r] * bc[derivative, c] \
                        * ti ** e * 2.0 / e
            np.testing.assert_allclose(ours[i], ref, rtol=1e-12, atol=1e-12)
    assert tqmatrix.quadratic_cost(N, 4, tt(t, torch.float32)).dtype == \
        torch.float32


def test_bernstein_basis_equal():
    tau = np.linspace(0, 1, 9)
    for n_points in (4, 10):
        np.testing.assert_array_equal(tbezier.bernstein_basis(n_points, tau),
                                      jbezier.bernstein_basis(n_points, tau))


# ---------------------------------------------------------------------------
# solver.linear
# ---------------------------------------------------------------------------

def _vertex_problem(k=5, seed=7, dim=3):
    verts = jmtg.create_random_vertices(H - 1, k, -5 * np.ones(dim),
                                        5 * np.ones(dim), seed)
    js, values = jmtg.structure_from_vertices(verts, N, jmtg.SNAP)
    ts = mtt.structure_from_fields(js)
    times = np.asarray(jmtg.estimate_segment_times(verts, 3.0, 5.0))
    df = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    return js, ts, df, times


def test_derivative_cost_and_grad():
    """J_d and its gradient against the JAX function and autograd; the
    gradient vanishes at the linear solution; J_d is twice the cost."""
    js, ts, df, times = _vertex_problem()
    d_free = np.random.RandomState(3).randn(ts.n_free, 3)
    dp = tt(d_free).requires_grad_(True)
    cost, grad = mtt.derivative_cost_and_grad(ts, tt(df), dp, tt(times))
    jcost, jgrad = jlinear.derivative_cost_and_grad(
        js, jnp.asarray(df), jnp.asarray(d_free), jnp.asarray(times))
    assert float(cost.detach()) == pytest.approx(float(jcost), rel=1e-10)
    np.testing.assert_allclose(to_np(grad), np.asarray(jgrad), rtol=1e-9,
                               atol=1e-9)
    auto, = torch.autograd.grad(cost, dp)
    np.testing.assert_allclose(to_np(grad), to_np(auto), rtol=1e-8,
                               atol=1e-8)
    sol = mtt.solve_linear(ts, tt(df), tt(times))
    j_opt, g_opt = mtt.derivative_cost_and_grad(ts, tt(df), sol.d_free,
                                                tt(times))
    assert float(g_opt.abs().max()) < 1e-5
    assert float(j_opt) == pytest.approx(2 * float(sol.cost), rel=1e-9)


def test_packing_roundtrip():
    """d -> segment derivatives -> M^+ -> d, and through the coefficients
    (ConstraintPacking, test_polynomial_optimization.cpp:511-570), against
    the JAX function."""
    js, ts, df, times = _vertex_problem(k=6, seed=17)
    sol = mtt.solve_linear(ts, tt(df), tt(times))
    d_seg = tlinear.segment_derivatives(ts, sol.d_fixed, sol.d_free)
    compact = mtt.compact_from_segment_derivatives(ts, d_seg)
    expect = torch.cat([sol.d_fixed, sol.d_free], dim=-2)
    np.testing.assert_allclose(to_np(compact), to_np(expect), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(
        to_np(compact), np.asarray(jmtg.compact_from_segment_derivatives(
            js, jnp.asarray(to_np(d_seg)))), **F64)
    back = tqmatrix.endpoint_derivatives_from_coefficients(sol.coefficients,
                                                           tt(times))
    np.testing.assert_allclose(
        to_np(mtt.compact_from_segment_derivatives(ts, back)), to_np(expect),
        rtol=1e-6, atol=1e-8)
    batched = mtt.compact_from_segment_derivatives(ts, d_seg.expand(2, -1, -1,
                                                                   -1))
    np.testing.assert_array_equal(to_np(batched[1]), to_np(compact))


def test_solve_from_positions():
    """setupFromPositons (linear.h:79-80): the JAX function's structure and
    coefficients; the waypoints are hit and the ends at rest."""
    positions = np.array([[0.0], [2.0], [5.0]])
    ts, sol = mtt.solve_from_positions(positions, [1.5, 2.0], device="cpu")
    js, jsol = jmtg.solve_from_positions(positions, [1.5, 2.0])
    assert ts == mtt.structure_from_fields(js)
    assert sol.coefficients.dtype == torch.float64
    np.testing.assert_allclose(to_np(sol.coefficients),
                               np.asarray(jsol.coefficients), **F64)
    traj = mtt.Trajectory(sol.coefficients, sol.times)
    np.testing.assert_allclose(
        to_np(mtt.evaluate(traj, tt([0.0, 1.5, 3.5]))).ravel(),
        [0.0, 2.0, 5.0], atol=1e-9)
    np.testing.assert_allclose(to_np(mtt.evaluate(traj, tt([0.0, 3.5]), 1)),
                               0.0, atol=1e-9)
    if not torch.cuda.is_available():     # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mtt.solve_from_positions(positions, [1.5, 2.0])


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-8),
                                        (np.float32, 1e-4)])
def test_solve_linear_schur_method(dtype, rtol):
    """method="schur" (spd_inverse and a product) against the Cholesky
    method and the JAX package's "schur"; an unknown method raises."""
    js, ts, df, times = _vertex_problem(k=6, seed=4)
    df, times = df.astype(dtype), times.astype(dtype)
    ours = mtt.solve_linear(ts, tt(df), tt(times), method="schur")
    chol = mtt.solve_linear(ts, tt(df), tt(times))
    ref = jax.jit(lambda a, b: jmtg.solve_linear(js, a, b, method="schur"))(
        jnp.asarray(df), jnp.asarray(times))
    scale = float(chol.coefficients.abs().max())
    for other in (to_np(chol.coefficients), np.asarray(ref.coefficients)):
        np.testing.assert_allclose(to_np(ours.coefficients), other,
                                   rtol=rtol, atol=rtol * scale)
    with pytest.raises(ValueError, match="method"):
        mtt.solve_linear(ts, tt(df), tt(times), method="qr")


# ---------------------------------------------------------------------------
# models.vertex
# ---------------------------------------------------------------------------

def _same_vertices(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dimension == b.dimension
        assert sorted(a.constraints) == sorted(b.constraints)
        for k in a.constraints:
            np.testing.assert_array_equal(a.constraints[k], b.constraints[k])


def test_vertex_generators_and_subdimension():
    _same_vertices(tvertex.create_random_vertices_1d(3, 6, -2.0, 5.0, 4),
                   jvertex.create_random_vertices_1d(3, 6, -2.0, 5.0, 4))
    _same_vertices(mtt.create_square_vertices(2, [1.0, 2.0, 0.5], 3.0, 2),
                   jmtg.create_square_vertices(2, [1.0, 2.0, 0.5], 3.0, 2))
    ours = tvertex.create_random_vertices(4, 3, np.zeros(3), np.ones(3) * 4,
                                          seed=2)
    ref = jvertex.create_random_vertices(4, 3, np.zeros(3), np.ones(3) * 4,
                                         seed=2)
    _same_vertices([v.get_subdimension([2, 0], 2) for v in ours],
                   [v.get_subdimension([2, 0], 2) for v in ref])
    sub = ours[0].get_subdimension([1], 1)
    assert sub.dimension == 1 and sorted(sub.constraints) == [0, 1]


# ---------------------------------------------------------------------------
# solver.qcqp.position_constrained_warmstart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["cholesky", "schur"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-8),
                                        (np.float32, 1e-4)])
def test_position_constrained_warmstart(method, dtype, rtol):
    """x0 of a batch of 8 K=4 scenarios against the JAX function (under
    jax.vmap), one scenario unbatched against the same row."""
    p = problem(k=4, batch=8, seed=3, dtype=dtype)
    free_j = jsm.make_structure(jsm.free_interior_mask(5, N), 3, N)
    free_t = mtt.structure_from_fields(free_j)
    ours = mtt.position_constrained_warmstart(free_t, tt(p["values"]),
                                              tt(p["times"]), method=method)
    ref = jax.jit(jax.vmap(lambda v, t: jqcqp.position_constrained_warmstart(
        free_j, v, t, method=method)))(jnp.asarray(p["values"]),
                                       jnp.asarray(p["times"]))
    assert ours.shape == (8, free_t.n_free, 3)
    assert ours.dtype == tt(p["times"]).dtype
    scale = float(ours.abs().max())
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=rtol,
                               atol=rtol * scale)
    one = mtt.position_constrained_warmstart(free_t, tt(p["values"][2]),
                                             tt(p["times"][2]), method=method)
    np.testing.assert_allclose(to_np(one), to_np(ours[2]), rtol=rtol,
                               atol=rtol * scale)


def test_warmstart_then_solve_qcqp():
    """The JAX package's warm-start test (test_qcqp.py:147): the port's x0
    seeds the port's solve_qcqp, which reaches a violation < 1e-3."""
    k = 4
    rng = np.random.RandomState(3)
    waypoints = np.cumsum(rng.uniform(0.8, 1.5, size=(k + 1, 3)),
                          axis=0) * 4.0 / k
    free = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    values = np.zeros((k + 1, H, 3))
    values[:, 0] = waypoints
    times = tvertex.segment_times_nfabian(tt(waypoints), 2.0, 2.0)
    d_fixed = mtt.extract_fixed_values(free, tt(values))
    x0 = mtt.position_constrained_warmstart(free, tt(values), times)
    sol = mtt.solve_qcqp(free, d_fixed, times, tt(waypoints),
                         torch.full((k, 2), 0.6, dtype=torch.float64),
                         x0=x0, device="cpu")
    assert float(sol.max_violation) < 1e-3
