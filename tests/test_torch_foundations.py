"""The port's foundations (structure, tables, vertex helpers, linear solve)
held against the JAX package on the same NumPy inputs.

Tolerances: index arrays and float64 tables must be EXACTLY equal (they are
the same NumPy code); float64 tensor functions agree to rtol 1e-9 (only the
order of a few sums differs between XLA and PyTorch on the CPU); float32
functions state their own.
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.models import vertex as jvertex
from mav_tube_trajectory_generation_tpu.ops import basis as jbasis
from mav_tube_trajectory_generation_tpu.ops import bezier as jbezier
from mav_tube_trajectory_generation_tpu.ops import qmatrix as jqmatrix
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch.models import vertex as tvertex
from mav_tube_trajectory_generation_tpu_torch.ops import basis as tbasis
from mav_tube_trajectory_generation_tpu_torch.ops import bezier as tbezier
from mav_tube_trajectory_generation_tpu_torch.ops import linalg as tlinalg
from mav_tube_trajectory_generation_tpu_torch.ops import qmatrix as tqmatrix
from mav_tube_trajectory_generation_tpu_torch.solver import linear as tlinear
from mav_tube_trajectory_generation_tpu_torch.solver import structure as tsm

from torch_port_util import N, problem, to_np, tt

F64 = dict(rtol=1e-9, atol=1e-12)


def _structures(kind, k, n=N, dim=3):
    mask_fn = {"standard": "standard_mask", "free": "free_interior_mask"}[kind]
    js = jsm.make_structure(getattr(jsm, mask_fn)(k + 1, n), dim, n)
    ts = tsm.make_structure(getattr(tsm, mask_fn)(k + 1, n), dim, n)
    return js, ts


# ---------------------------------------------------------------------------
# Static structure and tables: exact.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,k,n", [("standard", 1, 10), ("standard", 4, 10),
                                      ("free", 4, 10), ("free", 10, 10),
                                      ("free", 3, 12)])
def test_structure_index_arrays_equal(kind, k, n):
    js, ts = _structures(kind, k, n)
    for name in ("fixed_mask", "gather_idx", "fixed_cols", "free_cols"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
        assert getattr(ts, name).dtype == getattr(js, name).dtype
    for name in ("n_vertices", "half_n", "n_fixed", "n_free", "n_total",
                 "n_all_constraints", "derivative_to_optimize"):
        assert getattr(ts, name) == getattr(js, name)
    np.testing.assert_array_equal(ts.one_hot_m(), js.one_hot_m())
    np.testing.assert_array_equal(ts.fixed_value_gather(),
                                  js.fixed_value_gather())
    np.testing.assert_array_equal(ts.free_value_gather(),
                                  js.free_value_gather())
    # convert.structure_from_fields rebuilds the same family from the JAX
    # package's object without importing its module.
    assert mtt.structure_from_fields(js) == ts


def test_structure_rejects_bad_input():
    with pytest.raises(ValueError):
        tsm.make_structure(tsm.standard_mask(3, 9), 3, 9)
    with pytest.raises(ValueError):
        tsm.make_structure(tsm.standard_mask(3, 10), 3, 10, 7)
    with pytest.raises(ValueError):
        tsm.make_structure(np.ones((1, 5), bool), 3, 10)


@pytest.mark.parametrize("n", [8, 10, 12])
def test_unit_tables_exact(n):
    np.testing.assert_array_equal(tbasis.base_coefficients(n),
                                  jbasis.base_coefficients(n))
    for d, t in ((0, 0.0), (2, 1.0), (3, 2.5)):
        np.testing.assert_array_equal(
            tbasis.base_coeffs_with_time(n, d, t),
            jbasis.base_coeffs_with_time(n, d, t))
    for fn in ("row_derivative_orders", "mapping_matrix_unit",
               "inv_mapping_matrix_unit"):
        np.testing.assert_array_equal(getattr(tqmatrix, fn)(n),
                                      getattr(jqmatrix, fn)(n))
    for d in range(n // 2):
        np.testing.assert_array_equal(tqmatrix.quadratic_cost_unit(n, d),
                                      jqmatrix.quadratic_cost_unit(n, d))
        np.testing.assert_array_equal(tqmatrix.hessian_unit(n, d),
                                      jqmatrix.hessian_unit(n, d))
    for fn in ("bezier_derivative_matrix_unit",
               "inv_control_point_mapping_unit"):
        np.testing.assert_array_equal(getattr(tbezier, fn)(n),
                                      getattr(jbezier, fn)(n))


def test_motion_defines_equal():
    from mav_tube_trajectory_generation_tpu import motion_defines as jm
    from mav_tube_trajectory_generation_tpu_torch import motion_defines as tm
    for name in ("POSITION", "VELOCITY", "ACCELERATION", "JERK", "SNAP",
                 "ORIENTATION", "ANGULAR_VELOCITY", "ANGULAR_ACCELERATION",
                 "INVALID"):
        assert getattr(tm, name) == getattr(jm, name)
    for d in range(-1, 6):
        s = jm.position_derivative_to_string(d)
        assert tm.position_derivative_to_string(d) == s
        assert tm.position_derivative_to_int(s) == \
            jm.position_derivative_to_int(s)
        assert tm.orientation_derivative_to_string(d) == \
            jm.orientation_derivative_to_string(d)


# ---------------------------------------------------------------------------
# Tensor functions in float64: rtol 1e-9 (summation order only).
# ---------------------------------------------------------------------------

def test_polyval_and_powers_f64():
    rng = np.random.RandomState(1)
    coeffs = rng.randn(5, N)
    t = rng.uniform(0.1, 2.0, size=5)
    for d in (0, 1, 4, 9, 11):
        np.testing.assert_allclose(
            to_np(tbasis.polyval(tt(coeffs), tt(t), d)),
            np.asarray(jbasis.polyval(jnp.asarray(coeffs), jnp.asarray(t),
                                      d)), **F64)
    np.testing.assert_allclose(to_np(tbasis.powers(tt(t), 6)),
                               np.asarray(jbasis.powers(jnp.asarray(t), 6)),
                               **F64)


@pytest.mark.parametrize("derivative", [2, 3, 4])
def test_hessian_blocks_f64(derivative):
    times = problem(k=5, batch=3, seed=2, dtype=np.float64)["times"]
    ours = tqmatrix.hessian_blocks(tt(times), N, derivative)
    ref = jqmatrix.hessian_blocks(jnp.asarray(times), N, derivative)
    assert ours.dtype == torch.float64 and ours.shape == (3, 5, N, N)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **F64)


def test_hessian_blocks_stays_f32():
    # The float64 tables must be cast to the working dtype, never promote it.
    times = problem(k=3, batch=2, seed=2)["times"]
    ours = tqmatrix.hessian_blocks(tt(times), N, 4)
    assert ours.dtype == torch.float32
    ref = jqmatrix.hessian_blocks(jnp.asarray(times), N, 4)
    assert ref.dtype == jnp.float32
    # float32 pow/exp differ by a few ulp between the two libraries.
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=2e-5)


def test_mapping_matrices_and_coefficient_maps_f64():
    rng = np.random.RandomState(3)
    times = rng.uniform(0.5, 3.0, size=(2, 4))
    for fn in ("mapping_matrix", "inv_mapping_matrix"):
        np.testing.assert_allclose(
            to_np(getattr(tqmatrix, fn)(tt(times), N)),
            np.asarray(getattr(jqmatrix, fn)(jnp.asarray(times), N)), **F64)
    d_seg = rng.randn(2, 4, N, 3)
    co = tqmatrix.coefficients_from_endpoint_derivatives(tt(d_seg), tt(times))
    np.testing.assert_allclose(
        to_np(co), np.asarray(jqmatrix.coefficients_from_endpoint_derivatives(
            jnp.asarray(d_seg), jnp.asarray(times))), **F64)
    back = tqmatrix.endpoint_derivatives_from_coefficients(co, tt(times))
    np.testing.assert_allclose(
        to_np(back),
        np.asarray(jqmatrix.endpoint_derivatives_from_coefficients(
            jnp.asarray(to_np(co)), jnp.asarray(times))), **F64)
    # round trip: conditioning of A(T) costs a few digits
    np.testing.assert_allclose(to_np(back), d_seg, rtol=1e-7, atol=1e-8)


def test_control_points_f64():
    rng = np.random.RandomState(4)
    times = rng.uniform(0.5, 3.0, size=(2, 4))
    d_seg = rng.randn(2, 4, N, 3)
    np.testing.assert_allclose(
        to_np(tbezier.control_points_from_endpoint_derivatives(
            tt(d_seg), tt(times))),
        np.asarray(jbezier.control_points_from_endpoint_derivatives(
            jnp.asarray(d_seg), jnp.asarray(times))), **F64)


@pytest.mark.parametrize("kind,k", [("standard", 4), ("free", 4),
                                    ("standard", 10)])
def test_assemble_r_f64(kind, k):
    js, ts = _structures(kind, k)
    times = problem(k=k, batch=3, seed=5, dtype=np.float64)["times"]
    ours = tlinear.assemble_r(ts, tt(times))
    ref = jlinear.assemble_r(js, jnp.asarray(times))
    assert ours.shape == (3, ts.n_total, ts.n_total)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **F64)


@pytest.mark.parametrize("kind", ["standard", "free"])
def test_extract_fixed_values_exact(kind):
    js, ts = _structures(kind, 4)
    values = np.random.RandomState(6).randn(3, 5, 5, 3)
    np.testing.assert_array_equal(
        to_np(tlinear.extract_fixed_values(ts, tt(values))),
        np.asarray(jlinear.extract_fixed_values(js, jnp.asarray(values))))


@pytest.mark.parametrize("kind,k", [("standard", 4), ("standard", 10),
                                    ("free", 4)])
def test_solve_linear_f64(kind, k):
    js, ts = _structures(kind, k)
    p = problem(k=k, batch=4, seed=7, dtype=np.float64)
    df_j = jlinear.extract_fixed_values(js, jnp.asarray(p["values"]))
    ref = jlinear.solve_linear(js, df_j, jnp.asarray(p["times"]))
    df_t = tlinear.extract_fixed_values(ts, tt(p["values"]))
    ours = tlinear.solve_linear(ts, df_t, tt(p["times"]))
    assert isinstance(ours, tlinear.LinearSolution)
    # rtol 1e-9 on the factorization's output would be too tight for the
    # free family (R_pp is worse conditioned): 1e-7 there.
    tol = F64 if kind == "standard" else dict(rtol=1e-7, atol=1e-9)
    for name in ("d_free", "coefficients", "cost"):
        np.testing.assert_allclose(to_np(getattr(ours, name)),
                                   np.asarray(getattr(ref, name)), **tol)
    sol_np = mtt.solution_to_numpy(ours)
    assert set(sol_np) == set(tlinear.LinearSolution._fields)


def test_solve_linear_broadcasts_unbatched_d_fixed():
    js, ts = _structures("standard", 4)
    p = problem(k=4, batch=3, seed=8, dtype=np.float64)
    df = tlinear.extract_fixed_values(ts, tt(p["values"][0]))
    times = tt(p["times"])
    ours = tlinear.solve_linear(ts, df, times)
    assert ours.coefficients.shape == (3, 4, N, 3)
    one = tlinear.solve_linear(ts, df, times[1])
    np.testing.assert_allclose(to_np(ours.coefficients[1]),
                               to_np(one.coefficients), rtol=1e-12)


def test_solve_linear_with_free_f64():
    js, ts = _structures("standard", 4)
    p = problem(k=4, batch=4, seed=9, dtype=np.float64)
    d_free = np.random.RandomState(10).randn(4, ts.n_free, 3)
    df_j = jlinear.extract_fixed_values(js, jnp.asarray(p["values"]))
    ref = jlinear.solve_linear_with_free(js, df_j, jnp.asarray(d_free),
                                         jnp.asarray(p["times"]))
    ours = tlinear.solve_linear_with_free(
        ts, tt(np.asarray(df_j)), tt(d_free), tt(p["times"]))
    for name in ("coefficients", "cost"):
        np.testing.assert_allclose(to_np(getattr(ours, name)),
                                   np.asarray(getattr(ref, name)), **F64)


def test_solve_linear_f32_against_f64():
    # float32 through the equilibrated Cholesky: cond(R_pp_eq) ~5e2, so
    # ~1e-4 relative on the free derivatives, as the reference measured.
    _, ts = _structures("standard", 4)
    p = problem(k=4, batch=4, seed=7, dtype=np.float64)
    df = tlinear.extract_fixed_values(ts, tt(p["values"]))
    s64 = tlinear.solve_linear(ts, df, tt(p["times"]))
    s32 = tlinear.solve_linear(ts, df.float(), tt(p["times"]).float())
    assert s32.coefficients.dtype == torch.float32
    np.testing.assert_allclose(to_np(s32.cost), to_np(s64.cost), rtol=2e-4)


def test_two_vertices_golden_coefficients():
    """Golden Matlab coefficients (TwoVerticesSetup, fully constrained)."""
    start = mtt.Vertex(1)
    start.add_constraint(mtt.POSITION, 0.0)
    goal = mtt.Vertex(1)
    goal.add_constraint(mtt.POSITION, 5.0)
    for d in range(1, 5):
        start.add_constraint(d, 0.0)
        goal.add_constraint(d, 0.0)
    structure, values = mtt.structure_from_vertices([start, goal], N,
                                                    mtt.SNAP)
    d_fixed = mtt.extract_fixed_values(structure, tt(values))
    sol = mtt.solve_linear(structure, d_fixed, tt(np.array([5.0])))
    matlab_coeffs = np.array([
        -0.000000000000004, 0.000000000000004, -0.000000000000006,
        0.000000000000003, -0.000000000000001, 0.201600000000015,
        -0.134400000000012, 0.034560000000004, -0.004032000000000,
        0.000179200000000])
    np.testing.assert_allclose(to_np(sol.coefficients)[0, :, 0],
                               matlab_coeffs, atol=1e-10)


def test_spd_inverse():
    rng = np.random.RandomState(11)
    a = rng.randn(6, 15, 15)
    a = a @ a.transpose(0, 2, 1) + 15 * np.eye(15)
    a *= np.logspace(-3, 3, 15)[:, None] * np.logspace(-3, 3, 15)[None, :]
    inv = tlinalg.spd_inverse(tt(a))
    np.testing.assert_allclose(to_np(inv), np.linalg.inv(a), rtol=1e-9)
    np.testing.assert_array_equal(to_np(inv), to_np(inv.transpose(-1, -2)))
    inv32 = tlinalg.spd_inverse(tt(a, torch.float32))
    assert inv32.dtype == torch.float32
    # equilibrated cond ~3: float32 keeps ~5 digits
    np.testing.assert_allclose(to_np(inv32), np.linalg.inv(a), rtol=2e-4,
                               atol=1e-7 * np.abs(np.linalg.inv(a)).max())


# ---------------------------------------------------------------------------
# Vertex helpers and the benchmark's input generator.
# ---------------------------------------------------------------------------

def test_random_vertices_and_arrays_equal():
    kw = dict(n_segments=6, pos_min=np.zeros(3), pos_max=10 * np.ones(3),
              seed=3)
    jv = jvertex.create_random_vertices(4, **kw)
    tv = tvertex.create_random_vertices(4, **kw)
    jm_, jvals = jvertex.vertices_to_arrays(jv)
    tm_, tvals = tvertex.vertices_to_arrays(tv)
    np.testing.assert_array_equal(tm_, jm_)
    np.testing.assert_array_equal(tvals, jvals)
    ts, _ = tvertex.structure_from_vertices(tv)
    js, _ = jvertex.structure_from_vertices(jv)
    np.testing.assert_array_equal(ts.gather_idx, js.gather_idx)
    for fn in ("estimate_segment_times", "estimate_segment_times_nfabian",
               "estimate_segment_times_velocity_ramp"):
        np.testing.assert_allclose(getattr(tvertex, fn)(tv, 3.0, 5.0),
                                   getattr(jvertex, fn)(jv, 3.0, 5.0),
                                   rtol=1e-12)
    assert tv[0].is_equal_tol(tv[0], 0.0) and not tv[0].is_equal_tol(tv[1], 1)
    with pytest.warns(UserWarning):
        v = tvertex.Vertex(3)
        v.add_constraint(7, np.zeros(3))
        tvertex.vertices_to_arrays([v, v])


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_segment_times_batched(dtype, rtol):
    # float32: exp and the norm round differently in the two libraries by
    # an ulp or two; 1e-6 relative is "the last bits that matter".
    wp = problem(k=6, batch=5, seed=12, dtype=dtype)["waypoints"]
    ours = tvertex.segment_times_nfabian(tt(wp), 3.0, 5.0)
    ref = jvertex.segment_times_nfabian(jnp.asarray(wp), 3.0, 5.0)
    assert to_np(ours).dtype == dtype == np.asarray(ref).dtype
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=rtol)
    ours = tvertex.segment_times_velocity_ramp(tt(wp), 3.0, 5.0)
    ref = jvertex.segment_times_velocity_ramp(jnp.asarray(wp), 3.0, 5.0)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=rtol)


def test_make_inputs_matches_bench():
    import bench
    (std, free, df_std, df_free, times, waypoints, radii,
     values) = bench.make_inputs(4, 16, seed=5)
    sc = mtt.make_inputs(4, 16, seed=5, device="cpu")
    assert mtt.structure_from_fields(std) == sc.std
    assert mtt.structure_from_fields(free) == sc.free
    for ours, ref in ((sc.d_fixed_std, df_std), (sc.d_fixed_free, df_free),
                      (sc.waypoints, waypoints), (sc.radii, radii),
                      (sc.values, values)):
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(to_np(ours), np.asarray(ref))
    assert sc.times.dtype == torch.float32
    np.testing.assert_allclose(to_np(sc.times), np.asarray(times), rtol=1e-6)


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legitimate")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mtt.make_inputs(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mtt.pre_from_numpy({})


def test_port_imports_without_jax():
    """The port must import (and solve on the host: the headline, its
    routes, the banded linear solve, the extrema, the distance field and
    the nonlinear optimizer) in a process where neither jax nor the JAX
    package can be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mav_tube_trajectory_generation_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import mav_tube_trajectory_generation_tpu_torch as m\n"
        "sc = m.make_inputs(4, 2, device='cpu')\n"
        "s = m.solve_qcqp_batch(sc.free, sc.d_fixed_free, sc.times,\n"
        "    sc.waypoints, sc.radii, m.ADMMConfig(n_stages=1, n_iters=5),\n"
        "    warmstart_values=sc.values, device='cpu')\n"
        "assert torch.isfinite(s.cost).all()\n"
        "for cfg in (m.ADMMConfig(n_stages=2, n_iters=5, kkt_apply='inverse'),\n"
        "            m.ADMMConfig(n_stages=2, n_iters=5, band_gram='pallas_db'),\n"
        "            m.ADMMConfig(n_stages=2, n_iters=5, gt_assembly='kernel')):\n"
        "    s = m.solve_qcqp_batch(sc.free, sc.d_fixed_free, sc.times,\n"
        "        sc.waypoints, sc.radii, cfg, warmstart_values=sc.values,\n"
        "        device='cpu')\n"
        "    assert torch.isfinite(s.cost).all()\n"
        "s2 = m.make_inputs(2, 2, device='cpu')\n"
        "s = m.solve_qcqp_batch(s2.free, s2.d_fixed_free, s2.times,\n"
        "    s2.waypoints, s2.radii, m.ADMMConfig(n_stages=1, n_iters=5),\n"
        "    warmstart_values=s2.values, device='cpu')\n"
        "assert torch.isfinite(s.cost).all()\n"
        "s3 = m.make_inputs(5, 2, device='cpu')\n"
        "b = m.solve_linear_banded(s3.std, s3.d_fixed_std, s3.times)\n"
        "v = m.max_magnitude(m.Trajectory(b.coefficients, b.times), 1,\n"
        "    n_grid=64)\n"
        "assert torch.isfinite(v.value).all() and (v.value > 0).all()\n"
        "occ = m.make_obstacle_grid((16, 16, 16), (0, 0, 0), 0.4,\n"
        "    spheres=[((3.0, 3.0, 3.0), 0.6)])\n"
        "f = m.esdf_from_occupancy(occ, (0, 0, 0), 0.4,\n"
        "    dtype=torch.float64, device='cpu')\n"
        "assert f.method == 'xla' and torch.isfinite(f.distance).all()\n"
        "s4 = m.make_inputs(2, 3, device='cpu')\n"
        "p = m.NonlinearParameters(\n"
        "    objective=m.Objective.FREE_CONSTRAINTS_AND_COLLISION,\n"
        "    max_iterations=3, use_soft_constraints=False)\n"
        "r = m.optimize(s4.std, s4.d_fixed_std.double(), s4.times.double(),\n"
        "    p, field=f, device='cpu')\n"
        "assert torch.isfinite(r.cost.total).all()\n"
        "assert r.cost_history.shape == (3, 3)\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')]\n"
        "assert bad == ['jax'] and sys.modules['jax'] is None, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_solution_round_trip_through_numpy():
    """``solution_to_numpy`` and ``solution_from_numpy`` carry a solution
    between the packages: float fields in the asked dtype, flags as bool,
    missing fields None."""
    sc = mtt.make_inputs(4, 3, device="cpu")
    sol = mtt.solve_qcqp_batch(sc.free, sc.d_fixed_free, sc.times,
                               sc.waypoints, sc.radii,
                               mtt.ADMMConfig(n_stages=1, n_iters=5),
                               warmstart_values=sc.values, device="cpu")
    as_np = mtt.solution_to_numpy(sol)
    assert "infeasible" not in as_np
    back = mtt.solution_from_numpy(as_np, device="cpu")
    assert back.infeasible is None and back.converged.dtype == torch.bool
    for name in mtt.QCQPSolution._fields[:-1]:
        np.testing.assert_array_equal(to_np(getattr(back, name)),
                                      to_np(getattr(sol, name)), err_msg=name)
    as_np["infeasible"] = np.array([True, False, True])
    wide = mtt.solution_from_numpy(as_np, device="cpu", dtype=torch.float64)
    assert wide.cost.dtype == torch.float64
    assert wide.infeasible.dtype == torch.bool and bool(wide.infeasible[0])


def test_port_solves_the_strict_path_without_jax():
    """The strict router with its defaults (float64 last tier on) and the
    fused polish run on the host in a process where neither jax nor the JAX
    package can be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mav_tube_trajectory_generation_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import mav_tube_trajectory_generation_tpu_torch as m\n"
        "sc = m.make_inputs(4, 4, device='cpu')\n"
        "radii = sc.radii.clone()\n"
        "radii[1] = 0.1\n"
        "r = m.solve_qcqp_strict(sc.free, sc.d_fixed_free, sc.times,\n"
        "    sc.waypoints, radii, warmstart_values=sc.values, device='cpu')\n"
        "assert (r.verdict != m.UNDETERMINED).all()\n"
        "p = m.solve_qcqp_polished_batch(sc.free, sc.d_fixed_free, sc.times,\n"
        "    sc.waypoints, radii, ipm_config=m.IPMConfig(n_iters=4,\n"
        "    sigma_min=0.3, corrector=False, fused=True),\n"
        "    warmstart_values=sc.values, device='cpu')\n"
        "assert torch.isfinite(p.cost).all()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_package_exports_every_kernel_wrapper():
    """Every public kernel wrapper of ``ops.admm_kernel`` and
    ``ops.ipm_kernel`` (each has a launch count) is the package's own
    name."""
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    wrappers = [(m, n) for m in (admm_kernel, ipm_kernel) for n in m.launches
                if callable(getattr(m, n, None))]
    assert len(wrappers) == 11
    for module, name in wrappers:
        assert getattr(mtt, name) is getattr(module, name), name
    assert mtt.__version__ == "0.6.0"
