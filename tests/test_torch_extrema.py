"""The port's interval roots, interval extrema and trajectory model, held
against the JAX package's on the same NumPy inputs and against sampling and
companion-matrix oracles (the JAX package's own test protocol).

Tolerances: float64 on both sides, roots and extremum values to 1e-9 of
scale, extremum times and segment indices equal up to that (the two
packages run the same grid, the same bisection steps and the same first-wins
ties); float32 values to 1e-4 relative, and there times and segment indices
are not compared: adjacent segments share an endpoint and rounding may pick
either.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.models import segment as jsegment
from mav_tube_trajectory_generation_tpu.models import trajectory as jtraj
from mav_tube_trajectory_generation_tpu.ops import roots as jroots
from mav_tube_trajectory_generation_tpu_torch.models import segment as tsegment
from mav_tube_trajectory_generation_tpu_torch.models import trajectory as ttraj
from mav_tube_trajectory_generation_tpu_torch.ops import roots as troots

from torch_port_util import N, to_np, tt

H = N // 2


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def build_solution(dim=3, k=5, seed=42, n=N, batch=None):
    """A solved min-snap problem (float64) as the JAX trajectory tests build
    it, solved by the port (both packages then read the same coefficients):
    (vertex values, times, JAX Trajectory, port Trajectory).  ``batch``
    stacks that many seeds on a leading dimension."""
    seeds = [seed] if batch is None else [seed + i for i in range(batch)]
    coeffs, ts = [], []
    for s in seeds:
        verts = mtt.create_random_vertices(n // 2 - 1, k, -10 * np.ones(dim),
                                           10 * np.ones(dim), s)
        structure, values = mtt.structure_from_vertices(verts, n, n // 2 - 1)
        times = np.asarray(mtt.estimate_segment_times(verts, 3.0, 5.0))
        sol = mtt.solve_linear(
            structure, mtt.extract_fixed_values(structure, tt(values)),
            tt(times))
        coeffs.append(to_np(sol.coefficients))
        ts.append(times)
    coeffs, ts = np.stack(coeffs), np.stack(ts)
    if batch is None:
        coeffs, ts = coeffs[0], ts[0]
    return values, ts, jmtg.Trajectory(jnp.asarray(coeffs), jnp.asarray(ts)), \
        mtt.Trajectory(tt(coeffs), tt(ts))


# ---------------------------------------------------------------------------
# ops.roots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_grid", [64, 256])
def test_roots_in_interval_matches_jax_f64(n_grid):
    """30 random degree-7 polynomials on [0, 3], batched: the same slots,
    validity and roots as the JAX function."""
    rng = np.random.RandomState(0)
    coeffs = rng.randn(30, 8)
    ours = troots.roots_in_interval(tt(coeffs), 0.0, 3.0, n_grid)
    ref = _jit(jroots.roots_in_interval, 3)(jnp.asarray(coeffs), 0.0, 3.0,
                                              n_grid)
    np.testing.assert_array_equal(to_np(ours.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(to_np(ours.roots), np.asarray(ref.roots),
                               rtol=0, atol=1e-12)
    assert ours.roots.shape == (30, 7)
    # unused slots hold t0
    assert np.all(to_np(ours.roots)[~to_np(ours.valid)] == 0.0)


def test_roots_in_interval_vs_companion():
    """Every sign-crossing companion-matrix root in the interval is found to
    1e-8 (the JAX test's protocol)."""
    rng = np.random.RandomState(0)
    coeffs = rng.randn(30, 8)
    t0, t1 = 0.0, 3.0
    r = troots.roots_in_interval(tt(coeffs), t0, t1)
    roots, valid = to_np(r.roots), to_np(r.valid)
    for trial in range(30):
        ours = sorted(roots[trial][valid[trial]])
        poly = np.polynomial.Polynomial(coeffs[trial])
        crossing = [z.real for z in troots.roots_companion(coeffs[trial])
                    if abs(z.imag) < 1e-9 and t0 + 1e-7 < z.real < t1 - 1e-7
                    and np.sign(poly(z.real - 1e-7))
                    * np.sign(poly(z.real + 1e-7)) < 0]
        assert len(ours) >= len(crossing)
        for cr in crossing:
            assert min(abs(cr - o) for o in ours) < 1e-8, (trial, cr, ours)


def test_roots_companion_equals_jax():
    rng = np.random.RandomState(3)
    for c in (rng.randn(8), np.array([1.0, -3.0, 2.0, 0.0, 0.0]),
              np.array([2.0, 0.0]), np.zeros(3)):
        np.testing.assert_array_equal(
            np.sort_complex(troots.roots_companion(c)),
            np.sort_complex(jroots.roots_companion(c)))


def test_roots_f32_matches_jax():
    """float32 on both sides: the same brackets; roots to 1e-4 of the
    interval."""
    rng = np.random.RandomState(4)
    coeffs = rng.randn(16, 10).astype(np.float32)
    ours = troots.roots_in_interval(tt(coeffs), 0.0, 2.0)
    ref = _jit(jroots.roots_in_interval)(jnp.asarray(coeffs), 0.0, 2.0)
    assert ours.roots.dtype == torch.float32
    np.testing.assert_array_equal(to_np(ours.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(to_np(ours.roots), np.asarray(ref.roots),
                               rtol=0, atol=2e-4)


def test_constant_polynomial_no_roots():
    r = troots.roots_in_interval(torch.tensor([3.0, 0.0, 0.0],
                                              dtype=torch.float64), 0.0, 1.0)
    assert not to_np(r.valid).any()


def test_exact_gridpoint_root():
    """p(t) = t - 0.5 on [0, 1] puts the root on a grid node: the cell whose
    left node holds the exact zero brackets it."""
    r = troots.roots_in_interval(torch.tensor([-0.5, 1.0],
                                              dtype=torch.float64), 0.0, 1.0)
    found = to_np(r.roots)[to_np(r.valid)]
    assert len(found) == 1
    assert found[0] == pytest.approx(0.5, abs=1e-12)


def test_minmax_vs_jax_and_sampling():
    """100 random polynomials x derivatives 0-2 on [0, 2.5]: the JAX
    function's min/max (values and times, float64) and the sampling oracle
    at 1e-3 resolution within 1e-2 (test_polynomial.cpp:36-137)."""
    rng = np.random.RandomState(1)
    coeffs = rng.uniform(-5, 5, size=(100, N))
    t0, t1 = 0.0, 2.5
    ts = np.arange(t0, t1 + 1e-3, 1e-3)
    for derivative in (0, 1, 2):
        ours = troots.minmax_in_interval(tt(coeffs), t0, t1, derivative)
        ref = _jit(jroots.minmax_in_interval, 3)(jnp.asarray(coeffs), t0, t1,
                                                 derivative)
        for name in ("t_min", "v_min", "t_max", "v_max"):
            np.testing.assert_allclose(to_np(getattr(ours, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-9, atol=1e-9)
        for i in range(100):
            vals = np.polynomial.Polynomial(coeffs[i]).deriv(derivative)(ts)
            assert float(ours.v_min[i]) == pytest.approx(vals.min(), abs=1e-2)
            assert float(ours.v_max[i]) == pytest.approx(vals.max(), abs=1e-2)


def test_magnitude_candidates_vs_jax_and_sampling():
    """The magnitude's candidate polynomial and times (20 random segments,
    D=3) against the JAX functions, and the sampled extrema attained among
    the candidates (test_polynomial_optimization.cpp:307-406)."""
    rng = np.random.RandomState(2)
    coeffs = rng.uniform(-2, 2, size=(20, N, 3))
    t1 = 2.0
    ts = np.arange(0, t1 + 1e-4, 1e-4)
    for derivative in (1, 2):
        poly = troots.magnitude_candidate_polynomial(tt(coeffs), derivative)
        np.testing.assert_allclose(
            to_np(poly), np.asarray(jroots.magnitude_candidate_polynomial(
                jnp.asarray(coeffs), derivative)), rtol=1e-12, atol=1e-12)
        assert poly.shape == (20, 2 * (N - derivative) - 2)
        cand_t, valid = troots.magnitude_minmax_candidates(
            tt(coeffs), derivative, 0.0, t1)
        ref_t, ref_valid = _jit(jroots.magnitude_minmax_candidates, 1)(
            jnp.asarray(coeffs), derivative, 0.0, t1)
        np.testing.assert_array_equal(to_np(valid), np.asarray(ref_valid))
        np.testing.assert_allclose(to_np(cand_t), np.asarray(ref_t),
                                   rtol=0, atol=1e-12)
        cand_t, valid = to_np(cand_t), to_np(valid)
        for i in range(20):
            def mag(t):
                return np.sqrt(sum(np.polynomial.Polynomial(
                    coeffs[i, :, d]).deriv(derivative)(t) ** 2
                    for d in range(3)))
            mags = mag(ts)
            cand = mag(cand_t[i][valid[i]])
            assert cand.max() == pytest.approx(mags.max(), abs=1e-2), i
            assert cand.min() == pytest.approx(mags.min(), abs=1e-2), i


# ---------------------------------------------------------------------------
# models.trajectory and models.segment
# ---------------------------------------------------------------------------

def test_evaluate_matches_jax_and_polyval():
    """Global-time evaluation of derivatives 0-2 against the JAX function
    and a NumPy polynomial oracle (float64)."""
    _, times, jt, tr = build_solution()
    coeffs = to_np(tr.coefficients)
    ts = np.linspace(0.0, float(np.sum(times)) - 1e-9, 57)
    cum = np.cumsum(times)
    for derivative in (0, 1, 2):
        ours = to_np(mtt.evaluate(tr, tt(ts), derivative))
        np.testing.assert_allclose(
            ours, np.asarray(_jit(jmtg.evaluate, 2)(jt, jnp.asarray(ts),
                                                    derivative)),
            rtol=1e-12, atol=1e-12)
        for i, t in enumerate(ts[::7]):
            seg = int(np.searchsorted(cum[:-1], t, side="right"))
            local = t - (cum[seg] - times[seg])
            for d in range(3):
                oracle = np.polynomial.Polynomial(
                    coeffs[seg, :, d]).deriv(derivative)(local)
                assert ours[7 * i, d] == pytest.approx(oracle, rel=1e-9,
                                                       abs=1e-9)


def test_segment_lookup_on_boundaries():
    """A time exactly on a boundary belongs to the later segment; the end
    and past it stay in the last, as in the JAX function."""
    times = np.array([1.0, 0.5, 2.0])
    ts = np.array([0.0, 1.0, 1.5, 3.5, 4.0])
    seg, local = ttraj._segment_lookup(tt(times), tt(ts))
    jseg, jlocal = _jit(jtraj._segment_lookup)(jnp.asarray(times),
                                               jnp.asarray(ts))
    np.testing.assert_array_equal(to_np(seg), np.asarray(jseg))
    np.testing.assert_array_equal(to_np(seg), [0, 1, 2, 2, 2])
    np.testing.assert_allclose(to_np(local), np.asarray(jlocal), atol=0)
    _, _, jt, tr = build_solution(k=3)
    np.testing.assert_allclose(
        to_np(mtt.evaluate(tr, tt(ts), 1)),
        np.asarray(_jit(jmtg.evaluate, 2)(jt, jnp.asarray(ts), 1)),
        rtol=1e-12)


def test_evaluate_batched_and_segment_api():
    """A batch of 3 trajectories at per-row times, and the per-segment
    functions of models.segment, against the JAX functions."""
    _, times, jt, tr = build_solution(k=4, batch=3)
    rng = np.random.RandomState(0)
    ts = rng.uniform(0, times.sum(-1, keepdims=True), size=(3, 11))
    np.testing.assert_allclose(
        to_np(mtt.evaluate(tr, tt(ts), 2)),
        np.asarray(jax.jit(jax.vmap(lambda a, b: jmtg.evaluate(a, b, 2)))(
            jt, jnp.asarray(ts))), rtol=1e-12, atol=1e-12)
    seg = np.array([0, 3, 1])
    local = rng.uniform(0, 0.5, size=(3, 4))
    np.testing.assert_allclose(
        to_np(ttraj.evaluate_segment(tr, tt(seg), tt(local), 1)),
        np.asarray(_jit(jtraj.evaluate_segment, 3)(
            jt, jnp.asarray(seg), jnp.asarray(local), 1)),
        rtol=1e-12, atol=1e-12)
    c = to_np(tr.coefficients)[0, 2]
    for t in (0.3, np.array([0.1, 0.2])):
        np.testing.assert_allclose(
            to_np(tsegment.evaluate(tt(c), t, 1)),
            np.asarray(_jit(jsegment.evaluate, 2)(jnp.asarray(c), t, 1)),
            rtol=1e-12)
    ours = tsegment.min_max_magnitude_candidate_times(tt(c), 1, 0.0, 1.2)
    ref = _jit(jsegment.min_max_magnitude_candidate_times, 1)(
        jnp.asarray(c), 1, 0.0, 1.2)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-12)
    mins, maxs = tsegment.min_max_magnitude_single(tt(c), 1.2, 2)
    jmins, jmaxs = _jit(jsegment.min_max_magnitude_single, 2)(
        jnp.asarray(c), 1.2, 2)
    for a, b in ((mins, jmins), (maxs, jmaxs)):
        for f in ("time", "value", "segment_index"):
            np.testing.assert_allclose(to_np(getattr(a, f)),
                                       np.asarray(getattr(b, f)), rtol=1e-9)
    np.testing.assert_array_equal(
        to_np(tsegment.get_segment_dimension(tt(c), [2, 0])), c[:, [2, 0]])
    np.testing.assert_array_equal(
        to_np(tsegment.append_dimensions(tt(c), tt(c[:, :1]))),
        np.asarray(jsegment.append_dimensions(jnp.asarray(c),
                                              jnp.asarray(c[:, :1]))))


def test_endpoints_match_vertices():
    values, _, _, tr = build_solution()
    np.testing.assert_allclose(to_np(ttraj.start_position(tr)), values[0, 0],
                               atol=1e-8)
    np.testing.assert_allclose(to_np(ttraj.goal_position(tr)), values[-1, 0],
                               atol=1e-7)
    np.testing.assert_allclose(to_np(ttraj.goal_position(tr, 1)),
                               np.zeros(3), atol=1e-7)


@pytest.mark.parametrize("derivative", [1, 2])
def test_min_max_magnitude_matches_jax_f64(derivative):
    """Batch of 4 trajectories, float64: value, time and segment index of
    the min and the max as the JAX function's; the max against dense
    sampling (200,001 points, 1e-4)."""
    _, times, jt, tr = build_solution(seed=5, batch=4)
    mins, maxs = mtt.min_max_magnitude(tr, derivative)
    jmins, jmaxs = _jit(jmtg.min_max_magnitude, 1)(jt, derivative)
    for a, b in ((mins, jmins), (maxs, jmaxs)):
        np.testing.assert_allclose(to_np(a.value), np.asarray(b.value),
                                   rtol=1e-9)
        np.testing.assert_allclose(to_np(a.time), np.asarray(b.time),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(to_np(a.segment_index),
                                      np.asarray(b.segment_index))
    one = ttraj.Trajectory(tr.coefficients[0], tr.times[0])
    ts = np.linspace(0, float(times[0].sum()), 200001)
    sampled = np.linalg.norm(to_np(mtt.evaluate(one, tt(ts), derivative)),
                             axis=-1)
    assert float(maxs.value[0]) == pytest.approx(sampled.max(), rel=1e-4)
    assert float(maxs.value[0]) >= sampled.max() - 1e-9
    assert float(mins.value[0]) == pytest.approx(sampled.min(), rel=1e-3,
                                                 abs=1e-3)


def test_max_magnitude_f32_matches_jax():
    """float32 on both sides, the bench's n_grid=64: values to 1e-4."""
    _, _, jt, tr = build_solution(seed=8, batch=6)
    tr32 = mtt.Trajectory(tr.coefficients.float(), tr.times.float())
    jt32 = jmtg.Trajectory(jt.coefficients.astype(jnp.float32),
                           jt.times.astype(jnp.float32))
    for derivative in (1, 2):
        ours = mtt.max_magnitude(tr32, derivative, n_grid=64)
        ref = _jit(jmtg.max_magnitude, 1, 2)(jt32, derivative, 64)
        assert ours.value.dtype == torch.float32
        np.testing.assert_allclose(to_np(ours.value), np.asarray(ref.value),
                                   rtol=1e-4)


@pytest.mark.parametrize("n", [6, 8, 10, 12])
def test_extrema_vs_sampling_every_n(n):
    """Degree 2N-3 candidate polynomials at every N against a sampling
    oracle, and the JAX function's values (float64)."""
    _, times, jt, tr = build_solution(k=4, seed=5, n=n)
    ts = np.linspace(0, float(np.sum(times)) - 1e-9, 4000)
    for derivative in (1, 2):
        analytic = float(mtt.max_magnitude(tr, derivative).value)
        sampled = np.linalg.norm(
            to_np(mtt.evaluate(tr, tt(ts), derivative)), axis=-1).max()
        assert analytic == pytest.approx(sampled, rel=1e-2)
        assert analytic >= sampled - 1e-6
        ref = float(_jit(jmtg.max_magnitude, 1)(jt, derivative).value)
        assert analytic == pytest.approx(ref, rel=1e-9)


def test_append_projection_and_vertex_at_time():
    _, times, jt, tr = build_solution(k=3)
    double = ttraj.append(tr, tr)
    assert double.n_segments == 6
    sub = ttraj.get_segment_dimension(tr, [0, 2])
    assert sub.dimension == 2
    np.testing.assert_array_equal(to_np(sub.coefficients),
                                  to_np(tr.coefficients)[..., [0, 2]])
    stacked = mtt.append_dimension(tr, tr)
    assert stacked.dimension == 6
    t = 0.4 * float(np.sum(times))
    v6 = to_np(mtt.get_vertex_at_time(stacked, t, 2))
    assert v6.shape == (3, 6)
    np.testing.assert_allclose(v6[:, :3], v6[:, 3:], atol=1e-12)
    np.testing.assert_allclose(
        v6, np.asarray(jmtg.get_vertex_at_time(
            jmtg.append_dimension(jt, jt), t, 2)), rtol=1e-12, atol=1e-12)
    for d in range(3):
        np.testing.assert_allclose(
            v6[d, :3], to_np(mtt.evaluate(tr, t, d))[0], atol=1e-12)


def test_sample_times():
    ts = mtt.sample_times(np.array([1.0, 2.0]), 0.5)
    np.testing.assert_allclose(ts, [0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0])
    np.testing.assert_array_equal(
        ts, jmtg.sample_times(np.array([1.0, 2.0]), 0.5))


def test_scale_trajectory_time_exact():
    """x_scaled(f t) == x(t); derivative d scales by 1/f^d; as the JAX
    function; a factor a row on a batch."""
    _, times, jt, tr = build_solution(k=3, seed=9)
    f = 1.7
    scaled = mtt.scale_trajectory_time(tr, f)
    jscaled = jmtg.scale_trajectory_time(jt, f)
    np.testing.assert_allclose(to_np(scaled.coefficients),
                               np.asarray(jscaled.coefficients), rtol=1e-12)
    np.testing.assert_allclose(to_np(scaled.times),
                               np.asarray(jscaled.times), rtol=1e-15)
    ts = np.linspace(0.0, float(np.sum(times)) - 1e-9, 23)
    for d in (0, 1, 2):
        orig = to_np(mtt.evaluate(tr, tt(ts), d))
        got = to_np(mtt.evaluate(scaled, tt(f * ts), d))
        np.testing.assert_allclose(got, orig / f ** d, rtol=1e-9,
                                   atol=1e-10)
    _, _, _, batch = build_solution(k=3, seed=9, batch=2)
    two = mtt.scale_trajectory_time(batch, tt(np.array([f, 1.0])))
    np.testing.assert_allclose(to_np(two.coefficients[0]),
                               to_np(scaled.coefficients), rtol=1e-12)
    np.testing.assert_array_equal(to_np(two.times[1]), to_np(batch.times[1]))


def test_scale_times_to_limits_repairs_violation():
    """After scaling, the limits hold (scaleSegmentTimesWithViolation
    intent); within the limits the trajectory is untouched."""
    _, _, jt, tr = build_solution(k=4, seed=11)
    vmax0 = float(mtt.max_magnitude(tr, 1).value)
    amax0 = float(mtt.max_magnitude(tr, 2).value)
    v_lim, a_lim = 0.5 * vmax0, 0.5 * amax0
    fixed = mtt.scale_times_to_limits(tr, v_lim, a_lim)
    assert float(mtt.max_magnitude(fixed, 1).value) <= v_lim * (1 + 1e-6)
    assert float(mtt.max_magnitude(fixed, 2).value) <= a_lim * (1 + 1e-6)
    ref = _jit(jmtg.scale_times_to_limits, 1, 2)(jt, v_lim, a_lim)
    np.testing.assert_allclose(to_np(fixed.times), np.asarray(ref.times),
                               rtol=1e-9)
    same = mtt.scale_times_to_limits(tr, vmax0 * 2, amax0 * 2)
    np.testing.assert_array_equal(to_np(same.times), to_np(tr.times))


def test_add_trajectories_merge_and_continuity():
    """N-way merge: compatible pieces concatenate and evaluate as before; a
    continuity gap raises; a D/N mismatch raises."""
    _, _, _, tr = build_solution(k=3, seed=7)
    goal_state = to_np(mtt.get_vertex_at_time(tr, tr.max_time, H - 1))
    verts2 = jmtg.create_random_vertices(H - 1, 3, -10 * np.ones(3),
                                         10 * np.ones(3), seed=8)
    for d in range(H):
        verts2[0].add_constraint(d, goal_state[d])
    structure2, values2 = mtt.structure_from_vertices(verts2, N, mtt.SNAP)
    times2 = mtt.estimate_segment_times(verts2, 3.0, 5.0)
    sol2 = mtt.solve_linear(structure2,
                            mtt.extract_fixed_values(structure2,
                                                     tt(values2)),
                            tt(times2))
    tr2 = mtt.Trajectory(sol2.coefficients, sol2.times)
    merged = ttraj.add_trajectories([tr, tr2], max_derivative=H - 1,
                                    tolerance=1e-6)
    assert merged.n_segments == 6
    t1 = float(tr.max_time)
    t_mid2 = t1 + 0.3 * float(tr2.max_time)
    np.testing.assert_allclose(to_np(mtt.evaluate(merged, t_mid2)),
                               to_np(mtt.evaluate(tr2, t_mid2 - t1)),
                               atol=1e-8)
    with pytest.raises(ValueError, match="goal vertex"):
        ttraj.add_trajectories([tr, tr], max_derivative=0)
    sub = ttraj.get_segment_dimension(tr, [0, 1])
    with pytest.raises(ValueError, match="D="):
        ttraj.add_trajectories([tr, sub], check_continuity=False)
    with pytest.raises(ValueError):
        ttraj.add_trajectories([])


def test_trajectory_round_trip_through_numpy():
    """``trajectory_from_numpy`` reads a JAX Trajectory; ``trajectory_to_
    numpy`` gives arrays either package's Trajectory takes."""
    _, _, jt, _ = build_solution(k=3)
    ours = mtt.trajectory_from_numpy(jt, device="cpu")
    assert ours.coefficients.dtype == torch.float64
    back = jmtg.Trajectory(*mtt.trajectory_to_numpy(ours))
    np.testing.assert_array_equal(np.asarray(back.coefficients),
                                  np.asarray(jt.coefficients))
    np.testing.assert_array_equal(np.asarray(back.times),
                                  np.asarray(jt.times))
    f32 = mtt.trajectory_from_numpy(jt, device="cpu", dtype=torch.float32)
    assert f32.times.dtype == torch.float32
