"""The port's giant-K banded linear solve (block cyclic reduction) and the
dense-matrix entry point of its block-tridiagonal inverse, held against the
JAX package's on the same NumPy inputs, against the port's dense
``solve_linear``, and, with the dense solve, against the C++ oracle
(``parity_oracle.cpp``, built by ``torch_port_util.parity_oracle``).

Tolerances: float64 on both sides agrees to rtol 1e-9 of the coefficients'
scale on the standard family (the two packages invert their small blocks by
different routes: the JAX package's matmul-only Schur inverse, the port's
Cholesky); float32 is held to 3x the dense float32 solve's own error
against float64, + 1e-6 of scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch.solver import banded as tbanded
from mav_tube_trajectory_generation_tpu_torch.solver import structure as tsm

from torch_port_util import N, parity_oracle, to_np, tt

H = N // 2


def _jax_banded(js, df, times):
    """The JAX package's banded solve, traced once (its eager ops would
    compile one by one, ten times slower on the CPU)."""
    return jax.jit(lambda a, b: jbanded.solve_linear_banded(js, a, b))(
        jnp.asarray(df), jnp.asarray(times))


def _random_chain(rng, m, b, batch=()):
    d = rng.randn(*batch, m, b, b)
    d = d @ np.swapaxes(d, -1, -2) + 5 * np.eye(b)
    u = rng.randn(*batch, max(m - 1, 0), b, b) * 0.3
    return d, u


def _dense(d, u):
    m, b = d.shape[-3], d.shape[-1]
    a = np.zeros(d.shape[:-3] + (m * b, m * b))
    for i in range(m):
        a[..., i * b:(i + 1) * b, i * b:(i + 1) * b] = d[..., i, :, :]
    for i in range(m - 1):
        a[..., i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = u[..., i, :, :]
        a[..., (i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = \
            np.swapaxes(u[..., i, :, :], -1, -2)
    return a


@pytest.mark.parametrize("m,b", [(1, 4), (2, 4), (3, 5), (7, 4), (10, 5),
                                 (99, 4)])
def test_block_tridiag_solve_f64(m, b):
    """Against a dense solve and the JAX function, float64; m = 99 pads to
    127 blocks over 7 levels."""
    rng = np.random.RandomState(m)
    d, u = _random_chain(rng, m, b)
    rhs = rng.randn(m, b, 2)
    ours = to_np(mtt.block_tridiag_solve(tt(d), tt(u), tt(rhs)))
    dense = np.linalg.solve(_dense(d, u), rhs.reshape(m * b, 2))
    np.testing.assert_allclose(ours, dense.reshape(m, b, 2), rtol=1e-9,
                               atol=1e-11)
    ref = np.asarray(jax.jit(jbanded.block_tridiag_solve)(
        jnp.asarray(d), jnp.asarray(u), jnp.asarray(rhs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-11)


def test_block_tridiag_solve_batched():
    """Leading batch dimensions: each problem of a (2, 3) batch as if alone;
    a rhs without the batch dimensions broadcasts."""
    rng = np.random.RandomState(5)
    d, u = _random_chain(rng, 6, 3, batch=(2, 3))
    rhs = rng.randn(6, 3, 4)
    ours = to_np(mtt.block_tridiag_solve(tt(d), tt(u), tt(rhs)))
    assert ours.shape == (2, 3, 6, 3, 4)
    for i in range(2):
        for j in range(3):
            one = to_np(mtt.block_tridiag_solve(tt(d[i, j]), tt(u[i, j]),
                                                tt(rhs)))
            np.testing.assert_allclose(ours[i, j], one, rtol=1e-12,
                                       atol=1e-14)


def _random_problem(k, dim, seed, n=N, derivative=None):
    """The JAX test's problem: random vertices at rest at the ends, times by
    the reference heuristic (float64 NumPy), both packages' structures;
    the cost's derivative N/2 - 1 unless given."""
    if derivative is None:
        derivative = n // 2 - 1
    verts = jmtg.create_random_vertices(n // 2 - 1, k, -10 * np.ones(dim),
                                        10 * np.ones(dim), seed)
    js, values = jmtg.structure_from_vertices(verts, n, derivative)
    ts = mtt.structure_from_fields(js)
    times = np.asarray(jmtg.estimate_segment_times(verts, 3.0, 5.0))
    df = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    return js, ts, values, df, times


@pytest.mark.parametrize("k,dim,seed", [(2, 3, 0), (3, 3, 1), (4, 3, 1),
                                        (10, 3, 2), (50, 1, 3)])
def test_banded_matches_jax_and_dense_f64(k, dim, seed):
    """K=2 has one interior block and no coupling block; K=50 pads 49
    interior blocks to 63."""
    js, ts, _, df, times = _random_problem(k, dim, seed)
    ours = mtt.solve_linear_banded(ts, tt(df), tt(times))
    dense = mtt.solve_linear(ts, tt(df), tt(times))
    ref = _jax_banded(js, df, times)
    scale = float(np.abs(to_np(dense.coefficients)).max())
    assert ours.coefficients.dtype == torch.float64
    np.testing.assert_allclose(to_np(ours.coefficients),
                               to_np(dense.coefficients), rtol=1e-8,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(to_np(ours.coefficients),
                               np.asarray(ref.coefficients), rtol=1e-8,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(to_np(ours.d_free), np.asarray(ref.d_free),
                               rtol=1e-8, atol=1e-10 * scale)
    assert float(ours.cost) == pytest.approx(float(ref.cost), rel=1e-9)
    assert float(ours.cost) == pytest.approx(float(dense.cost), rel=1e-9)


@pytest.mark.parametrize("n", [6, 8, 10, 12])
def test_banded_every_n(n):
    """The banded path at every supported N against the JAX banded path and
    the port's dense solve (as the JAX package's N-generality test)."""
    js, ts, _, df, times = _random_problem(10, 3, 3, n=n)
    ours = to_np(mtt.solve_linear_banded(ts, tt(df), tt(times)).coefficients)
    dense = to_np(mtt.solve_linear(ts, tt(df), tt(times)).coefficients)
    ref = np.asarray(_jax_banded(js, df, times).coefficients)
    scale = np.abs(dense).max()
    np.testing.assert_allclose(ours, dense, rtol=1e-6, atol=1e-9 * scale)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9 * scale)


def test_banded_free_interior_family():
    """The QCQP's free-interior pattern is uniform too.  Its unconstrained
    system is poorly conditioned (interior positions free), so agreement is
    looser, as in the JAX package's own test."""
    k = 10
    js = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    ts = tsm.make_structure(tsm.free_interior_mask(k + 1, N), 3, N)
    rng = np.random.RandomState(7)
    waypoints = np.cumsum(rng.uniform(0.5, 1.5, size=(k + 1, 3)), axis=0)
    values = np.zeros((k + 1, H, 3))
    values[0, 0] = waypoints[0]
    values[-1, 0] = waypoints[-1]
    times = np.asarray(jmtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    df = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    ours = to_np(mtt.solve_linear_banded(ts, tt(df), tt(times)).coefficients)
    dense = to_np(mtt.solve_linear(ts, tt(df), tt(times)).coefficients)
    ref = np.asarray(_jax_banded(js, df, times).coefficients)
    scale = np.abs(dense).max()
    np.testing.assert_allclose(ours, dense, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6 * scale)


def test_banded_rejects_nonuniform():
    """ValueError where the JAX function raises it, before any work; no
    dense fallback."""
    mask = tsm.standard_mask(6, N)
    mask[2, 1] = True   # break uniformity
    ts = tsm.make_structure(mask, 3, N)
    js = jsm.make_structure(mask, 3, N)
    assert tbanded.uniform_interior_pattern(ts) is None
    assert jbanded.uniform_interior_pattern(js) is None
    with pytest.raises(ValueError):
        jbanded.solve_linear_banded(js, jnp.zeros((js.n_fixed, 3)),
                                    jnp.ones(5))
    with pytest.raises(ValueError, match="uniform interior"):
        mtt.solve_linear_banded(ts, torch.zeros(ts.n_fixed, 3),
                                torch.ones(5))
    # fully fixed: nothing free, no banded path either
    full = tsm.make_structure(np.ones((4, H), bool), 3, N)
    with pytest.raises(ValueError):
        mtt.solve_linear_banded(full, torch.zeros(full.n_fixed, 3),
                                torch.ones(3))


def test_banded_batched_matches_vmap():
    """A batch of 4 (leading dimension, no vmap) against the JAX function
    under jax.vmap and against the port's rows one at a time."""
    k, batch = 10, 4
    js = jsm.make_structure(jsm.standard_mask(k + 1, N), 3, N)
    ts = mtt.structure_from_fields(js)
    rng = np.random.RandomState(9)
    waypoints = np.cumsum(rng.uniform(0.5, 1.5, size=(batch, k + 1, 3)),
                          axis=1)
    values = np.zeros((batch, k + 1, H, 3))
    values[:, :, 0] = waypoints
    times = np.asarray(jmtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    df = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    ours = mtt.solve_linear_banded(ts, tt(df), tt(times))
    ref = jax.jit(jax.vmap(
        lambda a, b: jbanded.solve_linear_banded(js, a, b)))(
        jnp.asarray(df), jnp.asarray(times))
    assert ours.coefficients.shape == (batch, k, N, 3)
    np.testing.assert_allclose(to_np(ours.cost), np.asarray(ref.cost),
                               rtol=1e-9)
    scale = np.abs(to_np(ours.coefficients)).max()
    np.testing.assert_allclose(to_np(ours.coefficients),
                               np.asarray(ref.coefficients), rtol=1e-8,
                               atol=1e-10 * scale)
    for i in range(batch):
        one = mtt.solve_linear_banded(ts, tt(df[i]), tt(times[i]))
        np.testing.assert_allclose(to_np(one.coefficients),
                                   to_np(ours.coefficients[i]), rtol=1e-12,
                                   atol=1e-13 * scale)


def test_banded_f32_against_f64():
    """float32 banded against float64 banded, per row as a share of the
    row's scale, within 3x the dense float32 solve's own error + 1e-6 (the
    card's gate, at the CPU's size), and the fixed endpoint derivatives
    recovered from the coefficients."""
    sc = mtt.make_inputs(10, 8, seed=1, device="cpu")
    df32, t32 = sc.d_fixed_std, sc.times
    df64, t64 = df32.double(), t32.double()

    def row_err(a, b):
        scale = b.abs().flatten(1).max(dim=1).values
        return ((a.double() - b).abs().flatten(1).max(dim=1).values / scale)
    b32 = mtt.solve_linear_banded(sc.std, df32, t32)
    b64 = mtt.solve_linear_banded(sc.std, df64, t64)
    d32 = mtt.solve_linear(sc.std, df32, t32)
    d64 = mtt.solve_linear(sc.std, df64, t64)
    assert b32.coefficients.dtype == torch.float32
    e_band = row_err(b32.coefficients, b64.coefficients)
    e_dense = row_err(d32.coefficients, d64.coefficients)
    for q in (0.5, 1.0):
        assert float(e_band.quantile(q)) <= \
            3 * float(e_dense.quantile(q)) + 1e-6
    assert float(row_err(b64.coefficients, d64.coefficients).max()) < 1e-9
    # the endpoints' fixed derivatives, read back from the coefficients
    from mav_tube_trajectory_generation_tpu_torch.ops import qmatrix
    from mav_tube_trajectory_generation_tpu_torch.solver import linear
    d_seg = qmatrix.endpoint_derivatives_from_coefficients(b64.coefficients,
                                                           t64)
    back = linear.compact_from_segment_derivatives(sc.std, d_seg)
    np.testing.assert_allclose(to_np(back[:, :sc.std.n_fixed]), to_np(df64),
                               rtol=1e-9, atol=1e-9)


def test_spd_block_tridiag_inverse_matches_dense():
    """The dense-matrix entry point against the dense inverse and the JAX
    function, float64."""
    rng = np.random.RandomState(0)
    m, b = 5, 6
    d, u = _random_chain(rng, m, b, batch=(3,))
    a = _dense(d + 5 * np.eye(b), u)
    w = to_np(tbanded.spd_block_tridiag_inverse(tt(a), b))
    assert np.abs(a @ w - np.eye(m * b)).max() < 1e-10
    ref = np.asarray(jbanded.spd_block_tridiag_inverse(jnp.asarray(a), b))
    np.testing.assert_allclose(w, ref, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError):
        tbanded.spd_block_tridiag_inverse(tt(a), 4)


@pytest.mark.parametrize("dim,k,derivative,seed", [
    (1, 1, jmtg.SNAP, 1),
    (3, 10, jmtg.SNAP, 2),      # the parity configuration
    (3, 10, jmtg.ACCELERATION, 3),
    (2, 5, jmtg.JERK, 5),
])
def test_cpp_oracle_parity(dim, k, derivative, seed):
    """The port's dense and banded solves (float64) against the independent
    C++ closed form, as the JAX package's native parity test holds its own
    (K=1 has no interior vertex: dense only)."""
    solve_cpp = parity_oracle()
    _, ts, values, df, times = _random_problem(k, dim, seed,
                                               derivative=derivative)
    cpp = solve_cpp(ts.fixed_mask, values, times, derivative, N)
    scale = np.abs(cpp).max() + 1.0
    dense = to_np(mtt.solve_linear(ts, tt(df), tt(times)).coefficients)
    np.testing.assert_allclose(dense, cpp, rtol=1e-7, atol=1e-9 * scale)
    if k > 1:
        band = to_np(mtt.solve_linear_banded(ts, tt(df),
                                             tt(times)).coefficients)
        np.testing.assert_allclose(band, cpp, rtol=1e-7, atol=1e-9 * scale)


def test_cpp_oracle_interior_constraints():
    """Mixed fixed derivatives at interior vertices: the dense solve against
    the oracle; the banded path rejects the pattern."""
    solve_cpp = parity_oracle()
    rng = np.random.RandomState(0)
    v = 6
    mask = tsm.standard_mask(v, N)
    mask[2, 1] = True   # a velocity
    mask[3, 2] = True   # and an acceleration
    values = rng.randn(v, H, 3)
    ts = tsm.make_structure(mask, 3, N, jmtg.SNAP)
    times = rng.uniform(0.5, 3.0, size=v - 1)
    df = to_np(mtt.extract_fixed_values(ts, tt(values)))
    ours = to_np(mtt.solve_linear(ts, tt(df), tt(times)).coefficients)
    cpp = solve_cpp(mask, values, times, jmtg.SNAP, N)
    scale = np.abs(cpp).max() + 1.0
    np.testing.assert_allclose(ours, cpp, rtol=1e-7, atol=1e-9 * scale)
    with pytest.raises(ValueError):
        mtt.solve_linear_banded(ts, tt(df), tt(times))
