"""The reference-layout solvers of the port (``solve_qcqp``, ``solve_qcqp_ipm``,
``solve_qcqp_polished``: the float64 last tier of the verdict router) against
the JAX package's, in float64 on both sides, on three rows of the fixture of
``tests/test_auto_fast.py``: a generous corridor (r = 0.8), a tight one
(r = 0.1) and a structurally infeasible one (start 5 units off a corridor of
r = 0.05).

Tolerances, and why.  The two packages do the same arithmetic; only the
small inverses differ (here an equilibrated Cholesky, there a matmul-only
recursive Schur inverse or a dense Cholesky inverse), so

  * the ADMM (``solve_qcqp``) agrees to 1e-9 of each output's scale
    (measured 1e-13 to 1e-8: nothing amplifies the rounding);
  * the interior-point method agrees to 1e-6 of each output's scale as long
    as the Newton systems are well conditioned: against the JAX package's
    default Hessian inverse (``hess_inverse="schur"``) through the first
    twelve steps (measured 1e-12), and against its dense Cholesky inverse
    (``hess_inverse="cholesky"``: mathematically the same Newton step)
    through all 25 (and through warm-started solves) for the best iterate (measured 2e-11 in d_free; the
    duals belong to the last iterate, which is rounding noise once mu has
    fallen below 1e-12, and are compared at twelve steps only).  In the
    endgame of a tight row
    the recursive Schur inverse loses accuracy and the JAX solve stalls at a
    violation of 2e-7 where the port (and JAX with Cholesky) goes on to
    1e-14; there the two are compared by solution class: both under 1e-6
    violation, cost within 1e-5 relative, the same certificate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.solver import ipm as jipm
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.solver import ipm as tipm
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import N, to_np, tt

K = 4
GENEROUS, TIGHT, INFEASIBLE = 0, 1, 2
ROW_NAMES = ("generous", "tight", "infeasible")
FLOAT_FIELDS = ("d_free", "cost", "max_violation", "primal_residual",
                "dual_residual", "dual_ball", "dual_half", "coefficients")


@pytest.fixture(scope="module")
def rows():
    """Three float64 scenarios (see the module docstring) as NumPy arrays,
    with both packages' structures."""
    rng = np.random.RandomState(11)
    b = 8
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, K + 1, 3)), axis=1)
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    js = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    values = np.zeros((b, K + 1, 5, 3))
    values[:, :, 0, :] = waypoints
    times = to_np(mtt.segment_times_nfabian(tt(waypoints), 3.0, 5.0))
    radii = np.full((b, K, 2), 0.8)
    radii[2:4] = 0.1
    df = to_np(mtt.extract_fixed_values(ts, tt(values))).copy()
    df[7, 0, :] += 5.0
    radii[7] = 0.05
    pick = [0, 2, 7]
    data = tuple(a[pick].astype(np.float64)
                 for a in (df, times, waypoints, radii))
    assert all(a.dtype == np.float64 for a in data)
    return ts, js, data


def _jax_rows(fn, data, *extra):
    """``fn`` (one scenario) over the rows, jitted once."""
    args = [jnp.asarray(a, jnp.float64) for a in data + extra]
    out = jax.jit(jax.vmap(fn))(*args)
    assert out.d_free.dtype == jnp.float64
    return out


def _t(data, *extra):
    return [tt(a, torch.float64) for a in data + extra]


def _rel_err(ours, ref, name):
    """(rows,) worst difference of a field per scenario over the reference's
    largest entry in that scenario."""
    a = to_np(getattr(ours, name)).astype(np.float64)
    b = np.asarray(getattr(ref, name), np.float64)
    assert a.shape == b.shape, name
    n = a.shape[0]
    scale = np.maximum(np.abs(b).reshape(n, -1).max(axis=1), 1e-300)
    return np.abs(a - b).reshape(n, -1).max(axis=1) / scale


def _assert_close(ours, ref, tol, fields=FLOAT_FIELDS, only=None, floor=0.0):
    for name in fields:
        err = _rel_err(ours, ref, name)
        if only is not None:
            err = err[only]
        # tiny outputs (a residual of 1e-15 on a feasible row) carry no
        # relative information: `floor` is an absolute allowance for them
        b = np.abs(np.asarray(getattr(ref, name), np.float64))
        n = b.shape[0]
        scale = b.reshape(n, -1).max(axis=1)
        if only is not None:
            scale = scale[only]
        bad = err * scale > tol * scale + floor
        assert not bad.any(), (name, err, scale)


@pytest.mark.parametrize("n_stages,factors", [(1, False), (2, False),
                                              (1, True), (2, True)])
def test_solve_qcqp_matches_reference(rows, n_stages, factors):
    ts, js, data = rows
    kw = dict(rho=0.005, n_stages=n_stages, n_iters=30)
    if factors:
        kw.update(rho_sphere_factor=2.0, rho_tube_factor=0.125,
                  rho_half_factor=0.125)
    ref = _jax_rows(lambda a, b, c, d: jqcqp.solve_qcqp(
        js, a, b, c, d, config=jqcqp.ADMMConfig(use_pallas=False, **kw)),
        data)
    ours = tqcqp._solve_qcqp_rows(ts, *_t(data), mtt.ADMMConfig(**kw))
    assert ours.d_free.dtype == torch.float64 and ours.infeasible is None
    # a residual that has reached 1e-5 of its start carries 1e-8 relative
    _assert_close(ours, ref, 1e-6 if n_stages == 2 else 1e-9)
    np.testing.assert_array_equal(to_np(ours.converged),
                                  np.asarray(ref.converged))
    # the public function takes one scenario and gives what the batch gives
    one = mtt.solve_qcqp(ts, *(a[TIGHT] for a in data),
                         config=mtt.ADMMConfig(**kw), device="cpu")
    assert one.d_free.shape == (ts.n_free, 3) and one.cost.shape == ()
    np.testing.assert_allclose(to_np(one.d_free), to_np(ours.d_free)[TIGHT],
                               rtol=0, atol=1e-10)


def test_solve_qcqp_starts(rows):
    """The two warm starts against the reference, and the refusal of both at
    once; float32 inputs give a float32 solve."""
    ts, js, data = rows
    kw = dict(rho=0.005, n_stages=1, n_iters=12)
    wp = data[2][:, 1:-1, :]
    ref = _jax_rows(lambda a, b, c, d, w: jqcqp.solve_qcqp(
        js, a, b, c, d, config=jqcqp.ADMMConfig(use_pallas=False, **kw),
        warmstart_positions=w), data, wp)
    ours = tqcqp._solve_qcqp_rows(ts, *_t(data), mtt.ADMMConfig(**kw),
                                  warmstart_positions=tt(wp))
    _assert_close(ours, ref, 1e-8)       # Cholesky vs Schur in the warm start
    x0 = np.asarray(ref.d_free)
    ref2 = _jax_rows(lambda a, b, c, d, x: jqcqp.solve_qcqp(
        js, a, b, c, d, config=jqcqp.ADMMConfig(use_pallas=False, **kw),
        x0=x), data, x0)
    ours2 = tqcqp._solve_qcqp_rows(ts, *_t(data), mtt.ADMMConfig(**kw),
                                   x0=tt(x0))
    _assert_close(ours2, ref2, 1e-8)
    one = [a[GENEROUS] for a in data]
    with pytest.raises(ValueError, match="not both"):
        mtt.solve_qcqp(ts, *one, x0=x0[0], warmstart_positions=wp[0],
                       device="cpu")
    f32 = mtt.solve_qcqp(ts, *(a.astype(np.float32) for a in one),
                         config=mtt.ADMMConfig(**kw), device="cpu")
    assert f32.d_free.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mtt.solve_qcqp(ts, *one)


@pytest.fixture(scope="module")
def ipm_cold(rows):
    """Cold-started solves of both packages: 12 steps against the default
    Hessian inverse, 25 against the dense Cholesky inverse and the default."""
    ts, js, data = rows

    def ref(n, hess):
        return _jax_rows(lambda a, b, c, d: jipm.solve_qcqp_ipm(
            js, a, b, c, d, config=jipm.IPMConfig(n_iters=n,
                                                  hess_inverse=hess)), data)

    def ours(n):
        return tipm._solve_qcqp_ipm_rows(ts, *_t(data),
                                         config=mtt.IPMConfig(n_iters=n))

    return dict(ref12=ref(12, "schur"), ref25c=ref(25, "cholesky"),
                ref25=ref(25, "schur"), ours12=ours(12), ours25=ours(25))


@pytest.mark.parametrize("row", [GENEROUS, TIGHT, INFEASIBLE], ids=ROW_NAMES)
def test_ipm_cold_start(ipm_cold, row):
    c = ipm_cold
    sel = np.array([row])
    # well-conditioned steps: every field, default reference (the diverging
    # multipliers of the infeasible row, 1e6 in scale, carry 3e-6)
    _assert_close(c["ours12"], c["ref12"], 1e-5 if row == INFEASIBLE else 1e-6,
                  only=sel, floor=1e-12)
    # all 25 steps against the same Newton step by dense Cholesky: the
    # best iterate (the duals are the last iterate's, which is noise once mu
    # has fallen below 1e-12: they are compared at 12 steps above)
    _assert_close(c["ours25"], c["ref25c"], 1e-6, only=sel, floor=1e-9,
                  fields=("d_free", "cost", "coefficients", "max_violation"))
    for name in ("converged", "infeasible"):
        assert (to_np(getattr(c["ours25"], name))[row]
                == np.asarray(getattr(c["ref25c"], name))[row]), name
    # and the solution class of the default reference
    ours, ref = c["ours25"], c["ref25"]
    v_o = float(ours.max_violation[row])
    v_r = float(ref.max_violation[row])
    assert bool(ours.infeasible[row]) == bool(ref.infeasible[row])
    assert bool(ours.infeasible[row]) == (row == INFEASIBLE)
    if row == INFEASIBLE:
        assert v_o > 1.0 and abs(v_o - v_r) <= 1e-6 * v_r
        assert not bool(ours.converged[row])
    else:
        assert v_o < 1e-6 and v_r < 1e-6
        assert abs(float(ours.cost[row]) - float(ref.cost[row])) \
            <= 1e-5 * float(ref.cost[row])
        assert bool(ours.converged[row])


@pytest.fixture(scope="module")
def ipm_warm(rows):
    """Warm-started from a float64 ADMM solve's iterate and duals, and the
    polished composition, in both packages."""
    ts, js, data = rows
    akw = dict(rho=0.005, n_stages=1, n_iters=48, rho_tube_factor=0.125,
               rho_half_factor=0.125)
    admm = tqcqp._solve_qcqp_rows(ts, *_t(data), mtt.ADMMConfig(**akw))
    warm = tuple(to_np(a) for a in (admm.d_free, admm.dual_ball,
                                    admm.dual_half))
    out = {}
    for n in (10, 30):
        # (the default recursive Schur inverse departs by 3e-5 within ten
        # warm steps on the tight row; the dense Cholesky inverse is the same
        # Newton step computed accurately)
        cfg = jipm.IPMConfig(n_iters=n, hess_inverse="cholesky")
        out[f"ref{n}"] = _jax_rows(lambda a, b, c, d, x, lb, lh:
                                   jipm.solve_qcqp_ipm(
                                       js, a, b, c, d, config=cfg, x0=x,
                                       lam0_ball=lb, lam0_half=lh),
                                   data, *warm)
        out[f"ours{n}"] = tipm._solve_qcqp_ipm_rows(
            ts, *_t(data), config=mtt.IPMConfig(n_iters=n),
            x0=admm.d_free, lam0_ball=admm.dual_ball,
            lam0_half=admm.dual_half)
    out["ref_pol"] = _jax_rows(lambda a, b, c, d: jipm.solve_qcqp_polished(
        js, a, b, c, d, ipm_config=jipm.IPMConfig(n_iters=30)), data)
    out["ours_pol"] = tipm._solve_qcqp_polished_rows(
        ts, *_t(data), ipm_config=mtt.IPMConfig(n_iters=30))
    return out


@pytest.mark.parametrize("row", [GENEROUS, TIGHT, INFEASIBLE], ids=ROW_NAMES)
def test_ipm_warm_start(ipm_warm, row):
    w = ipm_warm
    sel = np.array([row])
    best = ("d_free", "cost", "coefficients", "max_violation")
    for n in (10, 30):
        ours, ref = w[f"ours{n}"], w[f"ref{n}"]
        _assert_close(ours, ref, 1e-6, only=sel, floor=1e-9, fields=best)
        if float(ours.dual_residual[row]) > 1e-9:
            # not yet in the endgame: the last iterate is meaningful too
            _assert_close(ours, ref, 1e-5, only=sel, floor=1e-12,
                          fields=("dual_ball", "dual_half", "dual_residual",
                                  "primal_residual"))
    for name in ("converged", "infeasible"):
        assert (to_np(getattr(w["ours30"], name))[row]
                == np.asarray(getattr(w["ref30"], name))[row]), name


@pytest.mark.parametrize("row", [GENEROUS, TIGHT, INFEASIBLE], ids=ROW_NAMES)
def test_polished_solution_class(ipm_warm, row):
    """``solve_qcqp_polished`` (the router's tier-2 stages 0 and 1) against
    the reference's, default Hessian inverse on its side: the class."""
    ours, ref = ipm_warm["ours_pol"], ipm_warm["ref_pol"]
    assert bool(ours.infeasible[row]) == bool(ref.infeasible[row])
    assert bool(ours.converged[row]) == bool(ref.converged[row])
    v_o, v_r = float(ours.max_violation[row]), float(ref.max_violation[row])
    if row == INFEASIBLE:
        assert bool(ours.infeasible[row]) and v_o > 1.0
        assert abs(v_o - v_r) <= 1e-6 * v_r
    else:
        assert v_o < 1e-6 and v_r < 1e-6 and bool(ours.converged[row])
        assert abs(float(ours.cost[row]) - float(ref.cost[row])) \
            <= 1e-6 * float(ref.cost[row])


def test_public_functions_take_one_scenario(rows, ipm_warm):
    ts, _, data = rows
    one = [a[TIGHT] for a in data]
    sol = mtt.solve_qcqp_polished(ts, *one,
                                  ipm_config=mtt.IPMConfig(n_iters=30),
                                  device="cpu")
    assert sol.d_free.shape == (ts.n_free, 3) and sol.cost.shape == ()
    assert sol.infeasible.shape == () and sol.d_free.dtype == torch.float64
    np.testing.assert_allclose(to_np(sol.d_free),
                               to_np(ipm_warm["ours_pol"].d_free)[TIGHT],
                               rtol=0, atol=1e-9)
    cold = mtt.solve_qcqp_ipm(ts, *one, config=mtt.IPMConfig(n_iters=3),
                              device="cpu")
    assert cold.dual_ball.shape == (K - 1 + K * (N - 2), 3)
    with pytest.raises(ValueError, match="together"):
        mtt.solve_qcqp_ipm(ts, *one, lam0_half=np.zeros(2 * K * (N - 2)),
                           device="cpu")
    f32 = mtt.solve_qcqp_ipm(ts, *(a.astype(np.float32) for a in one),
                             config=mtt.IPMConfig(n_iters=3), device="cpu")
    assert f32.d_free.dtype == torch.float32


def test_rows_are_independent(rows):
    """A scenario with non-finite data freezes at its start and touches no
    other row (select, don't scale); the certificate code is shared with the
    plane-layout solver."""
    ts, _, data = rows
    cfg = mtt.IPMConfig(n_iters=6)
    clean = tipm._solve_qcqp_ipm_rows(ts, *_t(data), config=cfg)
    bad = [a.copy() for a in data]
    bad[3][TIGHT, 1, 0] = np.nan               # one radius
    out = tipm._solve_qcqp_ipm_rows(ts, *_t(tuple(bad)), config=cfg)
    keep = [GENEROUS, INFEASIBLE]
    for name in FLOAT_FIELDS:
        np.testing.assert_array_equal(to_np(getattr(out, name))[keep],
                                      to_np(getattr(clean, name))[keep],
                                      err_msg=name)
    assert torch.isfinite(out.d_free[TIGHT]).all()
    assert not bool(out.converged[TIGHT])
    from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes
    assert ipm_lanes._static_certificate is tipm._static_certificate
    cert = tipm._static_certificate(ts, *(_t(data)[i] for i in (1, 0, 2, 3)),
                                    cfg)
    np.testing.assert_array_equal(to_np(cert), [False, False, True])


def test_dense_hessian_for_structures_without_a_band(rows):
    """Three vertices have no block-tridiagonal band: the Newton system is
    inverted densely, and the solve agrees with the reference's."""
    k = 2
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    js = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    from mav_tube_trajectory_generation_tpu_torch.solver import banded
    assert banded.kkt_tridiag_block(ts) is None
    rng = np.random.RandomState(3)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(1, k + 1, 3)), axis=1)
    values = np.zeros((1, k + 1, 5, 3))
    values[:, :, 0, :] = waypoints
    times = to_np(mtt.segment_times_nfabian(tt(waypoints), 3.0, 5.0))
    radii = np.full((1, k, 2), 0.3)
    df = to_np(mtt.extract_fixed_values(ts, tt(values)))
    data = (df, times, waypoints, radii)
    ref = jipm.solve_qcqp_ipm(js, *(jnp.asarray(a[0]) for a in data),
                              config=jipm.IPMConfig(n_iters=12))
    ours = mtt.solve_qcqp_ipm(ts, *(a[0] for a in data),
                              config=mtt.IPMConfig(n_iters=12), device="cpu")
    np.testing.assert_allclose(to_np(ours.d_free), np.asarray(ref.d_free),
                               rtol=0, atol=1e-6 * np.abs(ref.d_free).max())
    assert abs(float(ours.cost) - float(ref.cost)) <= 1e-6 * float(ref.cost)
