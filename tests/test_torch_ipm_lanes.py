"""The port's plane-layout IPM (``solver/ipm_lanes.py``) and the pieces under
it against the JAX package's, on the same seeded float32 scenarios (K=4,
N=10, D=3, batch 8), the JAX side with its Pallas kernels in interpret mode.

Static maps and float64 helpers are compared to rounding.  Whole solves are
float32 on both sides and differ in how the pivot blocks are inverted
(recursive block-Schur in JAX, equilibrated Cholesky here) and in the order
of sums, so:

* after ONE and TWO Newton steps from the same warm start the iterates are
  compared tightly: d_free to 2e-4 of its scale, cost to 5e-4 relative
  (measured 2e-5..5e-5 and 3e-5..1e-4: ten and five times the floor);
* (the same holds for the pipelined schedule and for ``fused=True``, where
  the whole polish is one call of ``ipm_solve_fused``)
* a full polish (6 Newton steps + 2 snap sweeps) is a float32 endgame whose
  iterates are chaotic while its answers are not (the reference's own tests
  say the same, tests/test_ipm_lanes.py): it is held by CLASS -- every
  scenario the reference lands under 1e-4 the port lands under 1e-4 too, the
  port's worst violation is no worse than the reference's class, and costs
  agree to 1e-3 relative (measured 6e-5..1e-4 on this fixture).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.solver import auto as jauto
from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
from mav_tube_trajectory_generation_tpu.solver import ipm as jipm
from mav_tube_trajectory_generation_tpu.solver import ipm_lanes as jlanes
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.solver import auto as tauto
from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes as tlanes
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import BENCH_KW, N, jax_pre, problem, to_np, tt

K, B = 4, 8


def _structures(k=K):
    return (jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N),
            mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N))


# ---------------------------------------------------------------------------
# (b) static maps and helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 10])
def test_lane_and_penalty_maps_equal_reference(k):
    js, ts = _structures(k)
    jl, tl = jqcqp._flagship_layout(js), tqcqp._flagship_layout(ts)
    jm, tm = jlanes._lane_maps(jl), tlanes._lane_maps(tl)
    for name in ("act", "cw", "lane_src", "half_lane"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
        assert getattr(tm, name).dtype == getattr(jm, name).dtype
    assert int(tm.cw.sum()) == tl.n_ball + tl.n_half
    for f in ((1.0, 0.125, 0.125), (2.0, 0.5, 0.25)):
        for a, b in zip(tqcqp.penalty_unscale_maps(ts, tl, *f),
                        jqcqp.penalty_unscale_maps(js, jl, *f)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.float32


@pytest.mark.parametrize("block", [1, 4, 8])
def test_bucket_equals_reference(block):
    for n in list(range(1, 40)) + [255, 256, 257, 1033, 1079, 2048, 6144]:
        assert tauto._bucket(n, block) == jauto._bucket(n, block)
        assert tauto._bucket(n, block) >= n


def test_ipm_config_converts_field_by_field():
    # The port carries every field of the reference but the two that only
    # pick among that package's accelerator back ends (the fused kernel's
    # scenario block and the row solver's Hessian inverse), in its order.
    ours, ref = mtt.IPMConfig(), jipm.IPMConfig()
    skipped = {"fused_block", "hess_inverse"}
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref) if f.name not in skipped]

    def common(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k not in skipped}

    assert dataclasses.asdict(ours) == common(ref)
    odd = jipm.IPMConfig(n_iters=7, sigma_min=0.3, corrector=False,
                         pipelined=True, refactor_every=2, snap_iters=5,
                         fused_block=4, hess_inverse="cholesky")
    assert dataclasses.asdict(mtt.ipm_config_from_fields(odd)) == common(odd)
    with pytest.raises(ValueError, match="highest"):
        mtt.IPMConfig(gram_precision="default")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 5e-6)])
def test_build_constraints_against_reference(dtype, tol):
    """Same formulas, elementwise products and short einsums: 1e-12 of each
    tensor's scale in float64, 5e-6 in float32 (pow and norm differ by
    ulps)."""
    js, ts = _structures()
    p = problem(k=K, batch=3, seed=2, dtype=dtype, radius=0.4)
    d_fixed = to_np(mtt.extract_fixed_values(ts, tt(p["values"])))
    ref = jax.vmap(lambda t, df, w, r: jqcqp.build_constraints(
        js, t, df, w, r))(jnp.asarray(p["times"]), jnp.asarray(d_fixed),
                          jnp.asarray(p["waypoints"]),
                          jnp.asarray(p["radii"]))
    ours = mtt.build_constraints(ts, tt(p["times"]), tt(d_fixed),
                                 tt(p["waypoints"]), tt(p["radii"]))
    for name in ours._fields:
        a, b = to_np(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == dtype, name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=name)


def test_static_certificate_against_reference_and_constraint_form():
    """The certificate from the rows' factored norms equals the reference's
    (which reads the materialized Jacobians) and the same test written on the
    port's own ``build_constraints`` tensors: a start 5 units off the
    corridor fires it, the untouched scenarios do not."""
    js, ts = _structures()
    p = problem(k=K, batch=6, seed=3, radius=0.05)
    d_fixed = to_np(mtt.extract_fixed_values(ts, tt(p["values"]))).copy()
    d_fixed[1, 0, :] += 5.0
    d_fixed[4, 0, :] -= 3.0
    cfg_t, cfg_j = mtt.IPMConfig(), jipm.IPMConfig()
    args = (p["times"], d_fixed, p["waypoints"], p["radii"])
    ours = to_np(tlanes._static_certificate(ts, *(tt(a) for a in args),
                                            cfg_t))
    ref = np.asarray(jlanes._static_certificate(
        js, *(jnp.asarray(a) for a in args), cfg_j))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [False, True, False, False, True,
                                         False])
    cons = mtt.build_constraints(ts, *(tt(a) for a in args))
    ball_jac = cons.g_ball.square().sum(dim=(2, 3, 4)).sqrt()
    ball_const = torch.linalg.vector_norm(cons.b_ball, dim=2)
    half_jac = cons.g_half.square().sum(dim=(2, 3)).sqrt()
    direct = (((ball_jac < 1e-9 * (1.0 + ball_const))
               & (ball_const - cons.r_ball > cfg_t.eps_feas)).any(dim=1)
              | ((half_jac < 1e-9 * (1.0 + cons.b_half.abs()))
                 & (cons.b_half > cfg_t.eps_feas)).any(dim=1))
    np.testing.assert_array_equal(ours, to_np(direct))
    # and the factored norms themselves equal the materialized ones
    geo = tqcqp._constraint_geometry(ts, *(tt(a) for a in args))
    e_mid = torch.linalg.vector_norm(geo.ecp, dim=-1)[:, :, 1:N - 1]
    half_fact = (e_mid[:, :, :, None] * torch.linalg.vector_norm(
        geo.dirs, dim=-1)[:, :, None, :]).reshape(6, -1)
    np.testing.assert_allclose(to_np(half_fact), to_np(half_jac), rtol=2e-6)


def test_pe_band_against_reference():
    rng = np.random.RandomState(4)
    p_eq = rng.randn(3, 15, 15)
    ours = tlanes._pe_band(tt(p_eq), 3, 15)
    ref = jlanes._pe_band(jnp.asarray(p_eq), 3, 15)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert ours[0].shape == (3, 3, 15, 15) and ours[1].shape == (3, 2, 15, 15)


def _stiff_band(rng, batch, m, blk):
    """An SPD band with O(1e4) entries next to O(1) ones, as the
    penalty-weighted Newton Hessians have."""
    n = m * blk
    a = rng.randn(batch, n, n)
    mask = np.kron(np.eye(m) + np.eye(m, k=1) + np.eye(m, k=-1),
                   np.ones((blk, blk)))
    dense = (a @ a.transpose(0, 2, 1)) * mask + 3.0 * n * np.eye(n)
    scale = np.exp(rng.uniform(0.0, np.log(1e2), size=(batch, n)))
    dense = dense * scale[:, :, None] * scale[:, None, :]
    hd = np.stack([dense[:, i * blk:(i + 1) * blk, i * blk:(i + 1) * blk]
                   for i in range(m)], axis=1)
    hu = np.stack([dense[:, i * blk:(i + 1) * blk,
                         (i + 1) * blk:(i + 2) * blk]
                   for i in range(m - 1)], axis=1)
    return dense, hd, hu


def test_equilibrated_band_solve_against_reference():
    """float64: both solve the same equilibrated system, 1e-8 relative.
    float32: each against the float64 solution, 2e-4 of its scale (the
    equilibrated system has cond ~1e2)."""
    rng = np.random.RandomState(5)
    dense, hd, hu = _stiff_band(rng, 3, 4, 6)
    rhs = rng.randn(3, 24, 1)
    exact = np.linalg.solve(dense, rhs)
    ours = to_np(tlanes._equilibrated_band_solve(tt(hd), tt(hu))(tt(rhs)))
    ref = np.asarray(jlanes._equilibrated_band_solve(
        jnp.asarray(hd), jnp.asarray(hu))(jnp.asarray(rhs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(ours, exact, rtol=1e-8, atol=1e-14)
    f = np.float32
    ours32 = to_np(tlanes._equilibrated_band_solve(
        tt(hd.astype(f)), tt(hu.astype(f)))(tt(rhs.astype(f))))
    assert ours32.dtype == f
    assert np.abs(ours32 - exact).max() < 2e-4 * np.abs(exact).max()
    # equilibration is what makes the float32 factor usable: the factors
    # are those of the unit-diagonal system
    s_inv, _, d = tlanes._equilibrated_band_factor(tt(hd), tt(hu))
    np.testing.assert_allclose(
        to_np(d) ** 2 * np.diagonal(dense, axis1=1, axis2=2), 1.0, rtol=1e-12)


def test_finite_step_mask_catches_nan_directions():
    ds = torch.ones((3, 7))
    dlam = torch.ones((3, 7))
    ds[1] = float("nan")
    dlam[2, 4] = float("inf")
    v = torch.full((3, 7), 0.5)
    alpha = tlanes.ipm_kernel._max_step_k(v, ds, 0.995)
    assert bool(torch.isfinite(alpha).all())   # alpha alone would pass NaNs
    upd = tlanes._finite_step_mask(alpha, ds, dlam)
    np.testing.assert_array_equal(to_np(upd[:, 0]), [True, False, False])
    ref = jlanes._finite_step_mask(jnp.asarray(to_np(alpha)),
                                   jnp.asarray(to_np(ds)),
                                   jnp.asarray(to_np(dlam)))
    np.testing.assert_array_equal(to_np(upd), np.asarray(ref))


# ---------------------------------------------------------------------------
# (c) whole solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warm():
    """Scenarios plus the port's ADMM iterate and duals as NumPy: the warm
    start both packages polish from."""
    js, ts = _structures()
    p = problem(k=K, batch=B, seed=0)
    p["d_fixed"] = to_np(mtt.extract_fixed_values(ts, tt(p["values"])))
    a = mtt.solve_qcqp_batch(
        ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"],
        config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
        warmstart_values=p["values"], device="cpu")
    ws = dict(x0=to_np(a.d_free), lam0_ball=to_np(a.dual_ball),
              lam0_half=to_np(a.dual_half))
    return js, ts, p, ws


def _both(warm, **cfg):
    js, ts, p, ws = warm
    args = (p["d_fixed"], p["times"], p["waypoints"], p["radii"])
    ref = jlanes.solve_qcqp_ipm_lanes(
        js, *(jnp.asarray(a) for a in args), config=jipm.IPMConfig(**cfg),
        scenario_block=4, interpret=True,
        **{k: jnp.asarray(v) for k, v in ws.items()})
    ours = mtt.solve_qcqp_ipm_lanes(ts, *args, config=mtt.IPMConfig(**cfg),
                                    device="cpu", **ws)
    return ours, ref


def _rel(a, b):
    a, b = to_np(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("corrector", [True, False])
@pytest.mark.parametrize("n_iters", [1, 2])
def test_lanes_first_steps_against_reference(warm, corrector, n_iters):
    ours, ref = _both(warm, n_iters=n_iters, snap_iters=0,
                      corrector=corrector, sigma_min=0.3)
    assert ours.cost.dtype == torch.float32
    assert _rel(ours.d_free, ref.d_free) < 2e-4
    assert _rel(ours.coefficients, ref.coefficients) < 2e-4
    assert _rel(ours.cost, ref.cost) < 5e-4
    np.testing.assert_allclose(to_np(ours.max_violation),
                               np.asarray(ref.max_violation), atol=2e-6)
    # mu = mean(s lam), the merit pieces and the duals of the running state
    np.testing.assert_allclose(to_np(ours.dual_residual),
                               np.asarray(ref.dual_residual), rtol=2e-2)
    assert _rel(ours.dual_ball, ref.dual_ball) < 5e-3
    assert _rel(ours.dual_half, ref.dual_half) < 5e-3
    np.testing.assert_array_equal(to_np(ours.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(to_np(ours.infeasible),
                                  np.asarray(ref.infeasible))


def _same_class(ours, ref):
    v_o, v_r = to_np(ours.max_violation), np.asarray(ref.max_violation)
    assert (v_o[v_r < 1e-4] < 1e-4).all(), (v_o, v_r)
    assert v_o.max() <= max(10.0 * v_r.max(), 1e-5), (v_o, v_r)
    assert _rel(ours.cost, ref.cost) < 1e-3
    assert not to_np(ours.infeasible).any()
    assert np.isfinite(to_np(ours.d_free)).all()


@pytest.mark.parametrize("corrector", [True, False])
def test_lanes_full_polish_scan_against_reference(warm, corrector):
    ours, ref = _both(warm, n_iters=6, snap_iters=2, corrector=corrector,
                      sigma_min=0.3)
    _same_class(ours, ref)
    assert (to_np(ours.max_violation) < 1e-4).all()


def test_lanes_full_polish_pipelined_against_reference_and_own_scan(warm):
    ours, ref = _both(warm, n_iters=6, snap_iters=2, corrector=False,
                      sigma_min=0.3, pipelined=True)
    _same_class(ours, ref)
    # the pipelined schedule lands in the scan schedule's solution class
    # (as tests/test_ipm_lanes.py:166 asks of the reference): costs within
    # 0.1 % median / 1 % worst, violations in the same class
    js, ts, p, ws = warm
    scan = mtt.solve_qcqp_ipm_lanes(
        ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"],
        config=mtt.IPMConfig(n_iters=6, snap_iters=2, corrector=False,
                             sigma_min=0.3), device="cpu", **ws)
    rel = np.abs(to_np(ours.cost) - to_np(scan.cost)) / to_np(scan.cost)
    assert np.median(rel) < 1e-3 and rel.max() < 1e-2, rel
    assert to_np(ours.max_violation).max() < 1e-4
    with pytest.raises(ValueError, match="corrector=False"):
        mtt.solve_qcqp_ipm_lanes(
            ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"],
            config=mtt.IPMConfig(n_iters=2, pipelined=True), device="cpu",
            **ws)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_lanes_fused_first_steps_against_reference(warm, n_iters):
    """``IPMConfig(fused=True)``: the whole polish through
    ``ipm_solve_fused`` (the plain version here, the Pallas kernel in
    interpret mode there), after one and two Newton steps: the tolerances of
    the scan path's first steps."""
    ours, ref = _both(warm, n_iters=n_iters, snap_iters=0, corrector=False,
                      sigma_min=0.3, fused=True)
    assert ours.cost.dtype == torch.float32
    assert _rel(ours.d_free, ref.d_free) < 2e-4
    assert _rel(ours.cost, ref.cost) < 5e-4
    np.testing.assert_allclose(to_np(ours.max_violation),
                               np.asarray(ref.max_violation), atol=2e-6)
    np.testing.assert_allclose(to_np(ours.dual_residual),
                               np.asarray(ref.dual_residual), rtol=2e-2)
    assert _rel(ours.dual_ball, ref.dual_ball) < 5e-3
    np.testing.assert_array_equal(to_np(ours.infeasible),
                                  np.asarray(ref.infeasible))


def test_lanes_full_polish_fused_against_reference_and_own_scan(warm):
    cfg = dict(n_iters=6, snap_iters=2, corrector=False, sigma_min=0.3)
    ours, ref = _both(warm, fused=True, **cfg)
    _same_class(ours, ref)
    # the fused schedule lands in the scan schedule's solution class (as
    # tests/test_ipm_lanes.py:151-157 asks of the reference): costs within
    # 0.1 % median / 1 % worst, violations in the same class
    js, ts, p, ws = warm
    args = (ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"])
    scan = mtt.solve_qcqp_ipm_lanes(*args, config=mtt.IPMConfig(**cfg),
                                    device="cpu", **ws)
    rel = np.abs(to_np(ours.cost) - to_np(scan.cost)) / to_np(scan.cost)
    assert np.median(rel) < 1e-3 and rel.max() < 1e-2, rel
    assert to_np(ours.max_violation).max() < 1e-4
    np.testing.assert_array_equal(to_np(ours.converged),
                                  to_np(scan.converged))
    # the two schedules the kernel does not implement
    with pytest.raises(ValueError, match="corrector=False"):
        mtt.solve_qcqp_ipm_lanes(
            *args, config=mtt.IPMConfig(n_iters=2, fused=True), device="cpu",
            **ws)
    with pytest.raises(ValueError, match="mutually exclusive"):
        mtt.solve_qcqp_ipm_lanes(
            *args, config=mtt.IPMConfig(n_iters=2, corrector=False,
                                        fused=True, pipelined=True),
            device="cpu", **ws)


def test_fused_snap_only_and_polished_batch(warm):
    """n_iters=0 through the fused kernel: lam_growth is 1 (the kernel's
    lam_mid stays 0), so only the static certificate can fire; and
    ``solve_qcqp_polished_batch`` hands a fused configuration through, on the
    ADMM's assembled system."""
    js, ts, p, ws = warm
    ours, ref = _both(warm, n_iters=0, snap_iters=2, corrector=False,
                      sigma_min=0.3, fused=True)
    assert not to_np(ours.infeasible).any()
    assert not np.asarray(ref.infeasible).any()
    assert _rel(ours.cost, ref.cost) < 2e-3
    assert to_np(ours.max_violation).max() < 1e-5
    big = {**ws, "lam0_ball": ws["lam0_ball"] * 1e6}
    args = (ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"])
    res = mtt.solve_qcqp_ipm_lanes(
        *args, config=mtt.IPMConfig(n_iters=0, snap_iters=1, corrector=False,
                                    fused=True), device="cpu", **big)
    assert not to_np(res.infeasible).any()
    cfg = dict(n_iters=6, snap_iters=2, corrector=False, sigma_min=0.3)
    kw = dict(admm_config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
              warmstart_values=p["values"], device="cpu")
    fused = mtt.solve_qcqp_polished_batch(
        *args, ipm_config=mtt.IPMConfig(fused=True, **cfg), **kw)
    scan = mtt.solve_qcqp_polished_batch(
        *args, ipm_config=mtt.IPMConfig(**cfg), **kw)
    rel = np.abs(to_np(fused.cost) - to_np(scan.cost)) / to_np(scan.cost)
    assert np.median(rel) < 1e-3 and rel.max() < 1e-2, rel
    assert to_np(fused.max_violation).max() < 1e-4


def test_snap_only_run_has_the_dynamic_certificate_off(warm):
    """n_iters=0 (tier 0 of the strict router): no Newton step ran, so
    lam_growth is 1 and only the static certificate can fire; the snap pulls
    the ADMM's 1e-4-class violations down."""
    js, ts, p, ws = warm
    ours, ref = _both(warm, n_iters=0, snap_iters=2, corrector=False,
                      sigma_min=0.3, pipelined=True)
    assert not to_np(ours.infeasible).any()
    assert not np.asarray(ref.infeasible).any()
    assert _rel(ours.cost, ref.cost) < 2e-3
    assert to_np(ours.max_violation).max() < 1e-5
    # with a warm state made to look divergent the certificate stays off
    big = {**ws, "lam0_ball": ws["lam0_ball"] * 1e6}
    res = mtt.solve_qcqp_ipm_lanes(
        ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"],
        config=mtt.IPMConfig(n_iters=0, snap_iters=1, corrector=False,
                             pipelined=True), device="cpu", **big)
    assert not to_np(res.infeasible).any()


def test_lanes_pre_reuse_against_reference():
    """``pre=``: both packages polish from the JAX package's assembled
    system (penalty factors 0.125 baked in, undone by the static maps), and
    the port's own ``_return_pre`` bundle gives the same answer as its fresh
    assembly."""
    free, pre_np, p = jax_pre(k=K, batch=B, seed=0, n_iters=2, **{
        k: v for k, v in BENCH_KW.items() if k != "n_iters"})
    ts = mtt.structure_from_fields(free)
    a = mtt.solve_qcqp_batch(
        ts, p["d_fixed"], p["times"], p["waypoints"], p["radii"],
        config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
        warmstart_values=p["values"], device="cpu", _return_pre=True)
    sol, pre_t = a
    ws = dict(x0=to_np(sol.d_free), lam0_ball=to_np(sol.dual_ball),
              lam0_half=to_np(sol.dual_half))
    cfg = dict(n_iters=2, snap_iters=1, corrector=False, sigma_min=0.3)
    pen = (1.0, 0.125, 0.125)
    args = (p["d_fixed"], p["times"], p["waypoints"], p["radii"])
    pre_j = jqcqp._PallasPre(**{k: jnp.asarray(v) for k, v in pre_np.items()},
                             p_big=jnp.asarray(pre_np["q_flat"]))
    ref = jlanes.solve_qcqp_ipm_lanes(
        free, *(jnp.asarray(x) for x in args), config=jipm.IPMConfig(**cfg),
        scenario_block=4, interpret=True, pre=pre_j, pre_penalty=pen,
        **{k: jnp.asarray(v) for k, v in ws.items()})
    ours = mtt.solve_qcqp_ipm_lanes(
        ts, *args, config=mtt.IPMConfig(**cfg), device="cpu",
        pre=mtt.pre_from_numpy(pre_np, device="cpu"), pre_penalty=pen, **ws)
    assert _rel(ours.d_free, ref.d_free) < 2e-4
    assert _rel(ours.cost, ref.cost) < 5e-4
    np.testing.assert_allclose(to_np(ours.max_violation),
                               np.asarray(ref.max_violation), atol=2e-6)
    own = mtt.solve_qcqp_ipm_lanes(
        ts, *args, config=mtt.IPMConfig(**cfg), device="cpu", pre=pre_t,
        pre_penalty=pen, **ws)
    fresh = mtt.solve_qcqp_ipm_lanes(
        ts, *args, config=mtt.IPMConfig(**cfg), device="cpu", **ws)
    assert _rel(own.d_free, fresh.d_free) < 2e-4
    assert _rel(own.cost, fresh.cost) < 5e-4
    with pytest.raises(ValueError, match="requires x0"):
        mtt.solve_qcqp_ipm_lanes(ts, *args, device="cpu", pre=pre_t)


def test_lanes_argument_errors():
    ts = _structures()[1]
    p = problem(k=K, batch=2, seed=0)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    args = (ts, d_fixed, p["times"], p["waypoints"], p["radii"])
    # fused=True needs corrector=False (it used to be refused altogether)
    with pytest.raises(ValueError, match="corrector=False"):
        mtt.solve_qcqp_ipm_lanes(*args, config=mtt.IPMConfig(fused=True),
                                 device="cpu")
    sol = mtt.solve_qcqp_ipm_lanes(
        *args, config=mtt.IPMConfig(n_iters=2, corrector=False, fused=True),
        device="cpu")
    assert sol.d_free.shape == (2, 15, 3) and np.isfinite(
        to_np(sol.cost)).all()
    with pytest.raises(ValueError, match="together"):
        mtt.solve_qcqp_ipm_lanes(*args, lam0_half=np.zeros((2, 64)),
                                 device="cpu")
    mask = mtt.standard_mask(K + 1, N)
    mask[2, 1] = True              # interior vertices no longer uniform
    mixed = mtt.make_structure(mask, 3, N)
    with pytest.raises(ValueError, match="flagship"):
        mtt.solve_qcqp_ipm_lanes(mixed, *args[1:], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mtt.solve_qcqp_ipm_lanes(*args)


def test_cold_start_runs_and_improves():
    """No warm start at all: the unconstrained minimum, unit multipliers."""
    ts = _structures()[1]
    p = problem(k=K, batch=4, seed=6)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    sol = mtt.solve_qcqp_ipm_lanes(
        ts, d_fixed, p["times"], p["waypoints"], p["radii"],
        config=mtt.IPMConfig(n_iters=25), device="cpu")
    assert np.isfinite(to_np(sol.cost)).all()
    assert np.median(to_np(sol.max_violation)) < 1e-2
