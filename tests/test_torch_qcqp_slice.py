"""The slice as a whole: the port's ``solve_qcqp_batch`` on the host against
the JAX package's, on the same seeded scenarios (K=4, N=10, D=3, batch 8).

Two references:

* float32, ``qcqp.solve_qcqp_batch(use_pallas=True)`` with the Pallas kernel
  in interpret mode -- the very path the port replaces.  Both run the same
  algorithm in float32 but factor the KKT pivots differently (block-Schur vs
  Cholesky) and sum in different orders, and x_tilde reaches ~1e2 with
  cond(KKT) ~6e2, so outputs agree to a few 1e-4 relative, not to the ulp.
* float64, ``solve_qcqp(use_pallas=False)`` vmapped: the generic
  reference-layout path.  Only rounding differs there (suggested 1e-6); it
  catches a wrong formula that float32 noise would hide.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import admm_kernel as jkernel
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as tkernel
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import BENCH_KW, N, jax_pre, problem, to_np, tt

K, B = 4, 8
FIELDS = ("d_free", "coefficients", "cost", "max_violation",
          "primal_residual", "dual_residual", "dual_ball", "dual_half")


@contextlib.contextmanager
def _force_interpret():
    """Run the JAX package's fused factored kernel in interpret mode, stated
    explicitly rather than left to its CPU auto-detection."""
    orig = jkernel.admm_stage_fused_factored
    jkernel.admm_stage_fused_factored = \
        lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        jkernel.admm_stage_fused_factored = orig


def _jax_structure():
    return jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)


def _solve_jax_pallas(p, n_stages, n_iters, mode="values", batch=B):
    free = _jax_structure()
    vals = jnp.asarray(p["values"])
    d_fixed = jlinear.extract_fixed_values(free, vals)
    cfg = jqcqp.ADMMConfig(use_pallas=True, n_stages=n_stages,
                           **{**BENCH_KW, "n_iters": n_iters})
    kw = {}
    if mode == "values":
        kw["warmstart_values"] = vals
    elif mode == "x0":
        kw["x0"] = jnp.asarray(p["x0"])
    with _force_interpret():
        return jqcqp.solve_qcqp_batch(
            free, d_fixed, jnp.asarray(p["times"]),
            jnp.asarray(p["waypoints"]), jnp.asarray(p["radii"]), config=cfg,
            scenario_block=4, **kw)


def _solve_port(p, n_stages, n_iters, mode="values"):
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    cfg = mtt.ADMMConfig(n_stages=n_stages, **{**BENCH_KW, "n_iters": n_iters})
    kw = {}
    if mode == "values":
        kw["warmstart_values"] = p["values"]
    elif mode == "x0":
        kw["x0"] = p["x0"]
    before = dict(tkernel.launches)
    sol = mtt.solve_qcqp_batch(ts, d_fixed, p["times"], p["waypoints"],
                               p["radii"], config=cfg, device="cpu", **kw)
    assert tkernel.launches == before      # host run: no kernel launch
    return sol


def _compare(ours, ref, tols):
    for name in FIELDS:
        a, b = to_np(getattr(ours, name)), to_np(getattr(ref, name))
        assert a.shape == b.shape, name
        rtol, atol = tols[name]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# float32 tolerances (rtol, atol).  The ADMM after a few dozen iterations is
# not at a fixed point, x_tilde reaches ~1e2 and cond(KKT) is ~6e2, so ANY
# float32 run sits at a noise floor above the float64 run of the same
# scenarios.  Measured here (K=4, batch 8, three seeds/configs), port-f32 and
# JAX-f32 each against the port's float64 run: d_free 2-4e-4 of its scale,
# cost 3-7e-5 relative, residuals up to 3e-4 absolute, duals 1-3e-3 of scale
# -- and the two float32 runs are as far from each other as from float64.
# The bounds below are ~3x those floors; the float64 test is the sharp one.
def _f32_tols(ref):
    scale = lambda n: float(np.abs(np.asarray(to_np(getattr(ref, n)))).max())
    return {
        "d_free": (0.0, 2e-3 * scale("d_free")),
        "coefficients": (0.0, 2e-3 * scale("coefficients")),
        "cost": (3e-4, 0.0),
        "max_violation": (0.0, 5e-5),
        "primal_residual": (0.0, 1e-3),
        "dual_residual": (0.0, 5e-4),
        "dual_ball": (0.0, 1e-2 * max(scale("dual_ball"), 1e-3)),
        "dual_half": (0.0, 1e-2 * max(scale("dual_half"), 1e-3)),
    }


@pytest.mark.parametrize("n_stages,n_iters", [(1, 48), (2, 24)])
def test_slice_f32_against_pallas_interpret(n_stages, n_iters):
    p = problem(k=K, batch=B, seed=0)
    ref = _solve_jax_pallas(p, n_stages, n_iters)
    ours = _solve_port(p, n_stages, n_iters)
    assert ours.cost.dtype == torch.float32 and ours.infeasible is None
    _compare(ours, ref, _f32_tols(ref))
    # ... and the port's float32 run is no further from its own float64 run
    # (whose formulas the float64 test below pins to 1e-6).
    p64 = {k: v.astype(np.float64) for k, v in p.items()}
    ours64 = _solve_port(p64, n_stages, n_iters)
    _compare(ours, ours64, _f32_tols(ours64))
    np.testing.assert_array_equal(to_np(ours.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(to_np(ours.times), p["times"])
    # the solve did something: feasible at the benchmark's gate, finite cost
    assert (to_np(ours.max_violation) < 1e-2).all()
    assert np.isfinite(to_np(ours.cost)).all()


def test_slice_f32_x0_branch_and_ragged_batch():
    """``x0=`` instead of the in-solve warm start, on a batch of 7 (not a
    multiple of the reference's scenario block of 4)."""
    p = problem(k=K, batch=7, seed=1)
    p["x0"] = (np.random.RandomState(2).randn(7, 15, 3) * 0.1
               ).astype(np.float32)
    p["x0"][:, 0::5, :] += p["waypoints"][:, 1:-1, :]     # near the waypoints
    ref = _solve_jax_pallas(p, 1, 30, mode="x0")
    ours = _solve_port(p, 1, 30, mode="x0")
    assert ours.cost.shape == (7,)
    _compare(ours, ref, _f32_tols(ref))


def test_slice_f32_no_warmstart_branch():
    p = problem(k=K, batch=B, seed=3)
    ref = _solve_jax_pallas(p, 1, 30, mode="none")
    ours = _solve_port(p, 1, 30, mode="none")
    _compare(ours, ref, _f32_tols(ref))


@pytest.mark.parametrize("n_stages,n_iters", [(1, 40), (2, 20)])
def test_slice_f64_against_generic_reference(n_stages, n_iters):
    """Port in float64 against the JAX package's generic (unpadded, unfused)
    path in float64: different assembly, different KKT solve, same math.
    rtol 1e-6 of each output's scale."""
    p = problem(k=K, batch=B, seed=4, dtype=np.float64)
    free = _jax_structure()
    vals = jnp.asarray(p["values"])
    d_fixed = jlinear.extract_fixed_values(free, vals)
    cfg = jqcqp.ADMMConfig(use_pallas=False, n_stages=n_stages,
                           **{**BENCH_KW, "n_iters": n_iters})
    ref = jax.vmap(lambda df, t, w, r, wv: jqcqp.solve_qcqp(
        free, df, t, w, r, cfg, warmstart_positions=wv[1:-1, 0, :]))(
        d_fixed, jnp.asarray(p["times"]), jnp.asarray(p["waypoints"]),
        jnp.asarray(p["radii"]), vals)
    assert ref.cost.dtype == jnp.float64
    ours = _solve_port(p, n_stages, n_iters)
    assert ours.cost.dtype == torch.float64
    scale = lambda n: float(np.abs(np.asarray(getattr(ref, n))).max())
    tols = {n: (0.0, 1e-6 * max(scale(n), 1.0)) for n in FIELDS}
    _compare(ours, ref, tols)


def test_pre_assembly_f32_against_jax():
    """The assembled stage system itself (gt, b, rb, row scales, objective
    blocks, warm start) against the JAX package's, float32.  gt/b/rb/sb/sh
    are elementwise products of the same factors: 2e-5 relative to scale
    (float32 pow and norms differ by ulps).  The warm start goes through a
    36x36 SPD solve: 2e-4 of its scale."""
    free, pre_np, p = jax_pre(k=K, batch=B, seed=0, **{
        k: v for k, v in BENCH_KW.items() if k != "n_iters"})
    ts = mtt.structure_from_fields(free)
    cfg = mtt.ADMMConfig(**BENCH_KW)
    layout = tqcqp._flagship_layout(ts)
    pre = tqcqp._pre(ts, tt(p["d_fixed"]), tt(p["times"]), tt(p["waypoints"]),
                     tt(p["radii"]), cfg, None, layout,
                     warmstart_positions=tt(p["values"][:, 1:-1, 0, :]))
    # G^T's row factors belong to the gt_assembly="kernel" route only
    assert pre.e_t is None and pre.w_t is None
    for name in pre_np:
        ours, ref = to_np(getattr(pre, name)), pre_np[name]
        assert ours.shape == ref.shape and ours.dtype == np.float32, name
        tol = 2e-4 if name == "x_flat0" else 2e-5
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=tol * np.abs(ref).max(), err_msg=name)
    # pad lanes: exact zeros in gt and b, in both packages
    pad = np.ones(layout.m_p, bool)
    pad[to_np(tt(tqcqp._unpad_index(layout)))] = False
    assert pad.sum() == layout.m_p - 3 * layout.n_ball - layout.n_half
    for arr in (to_np(pre.gt), pre_np["gt"], to_np(pre.b_pad),
                pre_np["b_pad"]):
        assert (arr[..., pad] == 0).all()


def test_gather_maps_and_layout_equal_reference():
    for k in (4, 10):
        tl = tqcqp._PadLayout.make((k - 1) + k * 8, k * 16)
        jl = jqcqp._PadLayout.make((k - 1) + k * 8, k * 16)
        assert tuple(tl) == tuple(jl) and tl.m_p == jl.m_p
        assert tl.half_chunks() == jl.half_chunks()
        for a, b in zip(tqcqp._padded_gather_maps(k, N, tl),
                        jqcqp._padded_gather_maps(k, N, jl)):
            np.testing.assert_array_equal(a, b)
    assert tqcqp._PadLayout.make(89, 160).m_p == 512
    assert tqcqp._row_scale_bounds(10) == jqcqp._row_scale_bounds(10)
    assert tqcqp._row_scale_bounds(12) == jqcqp._row_scale_bounds(12)


def test_config_and_argument_errors():
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    p = problem(k=K, batch=2, seed=0)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    args = (ts, d_fixed, p["times"], p["waypoints"], p["radii"])
    with pytest.raises(ValueError, match="not both"):
        mtt.solve_qcqp_batch(*args, x0=np.zeros((2, 15, 3), np.float32),
                             warmstart_values=p["values"], device="cpu")
    # The KKT route selectors and the G^T assembly are carried over with the
    # JAX defaults, but for the Gram band's: "auto", which is the JAX
    # default's "xla" off the card; the Pallas switch is not.
    assert not hasattr(mtt.ADMMConfig(), "use_pallas")
    for kept in ("rho", "sigma", "alpha", "n_iters", "n_stages", "rho_min",
                 "rho_max", "eps_primal", "eps_dual", "rho_sphere_factor",
                 "rho_tube_factor", "rho_half_factor", "kkt_inverse",
                 "kkt_apply", "gt_assembly"):
        assert getattr(mtt.ADMMConfig(), kept) == \
            getattr(jqcqp.ADMMConfig(), kept)
    assert mtt.ADMMConfig().band_gram == "auto"
    assert jqcqp.ADMMConfig().band_gram == "xla"
    # structures outside the free-interior family are refused up front, not
    # mis-solved
    std = mtt.make_structure(mtt.standard_mask(3, N), 3, N)
    with pytest.raises(ValueError, match="free-interior family"):
        mtt.solve_qcqp_batch(std, np.zeros((1, 12, 3), np.float32),
                             np.ones((1, 2), np.float32),
                             np.zeros((1, 3, 3), np.float32),
                             np.ones((1, 2, 2), np.float32), device="cpu")


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legitimate")
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    p = problem(k=K, batch=2, seed=0)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mtt.solve_qcqp_batch(ts, d_fixed, p["times"], p["waypoints"],
                             p["radii"], warmstart_values=p["values"])


@pytest.mark.gpu
def test_slice_on_the_card_matches_host():
    """Whole slice through the CUDA kernel against the host run.  Needs an
    NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    p = problem(k=K, batch=B, seed=0)
    host = _solve_port(p, 1, 48)
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    before = tkernel.launches["admm_stage_fused_factored"]
    card = mtt.solve_qcqp_batch(
        ts, d_fixed, p["times"], p["waypoints"], p["radii"],
        config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
        warmstart_values=p["values"])
    assert tkernel.launches["admm_stage_fused_factored"] == before + 1
    _compare(card, host, _f32_tols(host))
