"""The module that holds the kernel: the port's ADMM stage (plain PyTorch
version on the CPU) against the JAX package's Pallas kernel in interpret
mode, on the SAME JAX-assembled stage inputs carried over by
``convert.pre_from_numpy`` -- the stage alone, apart from the assembly.

Tolerance: the two differ only in the order of float32 sums (XLA dots vs
PyTorch matmuls), which the 30 iterations neither amplify nor damp much:
5e-5 times the output's scale, max(1, max|reference|).  The constraint-space
quantities (z, u, y, residuals) are equilibrated to O(1), so for them this is
atol 5e-5; the scaled free derivatives x reach ~1e2, so for x it is ~1e-5
relative.  The dual residual max|G^T' (z - z_prev)| amplifies the differences
of z and z_prev by a row sum of |G^T| each.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import admm_kernel as jkernel
from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as tkernel
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import BENCH_KW, jax_pre, to_np, tt

ATOL = 5e-5
NAMES = ("x", "z", "z_prev", "u", "prim", "dual", "y")
N_ITERS = 30
ALPHA = 1.6


@pytest.fixture(scope="module")
def stage_inputs():
    """JAX-assembled pre bundle (K=4, batch 8, float32) -> the port's stage
    inputs, with the factors computed by the JAX package's banded code."""
    kw = {k: v for k, v in BENCH_KW.items() if k != "n_iters"}
    free, pre_np, _ = jax_pre(k=4, batch=8, seed=0, **kw)
    ts = mtt.structure_from_fields(free)
    layout = tqcqp._flagship_layout(ts)
    pre = mtt.pre_from_numpy(pre_np, device="cpu")
    blk = 15
    band = tqcqp._kkt_band(pre.gt, pre.p_eq, blk)
    rho = torch.full((8, 1, 1), kw["rho"], dtype=torch.float32)
    # the band for rho, factored by JAX
    pb_d, pb_u, gd, gu = (jnp.asarray(to_np(a)) for a in band)
    rho_j = jnp.asarray(to_np(rho))[:, None]
    db = pb_d + rho_j * gd + 1e-8 * jnp.eye(blk, dtype=jnp.float32)
    ub = pb_u + rho_j * gu
    s_inv, t_fac = jbanded.spd_block_tridiag_factor(db, ub)
    xq = -jbanded.spd_block_tridiag_solve_factored(
        s_inv, t_fac, jnp.asarray(pre_np["q_flat"])[:, :, None])
    sinv = jnp.stack(s_inv, axis=1)
    t_st = jnp.stack(t_fac[1:], axis=1)
    args_j = dict(rho=jnp.asarray(to_np(rho)), sinv=sinv, t=t_st,
                  tt=jnp.swapaxes(t_st, -1, -2),
                  gt=jnp.asarray(pre_np["gt"]),
                  b=jnp.asarray(pre_np["b_pad"]),
                  rb=jnp.asarray(to_np(tqcqp._rb_pad(pre.rb, layout))),
                  xq=xq, x0=jnp.asarray(pre_np["x_flat0"])[:, :, None])
    assert all(v.dtype == jnp.float32 for v in args_j.values())
    args_t = {k: tt(np.asarray(v)).contiguous() for k, v in args_j.items()}
    return dict(jax=args_j, torch=args_t, layout=layout, pre=pre, band=band,
                rho=rho, q_flat=pre.q_flat)


def _assert_close(ours, ref, name, si, atol=ATOL):
    scale = max(1.0, float(np.abs(ref[np.isfinite(ref)]).max()))
    if name == "dual":
        # max|G^T' (z - z_prev)| sees the differences of z AND of z_prev,
        # each through a row of |G^T| (L1 norm ~8 here).
        scale = max(scale,
                    2.0 * float(to_np(si["torch"]["gt"].abs().sum(-1)).max()))
    np.testing.assert_allclose(ours, ref, atol=atol * scale, rtol=0)


def _run_both(si, init_z, z0=None, u0=None, rho_scale=1.0, n_iters=N_ITERS):
    lay = si["layout"]
    kw = dict(n_iters=n_iters, alpha=ALPHA, nb_p=lay.nb_p, n_ball=lay.n_ball,
              init_z=init_z)
    aj, at = dict(si["jax"]), dict(si["torch"])
    aj["rho"] = aj["rho"] * rho_scale
    at["rho"] = at["rho"] * rho_scale
    ref = jkernel.admm_stage_fused_factored(
        *aj.values(), None if z0 is None else jnp.asarray(z0),
        None if u0 is None else jnp.asarray(u0), interpret=True, **kw)
    before = dict(tkernel.launches)
    ours = tkernel.admm_stage_fused_factored(
        *at.values(), None if z0 is None else tt(z0),
        None if u0 is None else tt(u0), **kw)
    # On CPU tensors the wrapper runs the plain version: no kernel launch.
    assert tkernel.launches == before
    return [np.asarray(a) for a in ref], [to_np(a) for a in ours]


def test_layout_of_carried_inputs(stage_inputs):
    lay = stage_inputs["layout"]
    at = stage_inputs["torch"]
    assert (lay.n_ball, lay.n_half, lay.nb_p, lay.nh_p) == (35, 64, 128, 0)
    assert at["gt"].shape == (8, 45, 384) and at["sinv"].shape == (8, 3, 15, 15)
    assert at["t"].shape == (8, 2, 15, 15) and at["rb"].shape == (8, 1, 128)
    # pad lanes are exact zeros in gt and b; rb is 1 on tail lanes
    used = np.zeros(384, bool)
    for c in range(3):
        used[c * 128:c * 128 + 35] = True
    for (c, lane, _, ln) in lay.half_chunks():
        used[c * 128 + lane:c * 128 + lane + ln] = True
    assert used.sum() == 3 * 35 + 64
    assert (to_np(at["gt"])[:, :, ~used] == 0).all()
    assert (to_np(at["b"])[:, :, ~used] == 0).all()
    assert (to_np(at["rb"])[:, 0, 35:] == 1).all()


def test_stage_factors_match_jax_factors(stage_inputs):
    """The port's own factorization of the JAX-assembled band: float32, KKT
    band cond ~1e3, pivots inverted by different algorithms -> 2e-3 of each
    block's scale; xq (the solve both feed the kernel, values up to ~1e2)
    to 2e-4 of its scale, and the port no further from the float64 solve of
    the same band than that."""
    si = stage_inputs
    sinv, t_st, tt_st, xq = tqcqp._stage_factors(si["band"], si["rho"], 1e-8,
                                                 si["q_flat"])
    ref = si["torch"]
    for ours, name in ((sinv, "sinv"), (t_st, "t"), (tt_st, "tt")):
        r = to_np(ref[name])
        assert ours.is_contiguous()
        assert np.abs(to_np(ours) - r).max() < 2e-3 * np.abs(r).max(), name
    scale = np.abs(to_np(ref["xq"])).max()
    assert np.abs(to_np(xq) - to_np(ref["xq"])).max() < 2e-4 * scale
    xq64 = tqcqp._stage_factors(tuple(b.double() for b in si["band"]),
                                si["rho"].double(), 1e-8,
                                si["q_flat"].double())[3]
    assert np.abs(to_np(xq) - to_np(xq64)).max() < 2e-4 * scale


@pytest.mark.parametrize("name_idx", range(7), ids=NAMES)
def test_stage_init_z_true(stage_inputs, name_idx):
    ref, ours = _stage_cached(stage_inputs, "first")
    assert ours[name_idx].shape == ref[name_idx].shape
    assert ours[name_idx].dtype == np.float32
    _assert_close(ours[name_idx], ref[name_idx], NAMES[name_idx], stage_inputs)


@pytest.mark.parametrize("name_idx", range(7), ids=NAMES)
def test_stage_init_z_false(stage_inputs, name_idx):
    """Second stage: z/u carried in (u rescaled), another rho.  The factors
    are kept (only the stage is under test), which is still a valid ADMM
    map for the comparison."""
    ref, ours = _stage_cached(stage_inputs, "second")
    _assert_close(ours[name_idx], ref[name_idx], NAMES[name_idx], stage_inputs)


_CACHE = {}


def _stage_cached(si, which):
    if "first" not in _CACHE:
        _CACHE["first"] = _run_both(si, init_z=True)
    if which == "second" and "second" not in _CACHE:
        ref1, _ = _CACHE["first"]
        x1, z1, _, u1 = ref1[:4]
        si2 = dict(si)
        si2["jax"] = dict(si["jax"], x0=jnp.asarray(x1))
        si2["torch"] = dict(si["torch"], x0=tt(x1))
        _CACHE["second"] = _run_both(si2, init_z=False, z0=z1, u0=u1 * 0.5,
                                     rho_scale=2.0, n_iters=12)
    return _CACHE[which]


def test_stage_is_meaningful(stage_inputs):
    """Guard against comparing two trivial results: the iterations moved x
    away from the warm start and reduced the primal residual."""
    ref, ours = _stage_cached(stage_inputs, "first")
    x0 = to_np(stage_inputs["torch"]["x0"])
    assert np.abs(ours[0] - x0).max() > 1e-3
    _, zero_it = _run_both(stage_inputs, init_z=True, n_iters=0)
    np.testing.assert_array_equal(zero_it[0], x0)        # n_iters=0: x = x0
    assert np.isinf(zero_it[4]).all()
    assert (ours[4] < 1.0).all() and (ours[4] > 0).all()


def test_plain_is_dtype_generic(stage_inputs):
    """The plain version in float64 on the float32 inputs: same results to
    float32 rounding, and float64 out."""
    lay = stage_inputs["layout"]
    at = {k: v.double() for k, v in stage_inputs["torch"].items()}
    out = tkernel.admm_stage_fused_factored_plain(
        *at.values(), n_iters=N_ITERS, alpha=ALPHA, nb_p=lay.nb_p,
        n_ball=lay.n_ball, init_z=True)
    assert all(o.dtype == torch.float64 for o in out)
    _, ours32 = _stage_cached(stage_inputs, "first")
    for a, b, name in zip(out, ours32, NAMES):
        _assert_close(to_np(a), b, name, stage_inputs)


def test_wrapper_argument_checks(stage_inputs):
    lay = stage_inputs["layout"]
    at = stage_inputs["torch"]
    with pytest.raises(ValueError, match="z0 and u0"):
        tkernel.admm_stage_fused_factored(
            *at.values(), n_iters=1, alpha=ALPHA, nb_p=lay.nb_p,
            n_ball=lay.n_ball, init_z=False)
    assert tkernel.round_up(89, 128) == 128 and tkernel.round_up(128, 128) == 128


def test_projection_matches_reference_formula():
    rng = np.random.RandomState(3)
    nb_p, n_ball = 8, 5
    w = rng.randn(2, 1, 3 * nb_p + 4) * 2
    rb = np.abs(rng.randn(2, 1, nb_p)) + 0.1
    out = to_np(tkernel._project(tt(w), tt(rb), nb_p, n_ball))
    planes = w[:, 0, :3 * nb_p].reshape(2, 3, nb_p)
    norm = np.linalg.norm(planes, axis=1)
    scale = np.where(norm > rb[:, 0], rb[:, 0] / norm, 1.0)
    exp = np.minimum(w, 0.0)
    exp[:, 0, :3 * nb_p] = np.where(
        np.arange(nb_p) < n_ball, planes * scale[:, None, :],
        np.minimum(planes, 0.0)).reshape(2, 3 * nb_p)
    np.testing.assert_allclose(out, exp, rtol=1e-12)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card(stage_inputs):
    """CUDA kernel against the plain version on the same device tensors.
    Needs an NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    lay = stage_inputs["layout"]
    at = {k: v.cuda() for k, v in stage_inputs["torch"].items()}
    kw = dict(n_iters=N_ITERS, alpha=ALPHA, nb_p=lay.nb_p, n_ball=lay.n_ball,
              init_z=True)
    before = tkernel.launches["admm_stage_fused_factored"]
    ours = tkernel.admm_stage_fused_factored(*at.values(), **kw)
    torch.cuda.synchronize()
    assert tkernel.launches["admm_stage_fused_factored"] == before + 1
    plain = tkernel.admm_stage_fused_factored_plain(*at.values(), **kw)
    for a, b, name in zip(ours, plain, NAMES):
        # rsqrtf on the card is not correctly rounded; sums run in another
        # order: 2e-4 of the output's scale.
        _assert_close(to_np(a), to_np(b), name, stage_inputs, atol=2e-4)
