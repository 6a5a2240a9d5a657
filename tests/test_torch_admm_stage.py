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

The kernel's cluster design computes the stage in another order, x = xq +
rho W^-1 (G^T v) with the dense W^-1 formed from the factors;
``admm_stage_fused_factored_winv_plain`` is that order in plain PyTorch.  It
is held against the JAX kernel (K=4 at batch 8, K=10 at batch 32, the
benchmark's 48 iterations): its stage outputs at the tolerance above, the
solve it gives in place of the stage at the KKT routes' cost-gap limits
(median 1e-3, 99th percentile 1e-2 relative), and, in float64, the
reference order's plain version at 1e-9 of each output's scale (the JAX
kernel fixes its outputs at float32, so it has no float64 run; in float64
only rounding parts the two orders, 1e-12 measured).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import admm_kernel as jkernel
from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as tkernel
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import (BENCH_KW, H100_SMEM_OPTIN, N, blocks_an_sm,
                             jax_pre, problem, to_np, tt)

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


# ---------------------------------------------------------------------------
# The cluster design's order (admm_stage_fused_factored_winv_plain)
# ---------------------------------------------------------------------------

ORDER_CASES = {"K=4": (4, 8), "K=10": (10, 32)}
COST_GAP_MEDIAN = 1e-3
COST_GAP_P99 = 1e-2
F64_RTOL = 1e-9


@pytest.fixture(scope="module", params=list(ORDER_CASES))
def order_case(request):
    """Stage inputs of a JAX assembly (numpy-seeded scenarios, factors by the
    port), the benchmark's 48 iterations, and the JAX kernel's outputs on
    them in interpret mode."""
    k, batch = ORDER_CASES[request.param]
    kw = {n: v for n, v in BENCH_KW.items() if n != "n_iters"}
    free, pre_np, _ = jax_pre(k=k, batch=batch, seed=0, **kw)
    layout = tqcqp._flagship_layout(mtt.structure_from_fields(free))
    pre = mtt.pre_from_numpy(pre_np, device="cpu")
    band = tqcqp._kkt_band(pre.gt, pre.p_eq, 15)
    rho = torch.full((batch, 1, 1), kw["rho"], dtype=torch.float32)
    sinv, t_st, tt_st, xq = tqcqp._stage_factors(band, rho, 1e-8,
                                                 pre.q_flat)
    args = (rho, sinv, t_st, tt_st, pre.gt.contiguous(),
            pre.b_pad.contiguous(), tqcqp._rb_pad(pre.rb, layout), xq,
            pre.x_flat0[:, :, None].contiguous())
    skw = dict(n_iters=BENCH_KW["n_iters"], alpha=ALPHA, nb_p=layout.nb_p,
               n_ball=layout.n_ball)
    ref = jkernel.admm_stage_fused_factored(
        *(jnp.asarray(to_np(a)) for a in args), interpret=True, **skw)
    return dict(k=k, batch=batch, args=args, kw=skw,
                ref=[np.asarray(r) for r in ref])


def test_winv_order_f32_against_jax_kernel(order_case):
    """Per output, no further from the reference order run in float64 than
    float32 runs of the reference order are -- the JAX kernel's and the
    port's plain version's, the larger of the two -- thrice over, plus 1e-6
    of the output's scale.  (float32 noise grows with K and the iterations:
    at K=10 and 48 iterations the JAX kernel's prim is 1e-4 from float64,
    and the dual, max|G^T (z - z_prev)| of a difference of close vectors,
    2.5e-4 for the JAX kernel and 1.2e-3 for the plain version.)"""
    args, kw = order_case["args"], order_case["kw"]
    ours = tkernel.admm_stage_fused_factored_winv_plain(*args, **kw)
    ref32 = tkernel.admm_stage_fused_factored_plain(*args, **kw)
    ref64 = tkernel.admm_stage_fused_factored_plain(
        *(a.double() for a in args), **kw)
    for a, r, p, c, name in zip(ours, order_case["ref"], ref32, ref64, NAMES):
        assert a.dtype == torch.float32 and a.shape == r.shape
        c = to_np(c)
        scale = max(1.0, float(np.abs(c[np.isfinite(c)]).max()))
        err = np.abs(to_np(a).astype(np.float64) - c).max()
        floor = max(np.abs(r.astype(np.float64) - c).max(),
                    np.abs(to_np(p).astype(np.float64) - c).max())
        assert err <= 3.0 * floor + 1e-6 * scale, (name, err, floor)


def test_winv_order_f64_matches_reference_order(order_case):
    args = tuple(a.double() for a in order_case["args"])
    kw = order_case["kw"]
    ours = tkernel.admm_stage_fused_factored_winv_plain(*args, **kw)
    ref = tkernel.admm_stage_fused_factored_plain(*args, **kw)
    for a, r, name in zip(ours, ref, NAMES):
        assert a.dtype == torch.float64
        scale = max(1.0, float(r[torch.isfinite(r)].abs().max()))
        np.testing.assert_allclose(to_np(a), to_np(r), rtol=0,
                                   atol=F64_RTOL * scale, err_msg=name)
    # the order changed nothing but rounding: W^-1 from the sweeps is the
    # inverse of the KKT matrix the factors factor
    sinv, t_st, tt_st = args[1:4]
    nfd = args[4].shape[1]
    eye = torch.eye(nfd, dtype=torch.float64).expand(args[4].shape[0], -1, -1)
    winv = tkernel.factored_solve(sinv, t_st, tt_st, eye)
    np.testing.assert_allclose(to_np(winv), to_np(winv.transpose(1, 2)),
                               rtol=0, atol=1e-9 * float(winv.abs().max()))


def test_winv_order_cost_gap_against_jax(order_case, monkeypatch):
    """The whole solve with the stage in the cluster design's order (its
    plain version in place of the wrapper) against the JAX package's solve
    with its Pallas kernel in interpret mode, on the same scenarios."""
    k, batch = order_case["k"], order_case["batch"]
    p = problem(k=k, batch=batch, seed=0)
    jfree = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    vals = jnp.asarray(p["values"])
    orig = jkernel.admm_stage_fused_factored
    monkeypatch.setattr(jkernel, "admm_stage_fused_factored",
                        lambda *a, **kw: orig(*a, **{**kw,
                                                     "interpret": True}))
    ref = jqcqp.solve_qcqp_batch(
        jfree, jlinear.extract_fixed_values(jfree, vals),
        jnp.asarray(p["times"]), jnp.asarray(p["waypoints"]),
        jnp.asarray(p["radii"]),
        config=jqcqp.ADMMConfig(use_pallas=True, n_stages=1, **BENCH_KW),
        warmstart_values=vals, scenario_block=4)
    monkeypatch.setattr(tkernel, "admm_stage_fused_factored",
                        tkernel.admm_stage_fused_factored_winv_plain)
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    before = dict(tkernel.launches)
    ours = mtt.solve_qcqp_batch(
        ts, mtt.extract_fixed_values(ts, tt(p["values"])), p["times"],
        p["waypoints"], p["radii"], config=mtt.ADMMConfig(n_stages=1,
                                                          **BENCH_KW),
        device="cpu", warmstart_values=p["values"])
    assert tkernel.launches == before
    c_ours, c_ref = to_np(ours.cost).astype(np.float64), np.asarray(ref.cost)
    gap = np.abs(c_ours - c_ref) / np.abs(c_ref)
    assert np.isfinite(gap).all()
    assert np.median(gap) <= COST_GAP_MEDIAN, gap
    assert np.quantile(gap, 0.99) <= COST_GAP_P99, gap


@pytest.mark.parametrize("k", [2, 4, 10, None],
                         ids=["K=2", "K=4", "K=10", "odd planes"])
def test_cluster_lane_split(k):
    """Every lane in exactly one block of the cluster design; each ball
    triple and its rb[j] in one block, at local lanes (i, hb + i, 2 hb + i);
    the final half-space plane (K=10 has one, K=2 and K=4 none) split in
    order."""
    if k is None:
        nb_p, m_p = 5, 3 * 5 + 7
    else:
        layout = tqcqp._flagship_layout(
            mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N))
        nb_p, m_p = layout.nb_p, layout.m_p
        assert (layout.nh_p > 0) == (k == 10)
    split = tkernel.cluster_lane_split(m_p, nb_p)
    assert len(split) == 2
    lanes = [l for block, _ in split for l in block]
    assert sorted(lanes) == list(range(m_p))
    assert sorted(j for _, balls in split for j in balls) == list(range(nb_p))
    for block, balls in split:
        hb = len(balls)
        for i, j in enumerate(balls):
            assert [block[i], block[hb + i], block[2 * hb + i]] == [
                j, nb_p + j, 2 * nb_p + j]
        half = block[3 * hb:]
        assert all(l >= 3 * nb_p for l in half)
        assert not half or half == list(range(half[0], half[0] + len(half)))
    assert split[0][1].start == 0
    assert abs(len(split[0][0]) - len(split[1][0])) <= 4
    final0 = split[0][0][3 * len(split[0][1]):]
    final1 = split[1][0][3 * len(split[1][1]):]
    assert final0 + final1 == list(range(3 * nb_p, m_p))


@pytest.mark.gpu
def test_cluster_design_on_the_card(stage_inputs):
    """The factored kernel at K=4 takes the cluster design; it agrees with
    its order's plain version on the same device tensors, in both entry
    modes, and gives the same bits run to run.  Needs an NVIDIA card and
    nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    lay = stage_inputs["layout"]
    at = {k: v.cuda() for k, v in stage_inputs["torch"].items()}
    nfd, m_p = at["gt"].shape[1:]
    assert tkernel.factored_design(nfd, m_p, 3, 15, lay.nb_p) == "cluster"
    kw = dict(n_iters=N_ITERS, alpha=ALPHA, nb_p=lay.nb_p, n_ball=lay.n_ball)
    first = tkernel.admm_stage_fused_factored(*at.values(), init_z=True, **kw)
    again = tkernel.admm_stage_fused_factored(*at.values(), init_z=True, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    carried = (first[1].contiguous(), (0.5 * first[3]).contiguous())
    for init_z, extra in ((True, ()), (False, carried)):
        ours = tkernel.admm_stage_fused_factored(*at.values(), *extra,
                                                 init_z=init_z, **kw)
        plain = tkernel.admm_stage_fused_factored_winv_plain(
            *at.values(), *extra, init_z=init_z, **kw)
        for a, b, name in zip(ours, plain, NAMES):
            _assert_close(to_np(a), to_np(b), name, stage_inputs, atol=2e-4)


def _port_stage_inputs(k, batch, seed=1):
    """Stage inputs of the port's own assembly on the CPU (K segments,
    numpy-seeded scenarios), as the headline path builds them."""
    cfg = mtt.ADMMConfig(**BENCH_KW)
    sc = mtt.make_inputs(k, batch, seed=seed, device="cpu")
    layout = tqcqp._flagship_layout(sc.free)
    pre = tqcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                     sc.radii, cfg, None, layout,
                     warmstart_positions=sc.values[:, 1:-1, 0, :])
    band = tqcqp._kkt_band(pre.gt, pre.p_eq, 15)
    rho = torch.full((batch, 1, 1), cfg.rho, dtype=torch.float32)
    sinv, t_st, tt_st, xq = tqcqp._stage_factors(band, rho, cfg.sigma,
                                                 pre.q_flat)
    args = (rho, sinv, t_st, tt_st, pre.gt.contiguous(),
            pre.b_pad.contiguous(), tqcqp._rb_pad(pre.rb, layout), xq,
            pre.x_flat0[:, :, None].contiguous())
    return args, layout


@pytest.mark.gpu
def test_stream_design_on_the_card():
    """Past the cluster design's shared-memory budget (K=12: half of G^T
    alone is 211 KB) the factored kernel takes its stream design; it agrees
    with the reference order's plain version on the same device tensors in
    both entry modes, gives the same bits run to run, and the kernel with
    alpha 1.62 for 1.6 does not agree.  Needs an NVIDIA card and nvcc;
    skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    args, lay = _port_stage_inputs(12, 4)
    at = tuple(a.cuda() for a in args)
    nfd, m_p = at[4].shape[1:]
    assert (nfd, m_p) == (165, 640)
    assert tkernel.factored_design(nfd, m_p, 11, 15, lay.nb_p) == "stream"
    kw = dict(n_iters=N_ITERS, alpha=ALPHA, nb_p=lay.nb_p, n_ball=lay.n_ball)
    first = tkernel.admm_stage_fused_factored(*at, init_z=True, **kw)
    again = tkernel.admm_stage_fused_factored(*at, init_z=True, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    si = dict(torch=dict(gt=args[4]))
    carried = (first[1].contiguous(), (0.5 * first[3]).contiguous())
    for init_z, extra in ((True, ()), (False, carried)):
        plain = tkernel.admm_stage_fused_factored_plain(
            *at, *extra, init_z=init_z, **kw)
        ours = tkernel.admm_stage_fused_factored(*at, *extra, init_z=init_z,
                                                 **kw)
        for a, b, name in zip(ours, plain, NAMES):
            _assert_close(to_np(a), to_np(b), name, si, atol=2e-4)
        wrong = tkernel.admm_stage_fused_factored(
            *at, *extra, init_z=init_z, **dict(kw, alpha=1.62))
        with pytest.raises(AssertionError):
            for a, b, name in zip(wrong, plain, NAMES):
                _assert_close(to_np(a), to_np(b), name, si, atol=2e-4)


@pytest.mark.parametrize("k,fits,threads", [(4, True, 128), (10, True, 512),
                                            (11, False, None),
                                            (12, False, None)])
def test_cluster_layout_within_the_h100_budget(k, fits, threads):
    """Kernel 1's cluster layout (the mirror ``cluster_smem_bytes`` of the
    source's ``make_cluster_layout``: W^-1, G^T's share with the W^-1 sweeps'
    scratch over its tail, the lane vectors) holds a block's share within
    the 232,448 B an H100 block may take at K=4 and K=10 and not from K=11,
    where the launcher takes the stream design
    (``test_cluster_layout_on_the_card``); the block size the card takes
    there keeps an SM at 512 threads over the blocks its shared memory
    holds."""
    shapes = _cluster_shapes(k)
    got = tkernel.cluster_smem_bytes("admm_stage_fused_factored", *shapes)
    assert (got <= H100_SMEM_OPTIN) == fits
    if fits:
        assert threads * blocks_an_sm(got) <= 512
    if k == 10:
        assert got == 224288


def _cluster_shapes(k):
    """(nfd, m_p, m_blk, bsz, nb_p) of the K-segment headline structure."""
    layout = tqcqp._flagship_layout(
        mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N))
    return (15 * (k - 1), layout.m_p, k - 1, 15, layout.nb_p)


@pytest.mark.gpu
@pytest.mark.parametrize("k,fits,threads", [(4, True, 128), (10, True, 512),
                                            (11, False, None),
                                            (12, False, None)])
def test_cluster_layout_on_the_card(k, fits, threads):
    """Kernel 1's launcher, asked on the card, takes the cluster design
    exactly where its layout fits, at the block size stated, with the
    layout's bytes as ``cluster_smem_bytes`` computes them.  Needs an NVIDIA
    card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    shapes = _cluster_shapes(k)
    kind = "admm_stage_fused_factored"
    design = tkernel.stage_design(kind, *shapes)
    assert design == ("cluster" if fits else "stream")
    assert tkernel.smem_bytes(*shapes, kind=kind, design="cluster") == \
        tkernel.cluster_smem_bytes(kind, *shapes)
    if fits:
        assert tkernel.block_threads(*shapes, kind) == threads
