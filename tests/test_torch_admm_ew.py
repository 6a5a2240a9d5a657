"""The ``gt_assembly="kernel"`` route of ``solve_qcqp_batch``, where G^T is
kept as its rank-1 row factors e (B, n_free, m_p) and w (B, 3, m_p), and its
two kernels ``admm_stage_fused_factored_ew`` (#3) and
``gram_band_factors_ew`` (#4), against the JAX package on the same seeded
inputs (K=4, batch 8, float32; the Pallas kernels in interpret mode).  The
whole route against the JAX ew route in float32 and against the generic
float64 reference is a case of ``test_torch_admm_routes.py`` (its
``ROUTES``).

Tolerances, and why:

* the factors against the JAX assembly: 2e-5 of each factor's scale, as
  ``test_torch_qcqp_slice.py`` holds G^T (the control-point maps are formed
  in another float32 order); the port's own G^T is their expansion, bit for
  bit (one expression);
* the plain stage against the Pallas ew kernel on the same inputs: 5e-5 of
  each output's scale, and the plain band 1e-5, as
  ``test_torch_admm_routes.py`` holds kernels #1, #2, #5 (float32 sums in
  another order); the ew versions against the G^T versions on the expanded
  G^T: equal;
* the ew route against the port's "pallas_db" route: equal, every output;
* on the card, each kernel against its plain version: 2e-4 of scale for the
  stage (rsqrtf is not correctly rounded there; sums run in another order),
  1e-5 for the band, as the other kernels' card tests; against its G^T
  kernel on the expanded G^T: equal for the band (#4 and #5 run the same
  ring on the same slabs), the stage's 2e-4 for the stage;
* #3's cluster design keeps e and w on chip, forms each G^T entry from them
  rounded as ``expand_gt`` rounds it and sums x = xq + rho W^-1 (G^T v):
  ``admm_stage_fused_factored_ew_winv_plain`` is that order in plain
  PyTorch (kernel 1's cluster order on the expanded G^T, the same bits),
  held against the Pallas kernel and in float64 as
  ``test_torch_admm_routes.py`` holds #2's (the reference order in float64,
  no further than thrice the float32 runs of the reference order plus 1e-6
  of scale; 1e-9 of scale in float64), and the solve it gives in place of
  the stage to the JAX ew route at the KKT routes' cost-gap limits.
"""

import functools

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
from mav_tube_trajectory_generation_tpu_torch.solver import banded as tbanded
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import (BENCH_KW, H100_SMEM_OPTIN, N, blocks_an_sm,
                             problem, to_np, tt)

B = 8
K = 4
ALPHA = 1.6
N_ITERS = 30
SIGMA = 1e-8
STAGE_ARGS = ("rho", "sinv", "t", "tt", "e", "w", "b", "rb", "xq")
STAGE_NAMES = ("x", "z", "z_prev", "u", "prim", "dual", "y")
EW = dict(gt_assembly="kernel")


def _scale(ref):
    return max(1.0, float(np.abs(ref[np.isfinite(ref)]).max()))


def _structure(k=K):
    return mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)


def _layout_args(k):
    """(nfd, m_p, m_blk, nb_p) of the K-segment headline structure."""
    lay = tqcqp._flagship_layout(_structure(k))
    return 15 * (k - 1), lay.m_p, k - 1, lay.nb_p


def _args(p, k=K):
    ts = _structure(k)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    return ts, (ts, d_fixed, p["times"], p["waypoints"], p["radii"])


def _port_pre(p, cfg, k=K):
    """The port's pre-stage bundle of problem ``p`` on ``cfg``'s route."""
    ts = _structure(k)
    return tqcqp._pre(ts, mtt.extract_fixed_values(ts, tt(p["values"])),
                      tt(p["times"]), tt(p["waypoints"]), tt(p["radii"]), cfg,
                      None, tqcqp._flagship_layout(ts),
                      warmstart_positions=tt(p["values"])[:, 1:-1, 0, :])


@functools.lru_cache(maxsize=None)
def _ew_inputs(k=K):
    """The stage and band inputs of the ew route as the port assembles them
    (float32, at the headline's rho), as NumPy, with z/u carried from one
    JAX ew stage (u halved, as a rebalancing of rho would) for the
    later-stage case."""
    p = problem(k=k, batch=B, seed=0)
    ts = _structure(k)
    cfg = mtt.ADMMConfig(**BENCH_KW, **EW)
    layout = tqcqp._flagship_layout(ts)
    pre = _port_pre(p, cfg, k)
    kkt = tqcqp._kkt_setup(cfg, pre, tbanded.kkt_tridiag_block(ts))
    rho = torch.full((B, 1, 1), cfg.rho)
    sinv, t_st, tt_st, xq = tqcqp._stage_factors(
        kkt.band, rho, cfg.sigma, pre.q_flat, factors=kkt.factors)
    e, w = kkt.factors
    out = {n: to_np(a) for n, a in dict(
        rho=rho, sinv=sinv, t=t_st, tt=tt_st, e=e, w=w,
        b=pre.b_pad, rb=tqcqp._rb_pad(pre.rb, layout), xq=xq,
        x0=pre.x_flat0[:, :, None], pb_d=kkt.band[0],
        pb_u=kkt.band[1]).items()}
    kw = dict(n_iters=N_ITERS, alpha=ALPHA, nb_p=layout.nb_p,
              n_ball=layout.n_ball)
    x1, z1, _, u1 = jkernel.admm_stage_fused_factored_ew(
        *(jnp.asarray(out[n]) for n in STAGE_ARGS + ("x0",)), init_z=True,
        interpret=True, **kw)[:4]
    out.update(x1=np.asarray(x1), z1=np.asarray(z1),
               u1=np.asarray(0.5 * u1))
    for name, a in out.items():
        assert a.dtype == np.float32, name
    return out, kw, p, pre


def _random_band_inputs(nf=15, m_p=384, seed=7):
    """Band inputs with random factors: in the real assemblies every row of
    G^T touches one free vertex, so their super-diagonal Gram band is
    exactly zero; these hold ub to a band that is not."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    m_blk = nf * 3 // 15
    return dict(e=f(B, nf, m_p), w=f(B, 3, m_p), pb_d=f(B, m_blk, 15, 15),
                pb_u=f(B, m_blk - 1, 15, 15),
                rho=(0.01 + np.abs(f(B, 1, 1))).astype(np.float32))


def _band_inputs(source):
    return _ew_inputs()[0] if source == "real" else _random_band_inputs()


def _stage_call(init_z, k=K):
    inp, kw, _, _ = _ew_inputs(k)
    names = STAGE_ARGS + (("x0",) if init_z else ("x1", "z1", "u1"))
    return [inp[n] for n in names], dict(kw, init_z=init_z)


# ---------------------------------------------------------------------------
# The assembly of the factors.
# ---------------------------------------------------------------------------

def test_factors_match_jax_assembly():
    _, _, p, pre = _ew_inputs()
    assert pre.gt is None
    e, w = to_np(pre.e_t), to_np(pre.w_t)
    layout = tqcqp._flagship_layout(_structure())
    assert e.shape == (B, 15, layout.m_p) and w.shape == (B, 3, layout.m_p)
    free = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    d_fixed = jlinear.extract_fixed_values(free, jnp.asarray(p["values"]))
    fac = dict(f_sphere=1.0, f_tube=BENCH_KW["rho_tube_factor"],
               f_half=BENCH_KW["rho_half_factor"])
    ref = jax.vmap(lambda t, df, wp, r, ds: jqcqp._padded_constraint_system(
        free, t, df, wp, r, ds, jqcqp._flagship_layout(free), with_factors=True,
        **fac))(jnp.asarray(p["times"]), d_fixed, jnp.asarray(p["waypoints"]),
                jnp.asarray(p["radii"]), jnp.asarray(to_np(pre.d_scale)))
    assert ref[0] is None
    for ours, r, name in ((e, ref[5], "e"), (w, ref[6], "w")):
        r = np.asarray(r)
        assert r.dtype == np.float32 and ours.shape == r.shape, name
        np.testing.assert_allclose(ours, r, rtol=0, atol=2e-5 * _scale(r),
                                   err_msg=name)
    # pad lanes: w is exactly zero there in both packages, so is G^T
    pad = np.ones(layout.m_p, bool)
    pad[tqcqp._unpad_index(layout)] = False
    assert (w[..., pad] == 0).all() and (np.asarray(ref[6])[..., pad] == 0).all()
    # the port's G^T is the expansion of the factors, bit for bit
    pre_xla = _port_pre(p, mtt.ADMMConfig(**BENCH_KW))
    assert pre_xla.e_t is None and pre_xla.w_t is None
    np.testing.assert_array_equal(
        to_np(tkernel.expand_gt(pre.e_t, pre.w_t)), to_np(pre_xla.gt))
    # row order p-major: row p*3 + d of G^T is e[p] * w[d]
    np.testing.assert_array_equal(to_np(pre_xla.gt)[:, 3 * 7 + 2],
                                  e[:, 7] * w[:, 2])


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init_z", [True, False])
def test_stage_ew_plain_matches_pallas(init_z):
    args, kw = _stage_call(init_z)
    ref = jkernel.admm_stage_fused_factored_ew(
        *(jnp.asarray(a) for a in args), interpret=True, **kw)
    before = dict(tkernel.launches)
    ours = tkernel.admm_stage_fused_factored_ew(*(tt(a) for a in args), **kw)
    assert tkernel.launches == before     # CPU tensors: the plain version
    e_idx = STAGE_ARGS.index("e")
    gt = tkernel.expand_gt(tt(args[e_idx]), tt(args[e_idx + 1]))
    dual_scale = 2.0 * float(np.abs(to_np(gt)).sum(-1).max())
    for a, r, name in zip(ours, ref, STAGE_NAMES):
        r = np.asarray(r)
        assert to_np(a).shape == r.shape, name
        scale = max(_scale(r), dual_scale) if name == "dual" else _scale(r)
        np.testing.assert_allclose(to_np(a), r, rtol=0, atol=5e-5 * scale,
                                   err_msg=name)
    # the G^T stage on the expanded G^T: the same bits
    g_args = [tt(a) for a in args[:e_idx]] + [gt] + [
        tt(a) for a in args[e_idx + 2:]]
    same = tkernel.admm_stage_fused_factored(*g_args, **kw)
    for a, b, name in zip(ours, same, STAGE_NAMES):
        np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=name)


@pytest.mark.parametrize("source", ["real", "random"])
def test_gram_band_factors_ew_plain_matches_pallas(source):
    inp = _band_inputs(source)
    args = tuple(inp[n] for n in ("e", "w", "pb_d", "pb_u", "rho"))
    ref = jkernel.gram_band_factors_ew(*(jnp.asarray(a) for a in args),
                                       blk=15, sigma=SIGMA, interpret=True)
    ours = tkernel.gram_band_factors_ew(*(tt(a) for a in args), blk=15,
                                        sigma=SIGMA)
    for a, r, name in zip(ours, ref, ("db", "ub")):
        r = np.asarray(r)
        assert to_np(a).shape == r.shape, name
        np.testing.assert_allclose(to_np(a), r, rtol=0,
                                   atol=1e-5 * _scale(r), err_msg=name)
    if source == "random":
        assert np.abs(np.asarray(ref[1])).max() > 1.0
    same = tkernel.gram_band_factors(
        tkernel.expand_gt(tt(args[0]), tt(args[1])), *(tt(a) for a in args[2:]),
        blk=15, sigma=SIGMA)
    for a, b in zip(ours, same):
        np.testing.assert_array_equal(to_np(a), to_np(b))


# ---------------------------------------------------------------------------
# The route.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _solve(n_stages, **over):
    p = problem(k=K, batch=B, seed=5)
    _, args = _args(p)
    cfg = mtt.ADMMConfig(n_stages=n_stages, **{**BENCH_KW, "n_iters": 20,
                                               **over})
    before = dict(tkernel.launches)
    sol = mtt.solve_qcqp_batch(*args, config=cfg, device="cpu",
                               warmstart_values=p["values"])
    assert tkernel.launches == before      # host run: no kernel launch
    return sol


@pytest.mark.parametrize("band_gram", ["xla", "pallas"])
def test_ew_route_equals_pallas_db_route(band_gram):
    """``band_gram`` is not read under ``gt_assembly="kernel"``; the route
    gives the bits of the "pallas_db" route, whose kernels see the G^T the
    factors expand to."""
    ours = _solve(2, band_gram=band_gram, **EW)
    ref = _solve(2, band_gram="pallas_db")
    for name in mtt.QCQPSolution._fields[:-1]:
        np.testing.assert_array_equal(to_np(getattr(ours, name)),
                                      to_np(getattr(ref, name)),
                                      err_msg=name)
    assert np.isfinite(to_np(ours.cost)).all()
    assert (to_np(ours.max_violation) < 1e-2).all()


# ---------------------------------------------------------------------------
# Every refusal of the JAX package, raised before any work.
# ---------------------------------------------------------------------------

REFUSALS = ("bad_value", "with_inverse", "with_cholesky", "k2", "return_pre",
            "polished", "router_snap")


@pytest.mark.parametrize("case", REFUSALS)
def test_ew_refusals(case, monkeypatch):
    if case in ("bad_value", "with_inverse", "with_cholesky"):
        over = {"bad_value": dict(gt_assembly="kernal"),
                "with_inverse": dict(EW, kkt_apply="inverse"),
                "with_cholesky": dict(EW, kkt_inverse="cholesky")}[case]
        with pytest.raises(ValueError, match="gt_assembly"):
            mtt.ADMMConfig(**over)
        with pytest.raises(ValueError, match="gt_assembly"):
            jqcqp.ADMMConfig(use_pallas=True, **over)
        return
    k = 2 if case == "k2" else K
    p = problem(k=k, batch=2, seed=0)
    _, args = _args(p, k)
    cfg = mtt.ADMMConfig(n_stages=1, n_iters=5, **EW)

    def no_work(*a, **kw):
        raise AssertionError("assembly started before the refusal")

    monkeypatch.setattr(tqcqp, "_pre", no_work)
    if case in ("k2", "return_pre"):
        match = "banded factored" if case == "k2" else "_return_pre"
        with pytest.raises(ValueError, match=match):
            mtt.solve_qcqp_batch(*args, config=cfg, device="cpu",
                                 warmstart_values=p["values"],
                                 _return_pre=case == "return_pre")
        free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
        vals = jnp.asarray(p["values"])
        with pytest.raises(ValueError, match=match):
            jqcqp.solve_qcqp_batch(
                free, jlinear.extract_fixed_values(free, vals),
                *(jnp.asarray(p[n]) for n in ("times", "waypoints", "radii")),
                config=jqcqp.ADMMConfig(use_pallas=True, n_stages=1,
                                        n_iters=5, **EW),
                warmstart_values=vals, _return_pre=case == "return_pre")
        return
    # the polish, and the router's tier 0 with snap sweeps (the strict
    # router's), start from the assembled G^T (``_return_pre``)
    with pytest.raises(ValueError, match="_return_pre"):
        if case == "polished":
            mtt.solve_qcqp_polished_batch(*args, admm_config=cfg,
                                          warmstart_values=p["values"],
                                          device="cpu")
        else:
            mtt.solve_qcqp_auto(*args, admm_config=cfg, tier0_snap=2,
                                warmstart_values=p["values"], device="cpu")


def test_router_tier0_takes_the_ew_route():
    """Without snap sweeps the router's tier 0 is ``solve_qcqp_batch``, which
    takes the ew route: the verdicts and solution of the "pallas_db"
    route, as in the JAX package."""
    p = problem(k=K, batch=4, seed=3)
    _, args = _args(p)
    res = {}
    for name, over in (("ew", EW), ("db", dict(band_gram="pallas_db"))):
        cfg = mtt.ADMMConfig(**{**BENCH_KW, "n_stages": 1, **over})
        res[name] = mtt.solve_qcqp_auto(*args, admm_config=cfg,
                                        warmstart_values=p["values"],
                                        device="cpu")
    np.testing.assert_array_equal(res["ew"].verdict, res["db"].verdict)
    assert (res["ew"].verdict != mtt.UNDETERMINED).all()
    for name in ("cost", "d_free", "max_violation"):
        np.testing.assert_array_equal(to_np(getattr(res["ew"].solution, name)),
                                      to_np(getattr(res["db"].solution, name)))


def test_wrappers_take_cpu_and_cuda_tensors_only():
    inp = _random_band_inputs()
    meta = {n: torch.empty(a.shape, device="meta") for n, a in inp.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.gram_band_factors_ew(meta["e"], meta["w"], meta["pb_d"],
                                     meta["pb_u"], meta["rho"], blk=15,
                                     sigma=SIGMA)
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.admm_stage_fused_factored_ew(
            *(torch.empty(1, 1, 1, device="meta"),) * 10, n_iters=1,
            alpha=ALPHA, nb_p=1)
    with pytest.raises(ValueError, match="init_z=False needs"):
        tkernel.admm_stage_fused_factored_ew(
            *(torch.zeros(1, 1, 1),) * 10, n_iters=1, alpha=ALPHA, nb_p=1,
            init_z=False)


# ---------------------------------------------------------------------------
# #3's cluster design: its order, its shared memory, its choice.
# ---------------------------------------------------------------------------

F64_RTOL = 1e-9
COST_GAP_MEDIAN = 1e-3
COST_GAP_P99 = 1e-2


@pytest.mark.parametrize("k", [4, 10])
def test_ew_winv_order_f32_against_pallas(k):
    """Per output, no further from the reference order run in float64 than
    float32 runs of the reference order are (the Pallas ew kernel's and the
    port's plain version's, the larger) thrice over, plus 1e-6 of the
    output's scale."""
    args, kw = _stage_call(True, k)
    ref = jkernel.admm_stage_fused_factored_ew(
        *(jnp.asarray(a) for a in args), interpret=True, **kw)
    ours = tkernel.admm_stage_fused_factored_ew_winv_plain(
        *(tt(a) for a in args), **kw)
    ref32 = tkernel.admm_stage_fused_factored_ew_plain(
        *(tt(a) for a in args), **kw)
    ref64 = tkernel.admm_stage_fused_factored_ew_plain(
        *(tt(a, torch.float64) for a in args), **kw)
    for a, r, p, c, name in zip(ours, ref, ref32, ref64, STAGE_NAMES):
        assert a.dtype == torch.float32 and a.shape == r.shape
        c = to_np(c)
        scale = _scale(c)
        err = np.abs(to_np(a).astype(np.float64) - c).max()
        floor = max(np.abs(np.asarray(r, np.float64) - c).max(),
                    np.abs(to_np(p).astype(np.float64) - c).max())
        assert err <= 3.0 * floor + 1e-6 * scale, (name, err, floor)


@pytest.mark.parametrize("k", [4, 10])
def test_ew_winv_order_f64_matches_reference_order(k):
    """In float64 only rounding parts the two orders; in float32 the twin
    is kernel 1's cluster order on the expanded G^T, bit for bit."""
    for init_z in (True, False):
        args, kw = _stage_call(init_z, k)
        args = [tt(a, torch.float64) for a in args]
        ours = tkernel.admm_stage_fused_factored_ew_winv_plain(*args, **kw)
        ref = tkernel.admm_stage_fused_factored_ew_plain(*args, **kw)
        for a, r, name in zip(ours, ref, STAGE_NAMES):
            assert a.dtype == torch.float64
            r = to_np(r)
            np.testing.assert_allclose(to_np(a), r, rtol=0,
                                       atol=F64_RTOL * _scale(r),
                                       err_msg=name)
    args, kw = _stage_call(False, k)
    args = [tt(a) for a in args]
    ours = tkernel.admm_stage_fused_factored_ew_winv_plain(*args, **kw)
    ref = tkernel.admm_stage_fused_factored_winv_plain(
        *args[:4], tkernel.expand_gt(args[4], args[5]), *args[6:], **kw)
    for a, r, name in zip(ours, ref, STAGE_NAMES):
        np.testing.assert_array_equal(to_np(a), to_np(r), err_msg=name)


def test_ew_winv_order_cost_gap_against_jax(monkeypatch):
    """The whole solve on the ew route with the stage in its cluster
    design's order (its plain version in place of the wrapper) against the
    JAX package's ew route with its Pallas kernels in interpret mode, on the
    same scenarios, at the benchmark's 48 iterations and one stage."""
    p = problem(k=K, batch=B, seed=0)
    jfree = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    vals = jnp.asarray(p["values"])
    names = ("admm_stage_fused_factored_ew", "gram_band_factors_ew")
    for n in names:
        monkeypatch.setattr(jkernel, n, functools.partial(
            getattr(jkernel, n), interpret=True))
    ref = jqcqp.solve_qcqp_batch(
        jfree, jlinear.extract_fixed_values(jfree, vals),
        jnp.asarray(p["times"]), jnp.asarray(p["waypoints"]),
        jnp.asarray(p["radii"]), config=jqcqp.ADMMConfig(
            use_pallas=True, n_stages=1, **BENCH_KW, **EW),
        warmstart_values=vals, scenario_block=4)
    calls = []

    def twin(*a, **kw):
        calls.append(1)
        return tkernel.admm_stage_fused_factored_ew_winv_plain(*a, **kw)
    monkeypatch.setattr(tkernel, "admm_stage_fused_factored_ew", twin)
    _, args = _args(p)
    ours = mtt.solve_qcqp_batch(
        *args, config=mtt.ADMMConfig(n_stages=1, **BENCH_KW, **EW),
        device="cpu", warmstart_values=p["values"])
    assert calls == [1]
    c_ours = to_np(ours.cost).astype(np.float64)
    c_ref = np.asarray(ref.cost, np.float64)
    gap = np.abs(c_ours - c_ref) / np.abs(c_ref)
    assert np.isfinite(gap).all()
    assert np.median(gap) <= COST_GAP_MEDIAN, gap
    assert np.quantile(gap, 0.99) <= COST_GAP_P99, gap


@pytest.mark.parametrize("k,fits,threads", [
    (4, True, 64), (6, True, 128), (10, True, 512), (12, True, 512),
    (13, True, 512), (14, False, None)])
def test_ew_cluster_layout_within_the_h100_budget(k, fits, threads):
    """A block of #3's cluster design holds W^-1 and its lanes' share of e
    (nfd / 3 rows) and w (3 rows) -- a third of G^T's share -- within the
    232,448 B an H100 block may take up to K=13 (kernel 1's and #2's
    layouts only to K=10) and not at K=14 (its launcher's choice on the
    card: ``test_ew_cluster_layout_on_the_card``); the block size the card
    takes keeps an SM at 512 threads over the blocks its shared memory
    holds, or is the fewest, 64."""
    nfd, m_p, m_blk, nb_p = _layout_args(k)
    kind = "admm_stage_fused_factored_ew"
    got = tkernel.cluster_smem_bytes(kind, nfd, m_p, m_blk, 15, nb_p)
    assert (got <= H100_SMEM_OPTIN) == fits
    assert got < tkernel.cluster_smem_bytes("admm_stage_fused_factored", nfd,
                                            m_p, m_blk, 15, nb_p)
    if fits:
        assert threads * blocks_an_sm(got) <= 512 or threads == 64
    if k == 10:
        assert got == 133808


@pytest.mark.gpu
@pytest.mark.parametrize("k,fits,threads", [
    (4, True, 64), (6, True, 128), (10, True, 512), (12, True, 512),
    (13, True, 512), (14, False, None)])
def test_ew_cluster_layout_on_the_card(k, fits, threads):
    """#3's launcher, asked on the card, takes the cluster design exactly
    where its layout fits, at the block size stated, with the layout's
    bytes as ``cluster_smem_bytes`` computes them.  Needs an NVIDIA card and
    nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    nfd, m_p, m_blk, nb_p = _layout_args(k)
    kind = "admm_stage_fused_factored_ew"
    assert tkernel.ew_design(nfd, m_p, m_blk, 15, nb_p) == \
        ("cluster" if fits else "stream")
    assert tkernel.smem_bytes(nfd, m_p, m_blk, 15, nb_p, kind,
                              design="cluster") == \
        tkernel.cluster_smem_bytes(kind, nfd, m_p, m_blk, 15, nb_p)
    if fits:
        assert tkernel.block_threads(nfd, m_p, m_blk, 15, nb_p, kind) == \
            threads


# ---------------------------------------------------------------------------
# #4's design: the ring at the solver's band block, fed from e and w.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,smem,per_sm", [
    (2, 87008, 2), (4, 87008, 2), (10, 113120, 2), (12, 139232, 1)])
def test_ew_band_design_by_shape(k, smem, per_sm):
    """#4 takes the ring at every assembly's band block (15 rows: five rows
    of e, three dimensions), with #5's launch parameters and, beside #5's
    slabs and partials, w's rows for two scenarios and one more mbarrier
    (e's staged rows), within the 232,448 B an H100 block may take; two
    blocks an SM to K=10."""
    nfd, m_p, m_blk, _ = _layout_args(k)
    d = tkernel.band_design(nfd, m_p, 15, "factors")
    stored = tkernel.band_design(nfd, m_p, 15)
    assert d.design == stored.design == "ring" and d.source == "factors"
    assert d[:5] == stored[:5]          # threads, slots, per block, tile
    assert d.smem_bytes == smem == tkernel.ring_smem_bytes(
        m_p, d.threads, d.slots, "factors")
    assert d.smem_bytes == stored.smem_bytes + 4 * 2 * 3 * m_p + 8
    assert d.smem_bytes <= H100_SMEM_OPTIN
    assert blocks_an_sm(d.smem_bytes) == per_sm
    assert 15 % tkernel.DIMS == 0 and nfd == 15 * m_blk


@pytest.mark.parametrize("blk", [3, 9, 45])
def test_ew_band_design_window_elsewhere(blk):
    """Band blocks other than 15 keep the window body for #4, the entries
    formed from e and w as the slabs load."""
    d = tkernel.band_design(135, 512, blk, "factors")
    assert d.design == "window" and d.source == "factors"
    assert d.smem_bytes == tkernel.window_smem_bytes(512, blk)
    with pytest.raises(ValueError, match="source"):
        tkernel.band_design(135, 512, 15, "expanded")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version.
# ---------------------------------------------------------------------------

def _card_case(name):
    """(kernel, plain version, G^T kernel, args on the card, kwargs,
    relative bar, index of e in args)."""
    dev = torch.device("cuda")
    if name.startswith("band"):
        inp = _band_inputs(name.split("_")[1])
        args = tuple(tt(inp[n]).to(dev) for n in ("e", "w", "pb_d", "pb_u",
                                                   "rho"))
        return (tkernel.gram_band_factors_ew,
                tkernel.gram_band_factors_ew_plain,
                tkernel.gram_band_factors, args, dict(blk=15, sigma=SIGMA),
                1e-5, 0)
    args, kw = _stage_call(name == "stage")
    # K=4 takes the cluster design: held to the plain version in its order
    assert tkernel.ew_design(*_layout_args(K)[:3], 15,
                             _layout_args(K)[3]) == "cluster"
    return (tkernel.admm_stage_fused_factored_ew,
            tkernel.admm_stage_fused_factored_ew_winv_plain,
            tkernel.admm_stage_fused_factored,
            tuple(tt(a).contiguous().to(dev) for a in args), kw, 2e-4,
            STAGE_ARGS.index("e"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stage", "stage_carried", "band_real",
                                  "band_random"])
def test_ew_kernels_on_the_card_match_plain(name, monkeypatch):
    """Needs an NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    fn, fn_plain, fn_gt, args, kw, rel, i = _card_case(name)
    key = fn.__name__
    before = tkernel.launches[key]
    ours = fn(*args, **kw)
    torch.cuda.synchronize()
    assert tkernel.launches[key] == before + 1
    plain = fn_plain(*args, **kw)
    for a, b in zip(ours, plain):
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0, atol=rel * _scale(b))
    gt_args = args[:i] + (tkernel.expand_gt(args[i], args[i + 1]),) + \
        args[i + 2:]
    # against the kernel of the stored G^T: #3's cluster design forms the
    # same G^T entries but sums them in other groups than kernel 1's, so it
    # is held to the bar it is held to against its plain version; #4 and #5
    # run the same design (the ring at blk 15, the window body elsewhere)
    # on the same slab entries: the same bits
    for a, b in zip(ours, fn_gt(*gt_args, **kw)):
        if name.startswith("band"):
            assert torch.equal(a, b)
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0, atol=rel * _scale(b))
    if name.startswith("band"):
        # the window body too, both kernels in it
        window = lambda nfd, m_p, blk, source="stored": \
            tkernel.window_design(m_p, blk)._replace(source=source)
        monkeypatch.setattr(tkernel, "band_design", window)
        for a, b in zip(fn(*args, **kw), fn_gt(*gt_args, **kw)):
            assert torch.equal(a, b)
        monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        fn(*(a.double() for a in args), **kw)
    strided = list(args)
    strided[i] = args[i].mT.contiguous().mT
    with pytest.raises(ValueError, match="contiguous"):
        fn(*strided, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 10, 14])
def test_ew_designs_on_the_card(k):
    """#3 takes the design its shapes name (K=4 and K=10 cluster, in blocks
    of 64 and 512 threads; K=14 stream), agrees with the plain version in
    that design's order at 2e-4 of each output's scale in both entry modes,
    gives the same bits run to run, and with alpha 1.62 for 1.6 does not
    agree.  Needs an NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    nfd, m_p, m_blk, nb_p = _layout_args(k)
    design = tkernel.ew_design(nfd, m_p, m_blk, 15, nb_p)
    assert design == ("stream" if k == 14 else "cluster")
    if design == "cluster":
        assert tkernel.block_threads(nfd, m_p, m_blk, 15, nb_p,
                                     "admm_stage_fused_factored_ew") == \
            {4: 64, 10: 512}[k]
    plain = (tkernel.admm_stage_fused_factored_ew_winv_plain
             if design == "cluster"
             else tkernel.admm_stage_fused_factored_ew_plain)
    for init_z in (True, False):
        args, kw = _stage_call(init_z, k)
        args = [tt(a).contiguous().cuda() for a in args]
        first = tkernel.admm_stage_fused_factored_ew(*args, **kw)
        again = tkernel.admm_stage_fused_factored_ew(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        ref = [to_np(r) for r in plain(*args, **kw)]
        # the dual, max|G^T (z - z_prev)|, scaled as
        # test_stage_ew_plain_matches_pallas scales it: a row sum of |G^T|
        # for each of z and z_prev
        gt = to_np(tkernel.expand_gt(args[4], args[5]))
        scales = [_scale(r) for r in ref]
        scales[5] = max(scales[5], 2.0 * float(np.abs(gt).sum(-1).max()))
        for a, r, sc in zip(first, ref, scales):
            np.testing.assert_allclose(to_np(a), r, rtol=0, atol=2e-4 * sc)
        wrong = tkernel.admm_stage_fused_factored_ew(
            *args, **dict(kw, alpha=1.62))
        assert any(np.abs(to_np(a) - r).max() > 2e-4 * sc
                   for a, r, sc in zip(wrong, ref, scales))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 10, 12])
def test_ew_band_ring_on_the_card(k):
    """#4 takes the ring at each assembly's widths on random factors (K=2:
    one block, no ub), agrees with its plain version at 1e-5 of scale,
    gives the same bits run to run and exactly #5's bits on the expanded
    G^T, and with w's rows permuted does not agree.  Needs an NVIDIA card
    and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    nfd, m_p, _, _ = _layout_args(k)
    assert tkernel.band_design(nfd, m_p, 15, "factors").design == "ring"
    inp = _random_band_inputs(nf=nfd // 3, m_p=m_p, seed=k)
    args = [tt(inp[n]).cuda() for n in ("e", "w", "pb_d", "pb_u", "rho")]
    kw = dict(blk=15, sigma=SIGMA)
    before = tkernel.launches["gram_band_factors_ew"]
    ours = tkernel.gram_band_factors_ew(*args, **kw)
    again = tkernel.gram_band_factors_ew(*args, **kw)
    torch.cuda.synchronize()
    assert tkernel.launches["gram_band_factors_ew"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(ours, again))
    gt = tkernel.expand_gt(args[0], args[1])
    five = tkernel.gram_band_factors(gt, *args[2:], **kw)
    assert all(torch.equal(a, b) for a, b in zip(ours, five))
    # K=2 has one band block: ub is empty
    ref = [to_np(r) for r in tkernel.gram_band_factors_ew_plain(*args, **kw)
           if r.numel()]
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(to_np(a), r, rtol=0, atol=1e-5 * _scale(r))
    wrong = tkernel.gram_band_factors_ew(
        args[0], args[1][:, [1, 2, 0]].contiguous(), *args[2:], **kw)
    assert any(np.abs(to_np(a) - r).max() > 1e-5 * _scale(r)
               for a, r in zip(wrong, ref))
