"""The KKT routes of ``solve_qcqp_batch`` beside the default banded factored
one: the dense-inverse stage (``admm_stage_fused``), the stage from a given
m1 (``admm_stage``), the Gram-band kernels (``gram_band``,
``gram_band_factors``), the dense inverse from the band
(``banded.spd_block_tridiag_inverse_blocks``) and the route selectors of
``ADMMConfig``, against the JAX package on the same seeded inputs (K=2 and
K=4, batch 8, float32 unless stated; the Pallas kernels in interpret mode).

Tolerances, and why:

* plain stage kernels against the Pallas kernels on the same JAX-assembled
  inputs: 5e-5 of each output's scale, max(1, max|reference|), as
  ``test_torch_admm_stage.py`` (float32 sums in another order; the dual
  residual sees the differences of z and z_prev through a row of |G^T|);
* plain band kernels: 1e-5 of scale (one sum of 384-512 products per entry);
* whole solves in float32 against the JAX ``solve_qcqp_batch(use_pallas=
  True)``: ``test_torch_qcqp_slice.py``'s bars on every route, and the
  port's float32 run within the same bars of its own float64 run.  A bar
  per element of d_free (rtol 5e-3, atol 5e-5, ``tests/test_qcqp.py``'s for
  one K=4 scenario) does not hold on a batch of eight at the headline's
  rho: there the JAX package's own float32 solve on its factored route and
  on its inverse route part by up to 65x that bar, in the small entries of
  d_free, and each float32 run is 2e-3 absolute from the float64 one;
* whole solves in float64 through the plain versions against the reference
  layout path (``solve_qcqp``, ``use_pallas=False``): 1e-6 of each output's
  scale, only rounding differs;
* the dense inverse from the band in float64: 1e-10 relative;
* #2's cluster design sums x = xq + rho W^-1 (G^T v) in place of xq + rho
  (W^-1 G^T) v; ``admm_stage_fused_winv_plain`` is that order in plain
  PyTorch, held, as ``test_torch_admm_stage.py`` holds kernel 1's, to the
  reference order run in float64 no further than thrice the float32 runs of
  the reference order (the Pallas kernel's and the port's, the larger) plus
  1e-6 of scale; in float64 to the reference order at 1e-9 of scale (only
  rounding parts the two orders); the solve it gives in place of the stage
  to the JAX solve at the KKT routes' cost-gap limits (median 1e-3, 99th
  percentile 1e-2 relative).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import admm_kernel as jkernel
from mav_tube_trajectory_generation_tpu.ops import linalg as jlinalg
from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as tkernel
from mav_tube_trajectory_generation_tpu_torch.solver import banded as tbanded
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp as tqcqp

from torch_port_util import (BENCH_KW, H100_SMEM_OPTIN, N, blocks_an_sm,
                             jax_pre, problem, to_np, tt)

B = 8
ALPHA = 1.6
N_ITERS = 30
SIGMA = 1e-8
STAGE_NAMES = ("x", "z", "z_prev", "u", "prim", "dual", "y")
FIELDS = ("d_free", "coefficients", "cost", "max_violation",
          "primal_residual", "dual_residual", "dual_ball", "dual_half")
# (route id, K, ADMMConfig fields): every KKT route of solve_qcqp_batch
# other than the default banded factored one with the "xla" band.
ROUTES = (("k2_default", 2, {}),
          ("k4_inverse", 4, dict(kkt_apply="inverse")),
          ("k4_cholesky", 4, dict(kkt_inverse="cholesky")),
          ("k4_pallas", 4, dict(band_gram="pallas")),
          ("k4_pallas_block", 4, dict(band_gram="pallas_block")),
          ("k4_pallas_db", 4, dict(band_gram="pallas_db")),
          ("ew", 4, dict(gt_assembly="kernel")))


def _scale(ref):
    finite = ref[np.isfinite(ref)]
    return max(1.0, float(np.abs(finite).max())) if finite.size else 1.0


def _assert_stage_close(ours, ref, gt, names=STAGE_NAMES, rel=5e-5):
    for a, b, name in zip(ours, ref, names):
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = _scale(b)
        if name == "dual":
            scale = max(scale, 2.0 * float(np.abs(gt).sum(-1).max()))
        np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Kernel inputs from a real assembly.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stage_inputs(k):
    """JAX-assembled stage inputs at the headline's rho for K segments, as
    NumPy: the dense KKT inverse of the route the structure takes (K=2: the
    dense KKT through the JAX ``spd_inverse``; K=4: the band through the JAX
    ``spd_block_tridiag_inverse_blocks``), xq = -W^-1 q, the objective band
    (K=4), and z/u carried from one JAX stage for the later-stage cases."""
    kw = {n: v for n, v in BENCH_KW.items() if n != "n_iters"}
    free, pre_np, _ = jax_pre(k=k, batch=B, seed=0, **kw)
    ts = mtt.structure_from_fields(free)
    layout = tqcqp._flagship_layout(ts)
    pre = mtt.pre_from_numpy(pre_np, device="cpu")
    rho = np.full((B, 1, 1), kw["rho"], np.float32)
    gt = jnp.asarray(pre_np["gt"])
    blk = tbanded.kkt_tridiag_block(ts)
    out = dict(layout=layout, rho=rho, gt=pre_np["gt"], blk=blk)
    if blk is None:
        eye3 = jnp.eye(3, dtype=jnp.float32)
        p_big = jax.vmap(lambda pe: jnp.kron(pe, eye3))(
            jnp.asarray(pre_np["p_eq"]))
        kkt = (p_big + jnp.asarray(rho) * (gt @ jnp.swapaxes(gt, 1, 2))
               + SIGMA * jnp.eye(gt.shape[1], dtype=jnp.float32))
        winv = jax.vmap(jlinalg.spd_inverse)(kkt)
    else:
        pb_d, pb_u, gd, gu = (jnp.asarray(to_np(a)) for a in
                              tqcqp._kkt_band(pre.gt, pre.p_eq, blk))
        rho_b = jnp.asarray(rho)[:, None]
        db = pb_d + rho_b * gd + SIGMA * jnp.eye(blk, dtype=jnp.float32)
        ub = pb_u + rho_b * gu
        winv = jbanded.spd_block_tridiag_inverse_blocks(db, ub)
        out.update(pb_d=np.asarray(pb_d), pb_u=np.asarray(pb_u))
    xq = -(winv @ jnp.asarray(pre_np["q_flat"])[:, :, None])
    out.update(winv=np.asarray(winv), xq=np.asarray(xq),
               b=pre_np["b_pad"],
               rb=to_np(tqcqp._rb_pad(pre.rb, layout)),
               x0=pre_np["x_flat0"][:, :, None])
    x1, z1, _, u1 = jkernel.admm_stage_fused(
        *(jnp.asarray(out[n]) for n in ("rho", "winv", "gt", "b", "rb",
                                        "xq", "x0")),
        n_iters=N_ITERS, alpha=ALPHA, nb_p=layout.nb_p,
        n_ball=layout.n_ball, init_z=True, interpret=True)[:4]
    out.update(x1=np.asarray(x1), z1=np.asarray(z1),
               u1=np.asarray(0.5 * u1))
    for name, a in out.items():
        if isinstance(a, np.ndarray):
            assert a.dtype == np.float32, name
    return out


def _random_band_inputs(m_blk=3, blk=15, m_p=384, seed=7):
    """Band-kernel inputs with random entries: in the real assemblies every
    constraint row of G^T touches one free vertex, so their super-diagonal
    Gram band is exactly zero; these hold gu / ub to a band that is not."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(gt=f(B, m_blk * blk, m_p), pb_d=f(B, m_blk, blk, blk),
                pb_u=f(B, m_blk - 1, blk, blk),
                rho=(0.01 + np.abs(f(B, 1, 1))).astype(np.float32), blk=blk)


def _band_inputs(source):
    return _stage_inputs(4) if source == "real" else _random_band_inputs()


def _stage_kw(inp):
    lay = inp["layout"]
    return dict(n_iters=N_ITERS, alpha=ALPHA, nb_p=lay.nb_p,
                n_ball=lay.n_ball)


# ---------------------------------------------------------------------------
# (i) plain kernels against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,init_z", [(2, True), (2, False), (4, True),
                                      (4, False)])
def test_stage_fused_plain_matches_pallas(k, init_z):
    inp = _stage_inputs(k)
    names = ("rho", "winv", "gt", "b", "rb", "xq")
    carried = (("x0",) if init_z else ("x1", "z1", "u1"))
    kw = dict(_stage_kw(inp), init_z=init_z)
    ref = jkernel.admm_stage_fused(
        *(jnp.asarray(inp[n]) for n in names + carried), interpret=True,
        **kw)
    before = dict(tkernel.launches)
    ours = tkernel.admm_stage_fused(*(tt(inp[n]) for n in names + carried),
                                    **kw)
    assert tkernel.launches == before     # CPU tensors: the plain version
    if k == 2:
        # no final half-space plane: m_p == 3 nb_p
        assert inp["layout"].nh_p == 0 and inp["gt"].shape[-1] == 384
    _assert_stage_close(ours, ref, inp["gt"])


@pytest.mark.parametrize("k", [2, 4])
def test_stage_plain_matches_pallas(k):
    inp = _stage_inputs(k)
    m1 = np.asarray(jnp.asarray(inp["winv"]) @ jnp.asarray(inp["gt"]))
    args = (inp["rho"], m1, inp["gt"], inp["b"], inp["rb"], inp["xq"],
            inp["z1"], inp["u1"])
    kw = _stage_kw(inp)
    ref = jkernel.admm_stage(*(jnp.asarray(a) for a in args),
                             interpret=True, **kw)
    ours = tkernel.admm_stage(*(tt(a) for a in args), **kw)
    assert len(ours) == 5
    _assert_stage_close(ours, ref, inp["gt"], STAGE_NAMES[:5])


def test_stage_with_no_iterations_returns_its_start():
    """Kernel #7's semantics: x starts at xq, z and z_prev at z0, u at u0,
    prim at +inf; ``n_iters=0`` returns exactly (xq, z0, z0, u0, inf), as
    the Pallas kernel does."""
    inp = _stage_inputs(2)
    m1 = np.asarray(jnp.asarray(inp["winv"]) @ jnp.asarray(inp["gt"]))
    args = (inp["rho"], m1, inp["gt"], inp["b"], inp["rb"], inp["xq"],
            inp["z1"], inp["u1"])
    kw = dict(_stage_kw(inp), n_iters=0)
    ref = jkernel.admm_stage(*(jnp.asarray(a) for a in args),
                             interpret=True, **kw)
    ours = tkernel.admm_stage(*(tt(a) for a in args), **kw)
    want = (inp["xq"], inp["z1"], inp["z1"], inp["u1"],
            np.full((B, 1, 1), np.inf, np.float32))
    for a, r, w in zip(ours, ref, want):
        np.testing.assert_array_equal(to_np(a), w)
        np.testing.assert_array_equal(np.asarray(r), w)


@pytest.mark.parametrize("source", ["real", "random"])
@pytest.mark.parametrize("per_block", [False, True])
def test_gram_band_plain_matches_pallas(source, per_block):
    inp = _band_inputs(source)
    blk = inp["blk"]
    ref = jkernel.gram_band(jnp.asarray(inp["gt"]), blk=blk,
                            per_block=per_block, interpret=True)
    ours = tkernel.gram_band(tt(inp["gt"]), blk=blk, per_block=per_block)
    for a, r, name in zip(ours, ref, ("gd", "gu")):
        r = np.asarray(r)
        assert to_np(a).shape == r.shape, name
        np.testing.assert_allclose(to_np(a), r, rtol=0,
                                   atol=1e-5 * _scale(r), err_msg=name)
    if source == "random":
        assert np.abs(np.asarray(ref[1])).max() > 1.0
    # both JAX code paths give one band, and the port's one function it
    other = jkernel.gram_band(jnp.asarray(inp["gt"]), blk=blk,
                              per_block=not per_block, interpret=True)
    for a, r in zip(ours, other):
        np.testing.assert_allclose(to_np(a), np.asarray(r), rtol=0,
                                   atol=1e-5 * _scale(np.asarray(r)))


@pytest.mark.parametrize("source", ["real", "random"])
def test_gram_band_factors_plain_matches_pallas(source):
    inp = _band_inputs(source)
    blk = inp["blk"]
    args = (inp["gt"], inp["pb_d"], inp["pb_u"], inp["rho"])
    ref = jkernel.gram_band_factors(*(jnp.asarray(a) for a in args),
                                    blk=blk, sigma=SIGMA, interpret=True)
    ours = tkernel.gram_band_factors(*(tt(a) for a in args), blk=blk,
                                     sigma=SIGMA)
    for a, r, name in zip(ours, ref, ("db", "ub")):
        r = np.asarray(r)
        np.testing.assert_allclose(to_np(a), r, rtol=0,
                                   atol=1e-5 * _scale(r), err_msg=name)


def test_band_kernels_give_the_kkt_band_of_the_solver():
    """``_kkt_band`` / ``_kkt_band_at`` on the band routes give the "xla"
    route's KKT band (float64, so only rounding differs)."""
    free, pre_np, _ = jax_pre(k=4, batch=4, seed=1, n_iters=2)
    pre = mtt.pre_from_numpy(pre_np, device="cpu", dtype=torch.float64)
    rho = torch.full((4, 1, 1), 0.02, dtype=torch.float64)
    ref = tqcqp._kkt_band_at(tqcqp._kkt_band(pre.gt, pre.p_eq, 15), rho,
                             1e-6)
    for mode in ("pallas", "pallas_block", "pallas_db"):
        band = tqcqp._kkt_band(pre.gt, pre.p_eq, 15, mode)
        assert (band[2] is None) == (mode == "pallas_db")
        got = tqcqp._kkt_band_at(band, rho, 1e-6, pre.gt)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(to_np(a), to_np(r), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("chunk", [3, 4])
def test_xla_band_in_scenario_chunks(monkeypatch, chunk):
    """The "xla" band formed ``_GRAM_SCENARIOS`` scenarios at a time (here
    3 or 4 of 8, so a chunk boundary is crossed, and unevenly with 3) is the
    band of the whole batch's dense Gram bit for bit, and the JAX package's
    dense Gram band at float32 order noise."""
    free, pre_np, _ = jax_pre(k=4, batch=8, seed=2, n_iters=2)
    pre = mtt.pre_from_numpy(pre_np, device="cpu")
    blk, m_blk = 15, pre.gt.shape[1] // 15
    assert tqcqp._GRAM_SCENARIOS >= 8
    whole = tqcqp._kkt_band(pre.gt, pre.p_eq, blk)
    monkeypatch.setattr(tqcqp, "_GRAM_SCENARIOS", chunk)
    parts = tqcqp._kkt_band(pre.gt, pre.p_eq, blk)
    for a, b in zip(parts, whole):
        assert torch.equal(a, b)
    gtg = pre.gt @ pre.gt.transpose(-1, -2)
    g5 = gtg.reshape(8, m_blk, blk, m_blk, blk)
    assert torch.equal(parts[2], torch.stack(
        [g5[:, i, :, i, :] for i in range(m_blk)], dim=1))
    assert torch.equal(parts[3], torch.stack(
        [g5[:, i, :, i + 1, :] for i in range(m_blk - 1)], dim=1))
    gt_j = jnp.asarray(pre_np["gt"])
    g5_j = np.asarray(gt_j @ jnp.swapaxes(gt_j, 1, 2)).reshape(
        8, m_blk, blk, m_blk, blk)
    for i in range(m_blk):
        scale = float(np.abs(g5_j[:, i, :, i, :]).max())
        np.testing.assert_allclose(to_np(parts[2][:, i]), g5_j[:, i, :, i, :],
                                   rtol=0, atol=1e-5 * scale)
        if i + 1 < m_blk:
            np.testing.assert_allclose(to_np(parts[3][:, i]),
                                       g5_j[:, i, :, i + 1, :], rtol=0,
                                       atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# (iv) the dense inverse from the band.
# ---------------------------------------------------------------------------

def test_band_inverse_f64_against_jax():
    rng = np.random.RandomState(3)
    m, b = 4, 15
    # an SPD block-tridiagonal matrix with cond ~1e3, as the stage KKT
    dense = np.zeros((3, m * b, m * b))
    for s in range(3):
        for i in range(m):
            a = rng.randn(b, b)
            dense[s, i*b:(i+1)*b, i*b:(i+1)*b] = a @ a.T + 0.05 * np.eye(b)
            if i + 1 < m:
                c = 0.3 * rng.randn(b, b)
                dense[s, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = c
                dense[s, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = c.T
    dense += 2.0 * np.eye(m * b)
    dblk = np.stack([dense[:, i*b:(i+1)*b, i*b:(i+1)*b] for i in range(m)],
                    axis=1)
    ublk = np.stack([dense[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b]
                     for i in range(m - 1)], axis=1)
    ref = np.asarray(jbanded.spd_block_tridiag_inverse_blocks(
        jnp.asarray(dblk), jnp.asarray(ublk)))
    ours = to_np(tbanded.spd_block_tridiag_inverse_blocks(tt(dblk),
                                                          tt(ublk)))
    assert ours.dtype == np.float64 and ours.shape == (3, m * b, m * b)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(ours @ dense, np.broadcast_to(
        np.eye(m * b), dense.shape), atol=1e-10)
    # list-of-blocks input, as the factor takes it
    lists = tbanded.spd_block_tridiag_inverse_blocks(
        [tt(dblk[:, i]) for i in range(m)],
        [tt(ublk[:, i]) for i in range(m - 1)])
    np.testing.assert_array_equal(to_np(lists), ours)


# ---------------------------------------------------------------------------
# (ii) / (iii) whole solves on every route.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _force_interpret():
    """Run every Pallas kernel the JAX ``solve_qcqp_batch`` reaches in
    interpret mode, stated explicitly rather than left to its CPU
    auto-detection."""
    names = ("admm_stage_fused_factored", "admm_stage_fused", "gram_band",
             "gram_band_factors", "admm_stage_fused_factored_ew",
             "gram_band_factors_ew")
    orig = {n: getattr(jkernel, n) for n in names}
    for n, fn in orig.items():
        setattr(jkernel, n, functools.partial(fn, interpret=True))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(jkernel, n, fn)


def _route(route_id):
    return next(r for r in ROUTES if r[0] == route_id)


def _solve_jax_pallas(p, k, over, n_stages, n_iters):
    free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    vals = jnp.asarray(p["values"])
    d_fixed = jlinear.extract_fixed_values(free, vals)
    cfg = jqcqp.ADMMConfig(use_pallas=True, n_stages=n_stages,
                           **{**BENCH_KW, "n_iters": n_iters, **over})
    with _force_interpret():
        return jqcqp.solve_qcqp_batch(
            free, d_fixed, jnp.asarray(p["times"]),
            jnp.asarray(p["waypoints"]), jnp.asarray(p["radii"]), config=cfg,
            warmstart_values=vals, scenario_block=4)


def _solve_port(p, k, over, n_stages, n_iters):
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    cfg = mtt.ADMMConfig(n_stages=n_stages,
                         **{**BENCH_KW, "n_iters": n_iters, **over})
    before = dict(tkernel.launches)
    sol = mtt.solve_qcqp_batch(ts, d_fixed, p["times"], p["waypoints"],
                               p["radii"], config=cfg, device="cpu",
                               warmstart_values=p["values"])
    assert tkernel.launches == before      # host run: no kernel launch
    return sol


def _compare(ours, ref, tols):
    for name, (rtol, atol) in tols.items():
        a, b = to_np(getattr(ours, name)), to_np(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def _f32_tols(ref):
    # test_torch_qcqp_slice.py's float32 bars (its comment gives the noise
    # floors they stand on)
    scale = lambda n: float(np.abs(to_np(getattr(ref, n))).max())
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


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_solve_f32_route_against_pallas_interpret(route_id):
    _, k, over = _route(route_id)
    p = problem(k=k, batch=B, seed=5)
    ref = _solve_jax_pallas(p, k, over, 2, 20)
    ours = _solve_port(p, k, over, 2, 20)
    assert ours.cost.dtype == torch.float32
    _compare(ours, ref, _f32_tols(ref))
    p64 = {n: v.astype(np.float64) for n, v in p.items()}
    ours64 = _solve_port(p64, k, over, 2, 20)
    _compare(ours, ours64, _f32_tols(ours64))
    assert np.isfinite(to_np(ours.cost)).all()
    assert (to_np(ours.max_violation) < 1e-2).all()


@functools.lru_cache(maxsize=None)
def _generic_reference_f64(k, n_stages, n_iters):
    p = problem(k=k, batch=B, seed=6, dtype=np.float64)
    free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    vals = jnp.asarray(p["values"])
    d_fixed = jlinear.extract_fixed_values(free, vals)
    cfg = jqcqp.ADMMConfig(use_pallas=False, n_stages=n_stages,
                           **{**BENCH_KW, "n_iters": n_iters})
    ref = jax.vmap(lambda df, t, w, r, wv: jqcqp.solve_qcqp(
        free, df, t, w, r, cfg, warmstart_positions=wv[1:-1, 0, :]))(
        d_fixed, jnp.asarray(p["times"]), jnp.asarray(p["waypoints"]),
        jnp.asarray(p["radii"]), vals)
    assert ref.cost.dtype == jnp.float64
    return p, ref


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_solve_f64_route_against_generic_reference(route_id):
    """Every route in float64 (the wrappers run the plain versions) against
    the JAX package's reference-layout path in float64: one math, other
    assembly, other KKT solve.  1e-6 of each output's scale."""
    _, k, over = _route(route_id)
    p, ref = _generic_reference_f64(k, 2, 20)
    ours = _solve_port(p, k, over, 2, 20)
    assert ours.cost.dtype == torch.float64
    scale = lambda n: float(np.abs(np.asarray(getattr(ref, n))).max())
    _compare(ours, ref, {n: (0.0, 1e-6 * max(scale(n), 1.0))
                         for n in FIELDS})


def test_return_pre_on_the_dense_routes():
    """``_return_pre`` gives the same assembled system on every route (the
    lanes polish starts from it)."""
    for k, over in ((2, {}), (4, dict(kkt_inverse="cholesky"))):
        p = problem(k=k, batch=3, seed=2)
        ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
        d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
        args = (ts, d_fixed, p["times"], p["waypoints"], p["radii"])
        sol, pre = mtt.solve_qcqp_batch(
            *args, config=mtt.ADMMConfig(n_stages=1, n_iters=5, **over),
            warmstart_values=p["values"], device="cpu", _return_pre=True)
        plain = mtt.solve_qcqp_batch(
            *args, config=mtt.ADMMConfig(n_stages=1, n_iters=5, **over),
            warmstart_values=p["values"], device="cpu")
        np.testing.assert_array_equal(to_np(sol.cost), to_np(plain.cost))
        assert pre.gt.shape == (3, 15 * (k - 1), 384)
        assert torch.isfinite(pre.gt).all()


# ---------------------------------------------------------------------------
# (v) the route selectors, and carrying a config across.
# ---------------------------------------------------------------------------

def test_admm_config_route_fields():
    ours, ref = mtt.ADMMConfig(), jqcqp.ADMMConfig()
    for name in ("kkt_inverse", "kkt_apply", "band_gram", "gt_assembly"):
        assert getattr(ours, name) == getattr(ref, name)
    for name, bad in (("kkt_apply", "fctored"), ("kkt_inverse", "cholsky"),
                      ("band_gram", "pallas_dbb"), ("gt_assembly", "kernl")):
        with pytest.raises(ValueError, match=name):
            mtt.ADMMConfig(**{name: bad})
        with pytest.raises(ValueError, match=name):
            jqcqp.ADMMConfig(**{name: bad})
    for mode in ("xla", "pallas", "pallas_block", "pallas_db"):
        assert mtt.ADMMConfig(band_gram=mode).band_gram == mode


def test_admm_config_from_fields():
    src = jqcqp.ADMMConfig(rho=0.02, n_iters=7, kkt_apply="inverse",
                           kkt_inverse="cholesky", band_gram="pallas_db",
                           use_pallas=True, rho_tube_factor=0.125)
    ew = jqcqp.ADMMConfig(use_pallas=True, gt_assembly="kernel",
                          band_gram="pallas", rho=0.03, n_stages=2)
    for src in (src, ew):
        ours = mtt.admm_config_from_fields(src)
        for f in dataclasses.fields(mtt.ADMMConfig):
            assert getattr(ours, f.name) == getattr(src, f.name), f.name
        assert not hasattr(ours, "use_pallas")
    assert ours.gt_assembly == "kernel" and ours.band_gram == "pallas"


def test_wrappers_take_cpu_and_cuda_tensors_only():
    inp = _random_band_inputs()
    meta = torch.empty(inp["gt"].shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.gram_band(meta, blk=15)
    with pytest.raises(ValueError, match="init_z=False needs"):
        tkernel.admm_stage_fused(*(torch.zeros(1, 1, 1),) * 7,
                                 n_iters=1, alpha=ALPHA, nb_p=1,
                                 init_z=False)


# ---------------------------------------------------------------------------
# (v b) #2's cluster design: its order, its shared memory, its choice.
# ---------------------------------------------------------------------------

COST_GAP_MEDIAN = 1e-3
COST_GAP_P99 = 1e-2
F64_RTOL = 1e-9
# #2's routes by K: K=2 has only the dense KKT; from K=3 the dense inverse
# is kkt_apply="inverse" (dense_path (a) of chip_smoke.py)
FUSED_ROUTE = {2: {}, 4: dict(kkt_apply="inverse"),
               10: dict(kkt_apply="inverse")}


def _fused_args(inp, init_z=True):
    names = ("rho", "winv", "gt", "b", "rb", "xq") + (
        ("x0",) if init_z else ("x1", "z1", "u1"))
    return [inp[n] for n in names], dict(_stage_kw(inp), init_z=init_z)


@pytest.mark.parametrize("k", [2, 4, 10])
def test_fused_winv_order_f32_against_pallas(k):
    """Per output, no further from the reference order run in float64 than
    float32 runs of the reference order are (the JAX kernel's and the
    port's plain version's, the larger) thrice over, plus 1e-6 of the
    output's scale."""
    args, kw = _fused_args(_stage_inputs(k))
    ref = jkernel.admm_stage_fused(*(jnp.asarray(a) for a in args),
                                   interpret=True, **kw)
    ours = tkernel.admm_stage_fused_winv_plain(*(tt(a) for a in args), **kw)
    ref32 = tkernel.admm_stage_fused_plain(*(tt(a) for a in args), **kw)
    ref64 = tkernel.admm_stage_fused_plain(
        *(tt(a, torch.float64) for a in args), **kw)
    for a, r, p, c, name in zip(ours, ref, ref32, ref64, STAGE_NAMES):
        assert a.dtype == torch.float32 and a.shape == r.shape
        c = to_np(c)
        scale = _scale(c)
        err = np.abs(to_np(a).astype(np.float64) - c).max()
        floor = max(np.abs(np.asarray(r, np.float64) - c).max(),
                    np.abs(to_np(p).astype(np.float64) - c).max())
        assert err <= 3.0 * floor + 1e-6 * scale, (name, err, floor)


@pytest.mark.parametrize("k", [2, 4, 10])
def test_fused_winv_order_f64_matches_reference_order(k):
    inp = _stage_inputs(k)
    for init_z in (True, False):
        args, kw = _fused_args(inp, init_z)
        args = [tt(a, torch.float64) for a in args]
        ours = tkernel.admm_stage_fused_winv_plain(*args, **kw)
        ref = tkernel.admm_stage_fused_plain(*args, **kw)
        for a, r, name in zip(ours, ref, STAGE_NAMES):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(to_np(a), to_np(r), rtol=0,
                                       atol=F64_RTOL * _scale(to_np(r)),
                                       err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
def test_fused_winv_order_cost_gap_against_jax(k, monkeypatch):
    """The whole solve on #2's route with the stage in its cluster design's
    order (its plain version in place of the wrapper) against the JAX
    package's solve on the same route with its Pallas kernels in interpret
    mode, on the same scenarios, at the benchmark's 48 iterations."""
    over = FUSED_ROUTE[k]
    p = problem(k=k, batch=B, seed=0)
    ref = _solve_jax_pallas(p, k, over, 1, BENCH_KW["n_iters"])
    calls = []

    def twin(*a, **kw):
        calls.append(1)
        return tkernel.admm_stage_fused_winv_plain(*a, **kw)
    monkeypatch.setattr(tkernel, "admm_stage_fused", twin)
    ours = _solve_port(p, k, over, 1, BENCH_KW["n_iters"])
    assert calls == [1]
    c_ours = to_np(ours.cost).astype(np.float64)
    c_ref = np.asarray(ref.cost, np.float64)
    gap = np.abs(c_ours - c_ref) / np.abs(c_ref)
    assert np.isfinite(gap).all()
    assert np.median(gap) <= COST_GAP_MEDIAN, gap
    assert np.quantile(gap, 0.99) <= COST_GAP_P99, gap


def _layout(k):
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    lay = tqcqp._flagship_layout(ts)
    return 15 * (k - 1), lay.m_p, k - 1, lay.nb_p


@pytest.mark.parametrize("k,fits", [(2, True), (4, True), (10, True),
                                    (12, False)])
def test_fused_cluster_layout_within_the_h100_budget(k, fits):
    """A block of #2's cluster design (W^-1 given: no sweep scratch; G^T's
    share as kernel 1's) holds its share within the 232,448 B an H100 block
    may take at K=2, K=4 and K=10 and not at K=12; the same bytes as kernel
    1's layout, which forms W^-1 over the tail of G^T's share."""
    nfd, m_p, m_blk, nb_p = _layout(k)
    got = tkernel.cluster_smem_bytes("admm_stage_fused", nfd, m_p, m_blk, 15,
                                     nb_p)
    assert (got <= H100_SMEM_OPTIN) == fits
    assert got == tkernel.cluster_smem_bytes(
        "admm_stage_fused_factored", nfd, m_p, m_blk, 15, nb_p)
    if k == 10:
        assert got == 224288


@pytest.mark.parametrize("k,design,threads", [
    (2, "cluster", 64), (3, "cluster", 64), (4, "cluster", 128),
    (6, "cluster", 256), (10, "cluster", 512), (11, "stream", None),
    (12, "stream", None)])
def test_fused_design_by_shape(k, design, threads):
    """The design #2 takes at each shape on an H100: the cluster design
    where its layout fits a block's 232,448 B, the stream design past it
    (the launcher's choice on the card: ``test_fused_design_by_shape_on_the_
    card``); the block size the card takes keeps an SM at 512 threads over
    the blocks its shared memory holds (K=2: eight blocks of 64), or is the
    fewest, 64."""
    nfd, m_p, m_blk, nb_p = _layout(k)
    got = tkernel.cluster_smem_bytes("admm_stage_fused", nfd, m_p, m_blk, 15,
                                     nb_p)
    assert ("cluster" if got <= H100_SMEM_OPTIN else "stream") == design
    if design == "cluster":
        assert threads * blocks_an_sm(got) <= 512 or threads == 64


# ---------------------------------------------------------------------------
# (v c) the band kernels' designs: the ring at the solver's band block, the
# window body elsewhere.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m_blk,smem,per_sm", [
    (2, 1, 77784, 2), (4, 3, 77784, 2), (10, 9, 100824, 2),
    (12, 11, 123864, 1)])
def test_band_design_by_shape(k, m_blk, smem, per_sm):
    """#5 and #6 take the ring at every assembly's band block (15 rows),
    K=2's single block (no gu) included: ``threads`` a block of whole warps,
    computing warps of lane groups of 15 tile-owning threads and one
    producer warp, at least three slabs (slab r + 2 lands while step r reads
    r and r + 1), and a block's shared memory -- the slabs in rows padded to
    ``ring_ld``, each computing warp's partials of gd and gu, an mbarrier a
    slot -- within the 232,448 B an H100 block may take, two blocks an SM
    from K=2 to K=10."""
    nfd, m_p, got_m_blk, _ = _layout(k)
    assert got_m_blk == m_blk and nfd == 15 * m_blk
    d = tkernel.band_design(nfd, m_p, 15)
    assert d.design == "ring"
    assert d.threads % 32 == 0 and 96 <= d.threads <= 288
    assert 3 <= d.slots <= 4 and d.per_block >= 0
    assert d.tile in tkernel.RING_TILES
    ld = tkernel.ring_ld(m_p)
    assert ld % 8 == 0 and (ld // 4) % 8 == 2 and ld >= m_p
    assert d.smem_bytes == smem == tkernel.ring_smem_bytes(m_p, d.threads,
                                                            d.slots)
    assert d.smem_bytes == (4 * (d.slots * 15 * ld
                                 + (d.threads // 32 - 1) * 450)
                            + 8 * d.slots)
    assert d.smem_bytes <= H100_SMEM_OPTIN
    assert blocks_an_sm(d.smem_bytes) == per_sm


@pytest.mark.parametrize("blk", [1, 5, 9, 45, 135])
def test_band_design_window_elsewhere(blk):
    """Band blocks other than 15 keep the window body: one block of
    ``WINDOW_THREADS`` a scenario, two slabs of m_p + 1 floats a row; a
    ring that does not fit a block would take it too."""
    nfd, m_p = 135, 512
    d = tkernel.band_design(nfd, m_p, blk)
    assert d.design == "window" and d.threads == tkernel.WINDOW_THREADS
    assert d.smem_bytes == tkernel.window_smem_bytes(m_p, blk) \
        == 8 * blk * (m_p + 1)
    assert tkernel.band_design(15, 8192, 15).design == "window"
    assert tkernel.ring_smem_bytes(8192) > H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="multiple"):
        tkernel.band_design(nfd, m_p, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("k,design,threads", [
    (2, "cluster", 64), (3, "cluster", 64), (4, "cluster", 128),
    (6, "cluster", 256), (10, "cluster", 512), (11, "stream", None),
    (12, "stream", None)])
def test_fused_design_by_shape_on_the_card(k, design, threads):
    """#2's launcher, asked on the card, takes the design and the block size
    stated at each shape.  Needs an NVIDIA card and nvcc; skipped on hosts
    without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    nfd, m_p, m_blk, nb_p = _layout(k)
    assert tkernel.fused_design(nfd, m_p, nb_p) == design
    if design == "cluster":
        assert tkernel.block_threads(nfd, m_p, 0, 0, nb_p,
                                     "admm_stage_fused") == threads


# ---------------------------------------------------------------------------
# (vi) on the card: each new kernel against its plain version.
# ---------------------------------------------------------------------------

# (m_blk, blk, m_p) of the band kernels' cases on the card: the ring at K=2
# (one block, no gu), K=4, K=10 and K=12's widths, the window body at a
# band block of 9 rows.
BAND_CARD_SHAPES = {"": (3, 15, 384), "k2": (1, 15, 384),
                    "k10": (9, 15, 512), "k12": (11, 15, 640),
                    "window": (15, 9, 512)}


def _card_case(name):
    """(kernel, plain version, args on the card, kwargs, relative bar)."""
    dev = torch.device("cuda")
    if name.startswith("gram_band"):
        kernel, _, shape = name.partition(" ")
        m_blk, blk, m_p = BAND_CARD_SHAPES[shape]
        inp = _random_band_inputs(m_blk=m_blk, blk=blk, m_p=m_p)
        gt = tt(inp["gt"]).to(dev)
        assert tkernel.band_design(m_blk * blk, m_p, blk).design == (
            "window" if shape == "window" else "ring")
        if kernel == "gram_band":
            return (tkernel.gram_band, tkernel.gram_band_plain, (gt,),
                    dict(blk=blk), 1e-5)
        args = tuple(tt(inp[n]).to(dev) for n in ("gt", "pb_d", "pb_u",
                                                  "rho"))
        return (tkernel.gram_band_factors, tkernel.gram_band_factors_plain,
                args, dict(blk=blk, sigma=SIGMA), 1e-5)
    inp = _stage_inputs(4)
    kw = _stage_kw(inp)
    if name == "admm_stage":
        m1 = inp["winv"] @ inp["gt"]
        args = (inp["rho"], m1, inp["gt"], inp["b"], inp["rb"], inp["xq"],
                inp["z1"], inp["u1"])
        return (tkernel.admm_stage, tkernel.admm_stage_plain,
                tuple(tt(a).contiguous().to(dev) for a in args), kw, 2e-4)
    init_z = name == "admm_stage_fused"
    names = ("rho", "winv", "gt", "b", "rb", "xq") + (
        ("x0",) if init_z else ("x1", "z1", "u1"))
    # K=4 takes the cluster design: held to the plain version in its order
    assert tkernel.fused_design(*inp["gt"].shape[1:], kw["nb_p"]) == "cluster"
    return (tkernel.admm_stage_fused, tkernel.admm_stage_fused_winv_plain,
            tuple(tt(inp[n]).to(dev) for n in names),
            dict(kw, init_z=init_z), 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "admm_stage_fused", "admm_stage_fused_carried", "admm_stage",
    "gram_band", "gram_band_factors", "gram_band k2", "gram_band_factors k2",
    "gram_band k10", "gram_band_factors k10", "gram_band k12",
    "gram_band_factors k12", "gram_band window", "gram_band_factors window"])
def test_new_kernels_on_the_card_match_plain(name):
    """Needs an NVIDIA card and nvcc; skipped on hosts without them.  The
    stage kernels at 2e-4 of each output's scale (rsqrtf is not correctly
    rounded on the card; sums run in another order), the band kernels at
    1e-5, in the ring (K=2, K=4, K=10, K=12's widths: same bits run to run,
    gd exactly symmetric) and in the window body (a band block of 9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    fn, fn_plain, args, kw, rel = _card_case(name)
    key = "admm_stage_fused" if name.startswith("admm_stage_fused") \
        else name.split()[0]
    before = tkernel.launches[key]
    ours = fn(*args, **kw)
    torch.cuda.synchronize()
    assert tkernel.launches[key] == before + 1
    plain = fn_plain(*args, **kw)
    for a, b in zip(ours, plain):
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0, atol=rel * _scale(b))
    if name.startswith("gram_band"):
        again = fn(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(ours, again))
        if key == "gram_band":
            assert torch.equal(ours[0], ours[0].transpose(-1, -2))
    with pytest.raises(TypeError, match="float32"):
        fn(*(a.double() for a in args), **kw)
    i = 0 if name.startswith("gram") else 2       # G^T
    strided = list(args)
    strided[i] = args[i].mT.contiguous().mT
    with pytest.raises(ValueError, match="contiguous"):
        fn(*strided, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 10])
def test_fused_designs_on_the_card(k):
    """#2 takes its cluster design (K=2 in blocks of 64 threads, K=4 of
    128, K=10 of 512), agrees with the plain version in that design's order
    at 2e-4 of each output's scale in both entry modes, gives the same bits
    run to run, and with alpha 1.62 for 1.6 does not agree.  Needs an
    NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")
    inp = _stage_inputs(k)
    nfd, m_p = inp["gt"].shape[1:]
    nb_p = inp["layout"].nb_p
    assert tkernel.fused_design(nfd, m_p, nb_p) == "cluster"
    assert tkernel.block_threads(nfd, m_p, 0, 0, nb_p, "admm_stage_fused") \
        == {2: 64, 4: 128, 10: 512}[k]
    plain = tkernel.admm_stage_fused_winv_plain
    for init_z in (True, False):
        args, kw = _fused_args(inp, init_z)
        args = [tt(a).contiguous().cuda() for a in args]
        first = tkernel.admm_stage_fused(*args, **kw)
        again = tkernel.admm_stage_fused(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        ref = [to_np(r) for r in plain(*args, **kw)]
        # the dual, max|G^T (z - z_prev)|, scaled as _assert_stage_close
        # scales it: a row sum of |G^T| for each of z and z_prev
        scales = [_scale(r) for r in ref]
        scales[5] = max(scales[5], 2.0 * float(np.abs(inp["gt"]).sum(-1).max()))
        for a, r, sc in zip(first, ref, scales):
            np.testing.assert_allclose(to_np(a), r, rtol=0, atol=2e-4 * sc)
        wrong = tkernel.admm_stage_fused(*args, **dict(kw, alpha=1.62))
        assert any(np.abs(to_np(a) - r).max() > 2e-4 * sc
                   for a, r, sc in zip(wrong, ref, scales))
