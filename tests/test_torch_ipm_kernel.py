"""The plain PyTorch versions of the interior-point kernels (``ipm_eval_step``
with band output and with the whole Gram, ``ipm_pipe_step``,
``ipm_solve_fused``, ``gt_matvec``) against the JAX package's Pallas kernels
run in interpret mode, one call each, on the same float32 arrays: random
arrays at the shapes of
``tests/test_ipm_lanes.py::test_ipm_kernel_eval_matches_xla_core`` (m_p >
3 nb_p: the final half-space plane is present) and the recorded calls of a
real K=4 solve (m_p == 3 nb_p: all half rows packed in the tails).

Tolerances.  Both sides run the same float32 formulas; they differ in the
order of the sums (XLA:CPU reductions and dots vs PyTorch's) and in fused
multiply-adds.  An output is compared, scenario by scenario, at a tolerance
times its own scale (max |reference|):

* random arrays, ``TOL`` = 2e-5: sums of a few hundred well-scaled float32
  terms (~1e-6 relative each way) with a margin of ten; no scenario may be
  outside.
* the real system, ``TOL_REAL`` = 2e-3: there the complementarity weights
  w = lam / s reach the 1e6 cap (and the snap's penalty 1e4) and multiply the
  float32 rounding of r2 = c + s and of c = 0.5 (|y|^2 - r^2), both
  differences of nearly equal numbers, so J^T (w r2), the next right-hand
  side, the multiplier update and the weighted Gram carry up to ~1e-3 of
  their scale in ANY float32 order (measured here: 4e-4 to 8e-4).  And the
  step takes discrete decisions on float comparisons (the snap's
  ``c > -margin`` lane selection, the line search, "merit < best"): where
  the two evaluations of one sum fall on different sides, that scenario
  differs by a whole weight or step.  One scenario of the eight may be
  outside for that reason; the others hold the tolerance.
* the right-hand side a snap evaluation emits, J^T max(rho c, 0), gets an
  absolute floor besides: once a sweep has repaired the violations it is
  nothing but rho = 1e4 times the rounding of c, whose cancellation loses one
  ulp of max(rb^2) (6400 here, ulp 5e-4), so two float32 evaluations differ
  by rho * ulp * max|gt| per near-active lane (measured: up to 7 on a
  right-hand side of scale 9).  The floor is four lanes' worth.
* the whole polish (``ipm_solve_fused``) is many such steps in a row.  Short
  runs (one or two Newton steps, one or two snap sweeps) hold ``TOL_REAL`` in
  every output and scenario (measured 1e-4; the merit 1e-3).  After ten
  Newton steps the best iterate still does (x_fin, y_fin: measured 1.2e-4),
  but the running iterate (s_fin, lam_fin, y_last, the merit, and already
  lam_mid at step 5) is the endgame's: mu has fallen to float32's floor and
  two float32 orders of the same sums leave it 1e-2 (lam_mid, slacks) to 0.8
  (multipliers) of scale apart.  Those outputs
  are held to the solution class only: finite, and a scaled primal residual
  of the final point within 3x of the reference's plus 5e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import ipm_kernel as jk
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel as tk

from torch_port_util import BENCH_KW, N, problem, to_np, tt

TOL = 2e-5
TOL_REAL = 2e-3
MODE_PAIRS = [("none", "snap"), ("snap", "snap"), ("snap", "none"),
              ("none", "newton"), ("newton", "newton"), ("newton", "snap"),
              ("newton", "none")]
PIPE_OUT = ("x", "s", "lam", "y", "bx", "by", "bm", "max_lam", "hd", "hu",
            "rhs")
EVAL_OUT = ("y", "c", "jtwr2", "jts", "hd", "hu")
GRAM_OUT = ("y", "c", "jtwr2", "jts", "gram")
FUSED_OUT = ("x_fin", "y_fin", "s_fin", "lam_fin", "y_last", "best_merit",
             "lam_mid", "lam_fin_max")
FUSED_CONFIGS = {"it10_snap2": dict(n_iters=10, snap_iters=2),
                 "snap_only": dict(n_iters=0, snap_iters=2),
                 "it1": dict(n_iters=1, snap_iters=0),
                 "it2_snap1": dict(n_iters=2, snap_iters=1)}


def _close(ours, ref, names, tol=TOL, flip_rows=0, floors=None):
    """Every output within ``tol`` of its scale (plus its absolute floor, if
    ``floors`` names one) in every scenario, but for at most ``flip_rows``
    scenarios (the same ones across outputs)."""
    assert len(ours) == len(ref) == len(names)
    outside = np.zeros(to_np(ours[0]).shape[0], bool)
    worst = {}
    for name, a, b in zip(names, ours, ref):
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert a.dtype == np.float32 and b.dtype == np.float32, name
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=name)
        scale = max(float(np.abs(b[fin]).max()) if fin.any() else 0.0, 1e-30)
        err = np.where(fin, np.abs(a - np.where(fin, b, 0)), 0.0).reshape(
            a.shape[0], -1).max(axis=1)
        outside |= err > tol * scale + (floors or {}).get(name, 0.0)
        worst[name] = float(err.max() / scale)
    assert outside.sum() <= flip_rows, (outside, worst)


def _random_inputs(seed=0, s_blk=2, nfd=24, nb_p=128, nh_p=128, n_ball=17,
                   blk=6):
    """Random float32 arrays for one step at small widths; every lane real
    (act = 1) but a few pads, count weights on plane 0 and the last plane."""
    rng = np.random.RandomState(seed)
    f = np.float32
    m_p = 3 * nb_p + nh_p
    m_blk = nfd // blk
    act = np.ones((1, 1, m_p), f)
    act[:, :, nb_p - 5:nb_p] = 0.0            # some pad lanes in plane 0
    cw = np.zeros((1, 1, m_p), f)
    cw[:, :, :nb_p] = 1.0
    cw[:, :, 3 * nb_p:] = 1.0
    cw *= act
    gt = rng.randn(s_blk, nfd, m_p).astype(f) * 0.3 * act
    spd = rng.randn(s_blk, m_blk, blk, blk)
    sinv = (spd @ spd.transpose(0, 1, 3, 2) / blk
            + np.eye(blk)).astype(f)
    t = (rng.randn(s_blk, m_blk - 1, blk, blk) * 0.2).astype(f)
    s = rng.uniform(0.1, 2.0, (s_blk, 1, m_p)).astype(f)
    lam = rng.uniform(0.01, 1.0, (s_blk, 1, m_p)).astype(f) * act
    d = dict(
        gt=gt, b=(rng.randn(s_blk, 1, m_p) * 0.5).astype(f) * act,
        rb=rng.uniform(0.5, 2.0, (s_blk, 1, nb_p)).astype(f),
        pe_d=(spd @ spd.transpose(0, 1, 3, 2) / blk).astype(f),
        pe_u=(rng.randn(s_blk, m_blk - 1, blk, blk) * 0.1).astype(f),
        q=rng.randn(s_blk, nfd, 1).astype(f),
        x=rng.randn(s_blk, nfd, 1).astype(f), s=s, lam=lam,
        y=(rng.randn(s_blk, 1, m_p) * 0.7).astype(f) * act,
        bx=rng.randn(s_blk, nfd, 1).astype(f),
        by=(rng.randn(s_blk, 1, m_p) * 0.7).astype(f) * act,
        bm=np.array([[[np.inf]], [[0.5]]], f)[:s_blk],
        sinv=sinv, t=t, tt=np.ascontiguousarray(t.transpose(0, 1, 3, 2)),
        dsc=rng.uniform(0.5, 1.5, (s_blk, nfd, 1)).astype(f),
        rhs=(rng.randn(s_blk, nfd, 1) * 0.1).astype(f), act=act, cw=cw)
    kw = dict(nb_p=nb_p, n_ball=n_ball, mc=int(cw.sum()), sigma_min=0.3,
              tau=0.995, alpha_max=1.0, w_cap=1e6, reg=1e-9, snap_rho=1e4,
              blk=blk)
    return d, kw


def _rows_flooring_in_float64(args, kw):
    """The scenarios in which the plain whole polish, run in float64 on
    ``args``, floors a pivot of its band factor (``tk.PIVOT_FLOOR``): there
    the Newton matrix is indefinite or too near singular for any float32
    factor, and the port's floored Cholesky deliberately gives another
    direction than the JAX kernel's Gauss-Jordan inverses."""
    seen = []
    keep = tk._band_factor_solve

    def spy(*a):
        # the shift E the floor adds to H: positive where it lifts a pivot
        dx, shift = keep(*a, return_shift=True)
        seen.append(((shift > 0) | torch.isnan(shift)).flatten(1).any(1))
        return dx

    tk._band_factor_solve = spy
    try:
        tk.ipm_solve_fused_plain(*(a.double() for a in args), **kw)
    finally:
        tk._band_factor_solve = keep
    if not seen:
        return []
    return torch.stack(seen).any(0).nonzero().flatten().tolist()


def _fused_random_case(n_iters, snap_iters, seed=10):
    """Random whole-polish inputs for four scenarios (``_random_inputs``)
    with the structure of a real polish, where the Newton matrix is the
    band and positive definite.  Each constraint reaches two neighbouring
    row blocks k, k + 1 of G^T (a ball's three lanes the same two, k its
    index modulo m - 1), so the weighted Gram is block-tridiagonal and its
    band is all of it, as every real assembly's is (the band of a dense
    random Gram can be indefinite).  The objective band is positive
    semidefinite, as a minimum-snap objective's is: P = L L^T for a block
    lower-bidiagonal L (diagonal blocks D_i, sub-diagonal S_i), so pe_d_i =
    D_i D_i^T + S_(i-1) S_(i-1)^T and pe_u_i = D_i S_i^T.  Returns (kw, the
    JAX kernel's outputs on the scenarios as two blocks of two, the port's
    arguments as a flat batch of four)."""
    d, kw = _random_inputs(seed=seed, s_blk=4)
    rng = np.random.RandomState(seed + 100)
    f = np.float32
    s_blk, m_blk, blk = 4, d["pe_d"].shape[1], kw["blk"]
    nb_p, m_p = kw["nb_p"], d["gt"].shape[2]
    lane = np.arange(m_p)
    k = np.where(lane < 3 * nb_p, lane % nb_p, lane - 3 * nb_p) % (m_blk - 1)
    row_block = np.arange(m_blk * blk)[:, None] // blk
    d["gt"] = d["gt"] * ((row_block == k) | (row_block == k + 1))
    dg = rng.randn(s_blk, m_blk, blk, blk) / np.sqrt(blk)
    sub = rng.randn(s_blk, m_blk - 1, blk, blk) * 0.3 / np.sqrt(blk)
    pe_d = dg @ dg.transpose(0, 1, 3, 2)
    pe_d[:, 1:] += sub @ sub.transpose(0, 1, 3, 2)
    pe_u = dg[:, :-1] @ sub.transpose(0, 1, 3, 2)
    state = {n: d[n] for n in ("gt", "b", "rb", "q", "act", "cw")}
    state.update(pe_d=pe_d.astype(f), pe_u=pe_u.astype(f), x0=d["x"],
                 s0=d["s"], lam0=d["lam"])
    state["y0"] = (np.einsum('snm,sno->som', d["gt"], d["x"])
                   + d["b"]).astype(f)
    kw = dict(kw, n_iters=n_iters, snap_iters=snap_iters)
    names = mtt.convert.FUSED_SOLVE_INPUTS
    blocked = {n: (state[n] if n in ("act", "cw") else
                   state[n].reshape((2, 2) + state[n].shape[1:]))
               for n in names}
    import jax
    ref = jax.vmap(lambda *a: jk.ipm_solve_fused(
        *a, jnp.asarray(state["act"]), jnp.asarray(state["cw"]),
        interpret=True, **kw))(*(jnp.asarray(blocked[n]) for n in names[:10]))
    ref = [np.asarray(r).reshape((4,) + r.shape[2:]) for r in ref]
    args = mtt.fused_state_from_numpy(blocked, device="cpu")
    return kw, ref, args


def _pipe_both(d, kw, upd, ev):
    names = mtt.convert.PIPE_STEP_INPUTS
    ref = jk.ipm_pipe_step(*(jnp.asarray(d[n]) for n in names),
                           upd_mode=upd, eval_mode=ev, interpret=True, **kw)
    ours = tk.ipm_pipe_step(*mtt.lanes_state_from_numpy(d, device="cpu"),
                            upd_mode=upd, eval_mode=ev, **kw)
    return ours, ref


@pytest.mark.parametrize("upd,ev", MODE_PAIRS)
def test_pipe_step_random_against_pallas_interpret(upd, ev):
    d, kw = _random_inputs(seed=3)
    ours, ref = _pipe_both(d, kw, upd, ev)
    _close(ours, ref, PIPE_OUT)
    if ev == "none":
        assert not to_np(ours[8]).any() and not to_np(ours[10]).any()
    # the step did something where it should
    moved = np.abs(to_np(ours[4]) - d["bx"]).max() > 0
    assert moved == (upd != "none")


@pytest.mark.parametrize("phr", [False, True])
def test_eval_step_random_against_pallas_interpret(phr):
    d, kw = _random_inputs(seed=4)
    if phr:      # as the snap feeds it: lam on some lanes, s = lam / rho
        rng = np.random.RandomState(5)
        d["lam"] = np.where(rng.rand(*d["lam"].shape) < 0.3, 1e-6,
                            0.0).astype(np.float32)
        d["s"] = (d["lam"] / 1e4).astype(np.float32)
    args = [d[n] for n in ("gt", "b", "rb", "x", "s", "lam")]
    w_cap = 1e4 if phr else 1e6
    ref = jk.ipm_eval_step(*(jnp.asarray(a) for a in args), nb_p=kw["nb_p"],
                           n_ball=kw["n_ball"], w_cap=w_cap, phr=phr,
                           band_block=kw["blk"], interpret=True)
    ours = tk.ipm_eval_step(*(tt(a) for a in args), nb_p=kw["nb_p"],
                            n_ball=kw["n_ball"], w_cap=w_cap, phr=phr,
                            band_block=kw["blk"])
    _close(ours, ref, EVAL_OUT)


def test_gt_matvec_random_against_pallas_interpret():
    d, _ = _random_inputs(seed=6)
    ref = jk.gt_matvec(jnp.asarray(d["gt"]), jnp.asarray(d["x"]),
                       interpret=True)
    ours = tk.gt_matvec(tt(d["gt"]), tt(d["x"]))
    _close((ours,), (ref,), ("y",))


@pytest.mark.parametrize("batch,m_p,want", [
    (645, 512, 32), (128, 512, 32), (40, 512, 16), (1, 512, 8), (32, 512, 8),
    (645, 384, 32), (3, 20, 8)])
def test_gt_matvec_chunk(batch, m_p, want):
    """The lanes a block of the matvec kernel covers: the largest chunk that
    still gives an H100's 132 SMs two blocks each (tier 1's 645 rows, the
    restart's 128), else the smallest (the chain's one row: 16 blocks of 8
    float4 columns); the chunks cover every float4 column of a row."""
    chunk = tk.matvec_chunk(batch, m_p, 132)
    assert chunk == want and chunk in tk.MATVEC_CHUNKS
    blocks = -(-(m_p // 4) // chunk)
    assert (blocks - 1) * chunk < m_p // 4 <= blocks * chunk
    if chunk != tk.MATVEC_CHUNKS[-1]:
        assert batch * blocks >= tk.MATVEC_BLOCKS_PER_SM * 132


def test_eval_band_equals_band_of_the_full_gram():
    """The band-only products against the reference's own full-Gram core
    (``_eval_core`` + dense einsum, as tests/test_ipm_lanes.py:250 forms
    it)."""
    d, kw = _random_inputs(seed=7)
    args = [d[n] for n in ("gt", "b", "rb", "x", "s", "lam")]
    blk, nfd = kw["blk"], d["gt"].shape[1]
    _, _, _, _, lam_ball, aj, w_aj = jk._eval_core(
        *(jnp.asarray(a) for a in args), nb_p=kw["nb_p"],
        n_ball=kw["n_ball"], w_cap=1e6)
    gram = np.asarray(
        jnp.einsum('snm,som->sno', jnp.asarray(d["gt"]) * lam_ball,
                   jnp.asarray(d["gt"]))
        + jnp.einsum('snm,som->sno', aj * w_aj, aj))
    ours = tk.ipm_eval_step_plain(*(tt(a) for a in args), nb_p=kw["nb_p"],
                                  n_ball=kw["n_ball"], w_cap=1e6,
                                  band_block=blk)
    hd, hu = to_np(ours[4]), to_np(ours[5])
    scale = np.abs(gram).max()
    for i in range(nfd // blk):
        r = slice(i * blk, (i + 1) * blk)
        assert np.abs(hd[:, r] - gram[:, r, r]).max() <= TOL * scale
        if (i + 1) * blk < nfd:
            q = slice((i + 1) * blk, (i + 2) * blk)
            assert np.abs(hu[:, r] - gram[:, r, q]).max() <= TOL * scale


@pytest.fixture(scope="module")
def real_calls():
    """Kernel calls recorded from real K=4 polishes on the host (the plain
    versions run; their inputs are what a solve really feeds the kernels:
    weights spanning decades, pads, replicated ball lanes)."""
    p = problem(k=4, batch=8, seed=0)
    ts = mtt.make_structure(mtt.free_interior_mask(5, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    calls = {"pipe": [], "eval": [], "mv": [], "fused": []}
    kept = {n: getattr(tk, n) for n in ("ipm_pipe_step", "ipm_eval_step",
                                        "gt_matvec", "ipm_solve_fused")}

    def rec(name, key):
        def wrapper(*a, **k):
            calls[key].append((a, k))
            return kept[name](*a, **k)
        return wrapper

    tk.ipm_pipe_step = rec("ipm_pipe_step", "pipe")
    tk.ipm_eval_step = rec("ipm_eval_step", "eval")
    tk.gt_matvec = rec("gt_matvec", "mv")
    tk.ipm_solve_fused = rec("ipm_solve_fused", "fused")
    try:
        for cfg in [dict(n_iters=0, snap_iters=2, pipelined=True),
                    dict(n_iters=3, snap_iters=1, pipelined=True),
                    dict(n_iters=2, snap_iters=0, pipelined=True),
                    dict(n_iters=2, snap_iters=1)] + [
                        dict(fused=True, **c)
                        for c in FUSED_CONFIGS.values()]:
            mtt.solve_qcqp_polished_batch(
                ts, d_fixed, p["times"], p["waypoints"], p["radii"],
                admm_config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
                ipm_config=mtt.IPMConfig(sigma_min=0.3, corrector=False,
                                         **cfg),
                warmstart_values=p["values"], device="cpu")
    finally:
        for n, fn in kept.items():
            setattr(tk, n, fn)
    return calls


@pytest.mark.parametrize("upd,ev", MODE_PAIRS)
def test_pipe_step_real_system_against_pallas_interpret(real_calls, upd, ev):
    a, k = [c for c in real_calls["pipe"]
            if (c[1]["upd_mode"], c[1]["eval_mode"]) == (upd, ev)][-1]
    assert a[0].shape == (8, 45, 384) and k["nb_p"] * 3 == 384
    ours = tk.ipm_pipe_step_plain(*a, **k)
    ref = jk.ipm_pipe_step(*(jnp.asarray(to_np(x)) for x in a),
                           interpret=True, **k)
    floors = None
    if ev == "snap":
        rb2 = float(a[2].max()) ** 2
        floors = {"rhs": 4 * k["snap_rho"] * rb2 * 2.0 ** -24
                  * float(a[0].abs().max())}
    _close(ours, ref, PIPE_OUT, tol=TOL_REAL, flip_rows=1, floors=floors)


@pytest.mark.parametrize("phr", [False, True])
def test_eval_step_real_system_against_pallas_interpret(real_calls, phr):
    a, k = [c for c in real_calls["eval"] if c[1]["phr"] == phr][-1]
    ours = tk.ipm_eval_step_plain(*a, **k)
    ref = jk.ipm_eval_step(*(jnp.asarray(to_np(x)) for x in a),
                           interpret=True, **k)
    _close(ours, ref, EVAL_OUT, tol=TOL_REAL)
    a_mv, _ = real_calls["mv"][-1]
    _close((tk.gt_matvec_plain(*a_mv),),
           (jk.gt_matvec(*(jnp.asarray(to_np(x)) for x in a_mv),
                         interpret=True),), ("y",))


@pytest.mark.parametrize("phr", [False, True])
def test_full_gram_random_against_pallas_interpret(phr):
    """``band_block=0``: the whole weighted Gram, against the Pallas kernel
    and against the band form of the same point."""
    d, kw = _random_inputs(seed=4)
    if phr:
        rng = np.random.RandomState(5)
        d["lam"] = np.where(rng.rand(*d["lam"].shape) < 0.3, 1e-6,
                            0.0).astype(np.float32)
        d["s"] = (d["lam"] / 1e4).astype(np.float32)
    args = [d[n] for n in ("gt", "b", "rb", "x", "s", "lam")]
    w_cap = 1e4 if phr else 1e6
    ekw = dict(nb_p=kw["nb_p"], n_ball=kw["n_ball"], w_cap=w_cap, phr=phr)
    ref = jk.ipm_eval_step(*(jnp.asarray(a) for a in args), band_block=0,
                           interpret=True, **ekw)
    ours = tk.ipm_eval_step(*(tt(a) for a in args), band_block=0, **ekw)
    assert len(ours) == 5 and ours[4].shape == (2, 24, 24)
    _close(ours, ref, GRAM_OUT)
    gram = to_np(ours[4])
    np.testing.assert_allclose(gram, gram.transpose(0, 2, 1), rtol=0,
                               atol=TOL * np.abs(gram).max())
    band = tk.ipm_eval_step_plain(*(tt(a) for a in args),
                                  band_block=kw["blk"], **ekw)
    blk, nfd = kw["blk"], 24
    hd, hu = to_np(band[4]), to_np(band[5])
    scale = np.abs(gram).max()
    for i in range(nfd // blk):
        r = slice(i * blk, (i + 1) * blk)
        assert np.abs(hd[:, r] - gram[:, r, r]).max() <= TOL * scale
        if (i + 1) * blk < nfd:
            q = slice((i + 1) * blk, (i + 2) * blk)
            assert np.abs(hu[:, r] - gram[:, r, q]).max() <= TOL * scale
    for o, b in zip(ours[:4], band[:4]):        # the same point otherwise
        np.testing.assert_array_equal(to_np(o), to_np(b))


@pytest.mark.parametrize("phr", [False, True])
def test_full_gram_real_system_against_pallas_interpret(real_calls, phr):
    a, k = [c for c in real_calls["eval"] if c[1]["phr"] == phr][-1]
    k = dict(k, band_block=0)
    ours = tk.ipm_eval_step_plain(*a, **k)
    ref = jk.ipm_eval_step(*(jnp.asarray(to_np(x)) for x in a),
                           interpret=True, **k)
    assert ours[4].shape == (8, 45, 45)
    _close(ours, ref, GRAM_OUT, tol=TOL_REAL)
    # outside the block-tridiagonal band the weighted Gram is exactly zero:
    # every constraint row touches one segment's two endpoint vertices
    gram = to_np(ours[4]).reshape(8, 3, 15, 3, 15)
    assert not gram[:, 0, :, 2].any() and not gram[:, 2, :, 0].any()


@pytest.mark.parametrize("n_iters,snap_iters", [(2, 0), (0, 1), (2, 1)])
def test_solve_fused_random_against_pallas_interpret(n_iters, snap_iters):
    """Random arrays with the final half-space plane present, four scenarios
    handed to the Pallas kernel as two blocks of two (its scenario blocking)
    and to the port as a flat batch of four, every scenario held to the
    JAX kernel.  The objective band is positive semidefinite, as a real
    one is, so no pivot of the float64 polish is floored and the floored
    factor computes the JAX kernel's function (an indefinite system, where
    the two part by design: test_floored_elimination_*)."""
    kw, ref, args = _fused_random_case(n_iters, snap_iters)
    assert args[0].shape == (4, 24, 512) and args[10].shape == (1, 1, 512)
    assert _rows_flooring_in_float64(args, kw) == []
    ours = tk.ipm_solve_fused(*args, **kw)
    # random systems are well conditioned: a margin of ten on the eval's
    # tolerance for the chain of steps
    _close(ours, ref, FUSED_OUT, tol=10 * TOL)
    assert (np.abs(to_np(ours[0]) - to_np(args[6])).max() > 0)


def _scaled_residual(y_fin, a, k):
    """(B,) max over real lanes of max(c, 0) at y_fin (scaled space)."""
    c = tk._c_lanes_k(tt(to_np(y_fin)), a[2], k["nb_p"], k["n_ball"])
    return to_np(torch.where(a[10] > 0, torch.clamp(c, min=0.0),
                             torch.zeros_like(c)).amax(dim=2)[:, 0])


@pytest.mark.parametrize("name", list(FUSED_CONFIGS))
def test_solve_fused_real_system_against_pallas_interpret(real_calls, name):
    cfg = FUSED_CONFIGS[name]
    a, k = [c for c in real_calls["fused"]
            if (c[1]["n_iters"], c[1]["snap_iters"])
            == (cfg["n_iters"], cfg["snap_iters"])][-1]
    assert a[0].shape == (8, 45, 384) and len(a) == 12
    ours = tk.ipm_solve_fused_plain(*a, **k)
    ref = jk.ipm_solve_fused(*(jnp.asarray(to_np(x)) for x in a),
                             interpret=True, **k)
    if cfg["n_iters"] <= 2:
        # the merit's |c + s| term cancels numbers of the slacks' size: four
        # float32 steps at that size as an absolute floor
        floors = {"best_merit": 4 * 2.0 ** -23 * float(ref[2].max())}
        _close(ours, ref, FUSED_OUT, tol=TOL_REAL, floors=floors)
    else:
        _close(ours[:2], ref[:2], FUSED_OUT[:2], tol=TOL_REAL)
        for o, r in zip(ours, ref):
            assert o.shape == r.shape and bool(torch.isfinite(o).all())
        r_o = _scaled_residual(ours[1], a, k)
        r_r = _scaled_residual(np.asarray(ref[1]), a, k)
        assert (r_o <= 3.0 * r_r + 5e-5).all(), (r_o, r_r)
    if cfg["n_iters"] == 0:
        # snap-only: the Newton state leaves as it came, no merit, no lam_mid
        np.testing.assert_array_equal(to_np(ours[2]), to_np(a[7]))
        np.testing.assert_array_equal(to_np(ours[3]), to_np(a[8]))
        np.testing.assert_array_equal(to_np(ours[4]), to_np(a[9]))
        assert np.isinf(to_np(ours[5])).all() and not to_np(ours[6]).any()
        np.testing.assert_array_equal(
            to_np(ours[7])[:, 0, 0], to_np(a[8] * (a[10] > 0)).max(axis=(1, 2)))
        assert (to_np(ours[0]) != to_np(a[6])).any()      # the snap moved it


def test_solve_fused_float32_against_float64(real_calls):
    """The plain polish in float32 lands in the float64 one's solution class:
    the best iterate within 2e-3 of scale, the residual of the final point
    within 3x plus 5e-5."""
    a, k = [c for c in real_calls["fused"] if c[1]["n_iters"] == 10][-1]
    o32 = tk.ipm_solve_fused_plain(*a, **k)
    o64 = tk.ipm_solve_fused_plain(*(x.double() for x in a), **k)
    assert all(o.dtype == torch.float64 for o in o64)
    _close(o32[:2], [to_np(o).astype(np.float32) for o in o64[:2]],
           FUSED_OUT[:2], tol=TOL_REAL)
    r32 = _scaled_residual(o32[1], a, k)
    r64 = _scaled_residual(o64[1].float(), a, k)
    assert (r32 <= 3.0 * r64 + 5e-5).all(), (r32, r64)
    # the wrapper is the plain version on host tensors, and counts nothing
    before = dict(tk.launches)
    via = tk.ipm_solve_fused(*a, **k)
    assert tk.launches == before
    for o, v in zip(o32, via):
        np.testing.assert_array_equal(to_np(o), to_np(v))


def test_solve_fused_nan_row_stays_frozen(real_calls):
    """A NaN linear term makes every Newton direction of that scenario NaN:
    its running point must stay at the start, every output finite, and no
    other scenario may change a bit -- in the plain version as in the Pallas
    kernel."""
    a, k = [c for c in real_calls["fused"]
            if (c[1]["n_iters"], c[1]["snap_iters"]) == (2, 1)][-1]
    clean = tk.ipm_solve_fused_plain(*a, **k)
    q = a[5].clone()
    q[3] = float("nan")
    bad_args = a[:5] + (q,) + a[6:]
    ours = tk.ipm_solve_fused_plain(*bad_args, **k)
    ref = jk.ipm_solve_fused(*(jnp.asarray(to_np(x)) for x in bad_args),
                             interpret=True, **k)
    _close(ours, ref, FUSED_OUT, tol=TOL_REAL)
    np.testing.assert_array_equal(to_np(ours[4])[3], to_np(a[9])[3])  # y_last
    np.testing.assert_array_equal(to_np(ours[3])[3], to_np(a[8])[3])  # lam
    assert all(np.isfinite(to_np(o)[3]).all() for o in ours)
    others = [i for i in range(8) if i != 3]
    for o, c in zip(ours, clean):
        np.testing.assert_array_equal(to_np(o)[others], to_np(c)[others])


def _spd_band_system(seed=12, f=np.float32):
    """A block-tridiagonal SPD system with a wide diagonal spread (the
    equilibration's case): (gram (B, nfd, nfd), its blocks gd, gu, zero
    objective blocks pe_d, pe_u, rhs, blk)."""
    rng = np.random.RandomState(seed)
    bsz, m_blk, blk = 3, 4, 5
    nfd = m_blk * blk
    rng.randn(bsz, blk, blk)       # the draw this test's system came after
    l = rng.randn(bsz, nfd, nfd) * (np.abs(np.subtract.outer(
        np.arange(nfd) // blk, np.arange(nfd) // blk)) <= 0)[None]
    dense = l @ l.transpose(0, 2, 1) + 0.5 * np.eye(nfd)
    sup = rng.randn(bsz, m_blk - 1, blk, blk) * 0.1
    scale = np.logspace(-2, 2, nfd)
    gram = np.zeros((bsz, nfd, nfd))
    for i in range(m_blk):
        sl = slice(i * blk, (i + 1) * blk)
        gram[:, sl, sl] = dense[:, sl, sl]
        if i + 1 < m_blk:
            sq = slice((i + 1) * blk, (i + 2) * blk)
            gram[:, sl, sq] = sup[:, i]
            gram[:, sq, sl] = sup[:, i].transpose(0, 2, 1)
    gram = (gram * scale[:, None] * scale[None, :]).astype(f)
    pe_d = np.zeros((bsz, m_blk, blk, blk), f)
    pe_u = np.zeros((bsz, m_blk - 1, blk, blk), f)
    rhs = rng.randn(bsz, nfd, 1).astype(f)
    g5 = gram.reshape(bsz, m_blk, blk, m_blk, blk)
    gd = np.stack([g5[:, i, :, i, :] for i in range(m_blk)], axis=1)
    gu = np.stack([g5[:, i, :, i + 1, :] for i in range(m_blk - 1)], axis=1)
    return gram, gd, gu, pe_d, pe_u, rhs, blk


def test_gauss_jordan_band_factor_against_reference():
    """The plain in-kernel factor (the floored block Cholesky, where the JAX
    kernel takes Gauss-Jordan inverses) against the JAX kernel's
    own band factor on an SPD system, where no pivot is floored: float32,
    the two factors' roundings apart."""
    gram, gd, gu, pe_d, pe_u, rhs, blk = _spd_band_system()
    ref = np.asarray(jk._band_factor_solve(
        jnp.asarray(gram), jnp.asarray(pe_d), jnp.asarray(pe_u), 1e-9,
        jnp.asarray(rhs), blk))
    ours = to_np(tk._band_factor_solve(tt(gd), tt(gu), tt(pe_d), tt(pe_u),
                                       1e-9, tt(rhs), blk))
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    # and it solves the system: residual against float64
    res = gram.astype(np.float64) @ ours.astype(np.float64) - rhs
    assert np.abs(res).max() <= 1e-3 * np.abs(rhs).max()


def test_floored_band_factor_against_reference_in_float64():
    """In float64 on an SPD system no pivot is floored: the floored block
    Cholesky is the exact solve to rounding (1e-10 of scale, against a dense
    float64 solve), and the JAX kernel's Gauss-Jordan factor given float64
    arrays lands within float32 rounding of it (its products are formed in
    float32: preferred_element_type)."""
    gram, gd, gu, pe_d, pe_u, rhs, blk = _spd_band_system(f=np.float64)
    h = gram + 1e-9 * np.eye(gram.shape[1])
    exact = np.linalg.solve(h, rhs)
    ours = to_np(tk._band_factor_solve(
        *(tt(a) for a in (gd, gu, pe_d, pe_u)), 1e-9, tt(rhs), blk))
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, exact, rtol=0,
                               atol=1e-10 * np.abs(exact).max())
    ref = np.asarray(jk._band_factor_solve(
        jnp.asarray(gram), jnp.asarray(pe_d), jnp.asarray(pe_u), 1e-9,
        jnp.asarray(rhs), blk))
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def _floored_cholesky_np(a, floor):
    """The floored Cholesky written out in NumPy for one matrix: L lower with
    L L^T = a + E, each pivot max(pivot, floor)."""
    n = a.shape[0]
    w, low = a.copy(), np.zeros_like(a)
    for k in range(n):
        low[k, k] = np.sqrt(max(w[k, k], floor))
        low[k + 1:, k] = w[k + 1:, k] / low[k, k]
        w[k + 1:, k + 1:] -= np.outer(low[k + 1:, k], low[k + 1:, k])
    return low


@pytest.mark.parametrize("case", ["spd", "indefinite"])
def test_floored_elimination_inverts_a_plus_a_nonnegative_diagonal(case):
    """``_floored_elimination(a, I)`` is L^-1 for the floored Cholesky L of
    a (L L^T = a + E, E >= 0 diagonal), against that Cholesky written out in
    NumPy, float64: E = 0 where every pivot clears the floor, and where one
    does not (here the last pivot of a unit-diagonal SPD matrix pushed to
    -0.01, as float32's noise leaves a near-singular pivot block a little
    indefinite), a + E is SPD, so a direction solved through it descends
    (rhs^T dx = |L^-1 rhs|^2 > 0) where the unfloored solve of the
    indefinite system ascends."""
    rng = np.random.RandomState(21)
    n = 6
    lam = np.array([1.6, 1.3, 1.0, 0.8, 0.5, 0.3])
    q = np.linalg.qr(rng.randn(2, n, n))[0]
    a = q @ (lam[None, :, None] * q.transpose(0, 2, 1))
    d = np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    a = a / d[:, :, None] / d[:, None, :]               # unit diagonal
    if case == "indefinite":
        last = np.linalg.cholesky(a)[:, -1, -1] ** 2    # the last pivot
        a[:, -1, -1] -= last + 0.01
    linv = to_np(tk._floored_elimination(tt(a), tt(np.broadcast_to(
        np.eye(n), a.shape).copy())))
    assert (np.triu(linv, 1) == 0).all()
    low = np.stack([_floored_cholesky_np(m, tk.PIVOT_FLOOR) for m in a])
    np.testing.assert_allclose(linv @ low, np.broadcast_to(np.eye(n),
                                                           a.shape),
                               rtol=0, atol=1e-10)
    e = low @ low.transpose(0, 2, 1) - a
    diag = np.diagonal(e, axis1=1, axis2=2)
    assert np.abs(e - np.stack([np.diag(x) for x in diag])).max() <= 1e-12
    assert (diag >= -1e-12).all()
    if case == "spd":
        assert np.abs(diag).max() <= 1e-12
        return
    assert (diag.max(axis=1) > tk.PIVOT_FLOOR).all()     # the floor bound
    rhs = np.linalg.eigh(a)[1][:, :, :1]   # along the negative curvature
    dx = linv.transpose(0, 2, 1) @ (linv @ rhs)
    assert (np.einsum("bni,bni->b", rhs, dx) > 0).all()
    exact = np.linalg.solve(a, rhs)
    assert (np.einsum("bni,bni->b", rhs, exact) < 0).all()


def test_nan_direction_freezes_its_own_row_only():
    """A NaN right-hand side gives a NaN direction: ``_max_step_k`` then
    returns a finite step (NaN < 0 is false), and it is the finite-direction
    gate that must stop the update -- for that scenario alone, in the plain
    version as in the Pallas kernel."""
    d, kw = _random_inputs(seed=8)
    clean, _ = _pipe_both(d, kw, "newton", "newton")
    d["rhs"] = d["rhs"].copy()
    d["rhs"][1] = np.nan
    ours, ref = _pipe_both(d, kw, "newton", "newton")
    _close(ours, ref, PIPE_OUT)
    x, s, lam, y = (to_np(o) for o in ours[:4])
    np.testing.assert_array_equal(x[1], d["x"][1])        # frozen
    np.testing.assert_array_equal(lam[1], d["lam"][1])
    assert all(np.isfinite(to_np(o)[1]).all() for o in ours[:6])
    for o, c in zip(ours, clean):                         # row 0 untouched
        np.testing.assert_array_equal(to_np(o)[0], to_np(c)[0])
    alpha = tk._max_step_k(tt(d["s"]), torch.full((2, 1, 512), float("nan")),
                           0.995)
    assert bool(torch.isfinite(alpha).all())
    # the snap line search rejects a NaN direction too
    snap, ref_s = _pipe_both(d, kw, "snap", "snap")
    _close(snap, ref_s, PIPE_OUT)
    np.testing.assert_array_equal(to_np(snap[4])[1], d["bx"][1])


def test_plain_versions_accept_float64():
    d, kw = _random_inputs(seed=9)
    a32 = mtt.lanes_state_from_numpy(d, device="cpu")
    a64 = mtt.lanes_state_from_numpy(d, device="cpu", dtype=torch.float64)
    o32 = tk.ipm_pipe_step_plain(*a32, upd_mode="newton", eval_mode="snap",
                                 **kw)
    o64 = tk.ipm_pipe_step_plain(*a64, upd_mode="newton", eval_mode="snap",
                                 **kw)
    assert all(o.dtype == torch.float64 for o in o64)
    _close(o32, [to_np(o).astype(np.float32) for o in o64], PIPE_OUT)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    d, kw = _random_inputs(seed=1)
    args = [tt(d[n]) for n in ("gt", "b", "rb", "x", "s", "lam")]
    # band_block=0 is the full-Gram form (it used to be refused)
    full = tk.ipm_eval_step(*args, nb_p=128, n_ball=17, band_block=0)
    assert len(full) == 5 and full[4].shape == (2, 24, 24)
    with pytest.raises(ValueError, match="negative"):
        tk.ipm_solve_fused(*([args[0]] * 12), nb_p=128, n_ball=17, mc=1,
                           n_iters=-1, snap_iters=0, sigma_min=0.3,
                           tau=0.995, alpha_max=1.0, w_cap=1e6, reg=1e-9,
                           snap_rho=1e4, blk=6)
    assert set(tk.launches) == {"gt_matvec", "ipm_eval_step",
                                "ipm_eval_step_gram", "ipm_pipe_step",
                                "ipm_solve_fused"}
    with pytest.raises(ValueError, match="modes"):
        tk.ipm_pipe_step(*mtt.lanes_state_from_numpy(d, device="cpu"),
                         upd_mode="newton", eval_mode="polish", **kw)
    before = dict(tk.launches)
    tk.gt_matvec(args[0], args[3])
    assert tk.launches == before           # host tensors: no kernel launch


@pytest.mark.gpu
def test_kernels_on_the_card_match_plain():
    """The three CUDA kernels against their plain versions on the card, on
    the recorded calls of a K=4 solve.  Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    d, kw = _random_inputs(seed=3)
    dev = mtt.lanes_state_from_numpy(d)
    for kernel in ("ipm_pipe_step", "ipm_eval_step"):   # at this shape
        assert tk.ipm_design(kernel, 24, 512, 6, 128) == "cluster"
    for upd, ev in MODE_PAIRS:
        before = tk.launches["ipm_pipe_step"]
        ours = tk.ipm_pipe_step(*dev, upd_mode=upd, eval_mode=ev, **kw)
        assert tk.launches["ipm_pipe_step"] == before + 1
        plain = tk.ipm_pipe_step_plain(*dev, upd_mode=upd, eval_mode=ev, **kw)
        _close(ours, [to_np(o) for o in plain], PIPE_OUT)
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    for phr in (False, True):
        ours = tk.ipm_eval_step(*ev_args, nb_p=128, n_ball=17, phr=phr,
                                w_cap=1e6, band_block=6)
        plain = tk.ipm_eval_step_plain(*ev_args, nb_p=128, n_ball=17,
                                       phr=phr, w_cap=1e6, band_block=6)
        _close(ours, [to_np(o) for o in plain], EVAL_OUT)
    _close((tk.gt_matvec(dev[0], dev[6]),),
           (to_np(tk.gt_matvec_plain(dev[0], dev[6])),), ("y",))


@pytest.mark.gpu
def test_new_kernels_on_the_card_match_plain(real_calls):
    """The full-Gram evaluation and the whole-polish kernel against their
    plain versions on the card.  Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    d, kw = _random_inputs(seed=3)
    dev = mtt.lanes_state_from_numpy(d)
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    before = tk.launches["ipm_eval_step_gram"]
    ours = tk.ipm_eval_step(*ev_args, nb_p=128, n_ball=17, w_cap=1e6,
                            band_block=0)
    assert tk.launches["ipm_eval_step_gram"] == before + 1
    plain = tk.ipm_eval_step_plain(*ev_args, nb_p=128, n_ball=17, w_cap=1e6,
                                   band_block=0)
    _close(ours, [to_np(o) for o in plain], GRAM_OUT)
    a, k = [c for c in real_calls["fused"]
            if (c[1]["n_iters"], c[1]["snap_iters"]) == (1, 0)][-1]
    a_dev = [x.cuda() for x in a]
    before = tk.launches["ipm_solve_fused"]
    ours = tk.ipm_solve_fused(*a_dev, **k)
    assert tk.launches["ipm_solve_fused"] == before + 1
    _close(ours, [to_np(o) for o in tk.ipm_solve_fused_plain(*a, **k)],
           FUSED_OUT, tol=TOL_REAL, flip_rows=1)
