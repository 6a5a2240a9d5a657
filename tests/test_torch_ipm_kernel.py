"""The plain PyTorch versions of the three interior-point kernels
(``ipm_eval_step`` with band output, ``ipm_pipe_step``, ``gt_matvec``) against
the JAX package's Pallas kernels run in interpret mode, one call each, on the
same float32 arrays: random arrays at the shapes of
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
    calls = {"pipe": [], "eval": [], "mv": []}
    kept = {n: getattr(tk, n) for n in ("ipm_pipe_step", "ipm_eval_step",
                                        "gt_matvec")}

    def rec(name, key):
        def wrapper(*a, **k):
            calls[key].append((a, k))
            return kept[name](*a, **k)
        return wrapper

    tk.ipm_pipe_step = rec("ipm_pipe_step", "pipe")
    tk.ipm_eval_step = rec("ipm_eval_step", "eval")
    tk.gt_matvec = rec("gt_matvec", "mv")
    try:
        for cfg in (dict(n_iters=0, snap_iters=2, pipelined=True),
                    dict(n_iters=3, snap_iters=1, pipelined=True),
                    dict(n_iters=2, snap_iters=0, pipelined=True),
                    dict(n_iters=2, snap_iters=1)):
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
    with pytest.raises(NotImplementedError, match="kernel 10"):
        tk.ipm_eval_step(*args, nb_p=128, n_ball=17, band_block=0)
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
