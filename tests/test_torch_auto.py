"""The port's verdict router (``solver/auto.py``, tiers 0, 1 and 1.5) against
the JAX package's with ``tier2_f64=False``, on the fixture of
``tests/test_auto_fast.py`` (K=4, batch 8: generous corridors, two tight
ones, one structurally infeasible row) with its light configurations, and
the router's merge semantics on hand-made tier results.

Verdicts are discrete, and both routers branch on float32 violations against
a gate, so a verdict is compared only on rows whose violation (in either
package) is not within a factor 2 of the gate it is tested against; on this
fixture that leaves every row.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.solver import auto as jauto
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu.solver.ipm import IPMConfig as JIPM
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.solver import auto as tauto
from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes as tlanes

from torch_port_util import N, to_np, tt

K = 4
ADMM_KW = dict(rho=0.005, n_stages=1, n_iters=24, rho_tube_factor=0.125,
               rho_half_factor=0.125)
IPM_KW = dict(n_iters=8, snap_iters=2, sigma_min=0.3, corrector=False)
ESCALATED = [2, 3, 7]


@pytest.fixture(scope="module")
def small_batch():
    """8 scenarios: generous corridors (gate pass), tight ones (escalate),
    one structurally infeasible (escalate + certificate)."""
    rng = np.random.RandomState(11)
    b = 8
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, K + 1, 3)),
                          axis=1).astype(np.float32)
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    values = np.zeros((b, K + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = to_np(mtt.segment_times_nfabian(tt(waypoints), 3.0, 5.0))
    radii = np.full((b, K, 2), 0.8, dtype=np.float32)
    radii[2:4] = 0.1                       # tight: the 24-iter gate misses
    df = to_np(mtt.extract_fixed_values(ts, tt(values))).copy()
    df[7, 0, :] += 5.0                     # start 5 units off the corridor
    radii[7] = 0.05
    return ts, df, times, waypoints, radii, values


def _port_auto(batch, **kw):
    ts, df, times, waypoints, radii, values = batch
    kw.setdefault("ipm_config", mtt.IPMConfig(**IPM_KW))
    return mtt.solve_qcqp_auto(
        ts, df, times, waypoints, radii,
        admm_config=mtt.ADMMConfig(**ADMM_KW), warmstart_values=values,
        tier2_f64=False, device="cpu", **kw)


def test_router_verdicts_against_reference(small_batch):
    ts, df, times, waypoints, radii, values = small_batch
    js = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    ref = jauto.solve_qcqp_auto(
        js, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii),
        admm_config=jqcqp.ADMMConfig(use_pallas=False, **ADMM_KW),
        ipm_config=JIPM(**IPM_KW), warmstart_values=jnp.asarray(values),
        tier2_f64=False, interpret=True)
    res = _port_auto(small_batch)
    v_o = to_np(res.solution.max_violation)
    v_r = np.asarray(ref.solution.max_violation)

    def clear_of(gate):
        return np.array([not (gate / 2 < a < gate * 2 or
                              gate / 2 < b < gate * 2)
                         for a, b in zip(v_o, v_r)])

    # routing: tier 0 against the 1e-2 gate (escalated rows carry a later
    # tier's violation, which is far below it or far above)
    np.testing.assert_array_equal(res.escalated, ref.escalated)
    assert res.n_escalated == ref.n_escalated == len(ESCALATED)
    np.testing.assert_array_equal(np.nonzero(res.escalated)[0], ESCALATED)
    # verdicts: escalated rows against the 1e-4 strict gate
    sure = np.where(res.escalated, clear_of(1e-4), clear_of(1e-2))
    assert sure.sum() >= 7
    print("violations port", v_o, "reference", v_r, "verdicts", res.verdict,
          ref.verdict)
    # equal, except that a row the reference leaves open may be FEASIBLE here
    # when the port exhibits a point well under the gate (exhibition is a
    # proof; the port's Cholesky pivots are more accurate than the
    # reference's float32 matmul-only inverses and its endgame lands more
    # tight rows).  Never FEASIBLE against INFEASIBLE, never the reverse.
    for i in np.nonzero(sure)[0]:
        if res.verdict[i] != ref.verdict[i]:
            assert (ref.verdict[i] == jauto.UNDETERMINED
                    and res.verdict[i] == mtt.FEASIBLE
                    and v_o[i] < 0.5e-4), (i, res.verdict, ref.verdict)
    assert (res.verdict[sure] == ref.verdict[sure]).sum() >= sure.sum() - 1
    assert res.verdict.dtype == np.int8 and res.tier.dtype == np.int8
    assert (res.verdict[[0, 1, 4, 5, 6]] == mtt.FEASIBLE).all()
    assert res.verdict[7] == mtt.INFEASIBLE
    assert (res.verdict[2:4] != mtt.INFEASIBLE).all()
    assert (res.tier[~res.escalated] == 0).all()
    assert (res.tier[res.escalated] >= 1).all()
    # FEASIBLE by exhibition really exhibits
    feas = res.escalated & (res.verdict == mtt.FEASIBLE)
    assert (v_o[feas] < 1e-4).all()
    assert (v_o[~res.escalated] < 1e-2).all()
    # same answers where both landed the row in the same tier without a
    # restart (a restart's snap-repaired point is feasible but not unique:
    # its cost depends on the path)
    both = ((res.verdict == mtt.FEASIBLE) & (ref.verdict == jauto.FEASIBLE)
            & (res.tier == ref.tier) & (res.tier <= 1))
    assert both.sum() >= 5
    np.testing.assert_allclose(to_np(res.solution.cost)[both],
                               np.asarray(ref.solution.cost)[both],
                               rtol=2e-2)
    out = mtt.auto_result_to_numpy(res)
    assert out["n_escalated"] == 3 and out["solution"]["cost"].shape == (8,)
    np.testing.assert_array_equal(out["verdict"], res.verdict)


def test_all_three_verdict_codes(small_batch, monkeypatch):
    """A tier 1 cut to one Newton step and no restart chain leaves the tight
    rows open: +1, 0 and -1 all appear, and an open row is never called
    feasible."""
    monkeypatch.setattr(tauto, "RESTART_CONFIGS", ())
    res = _port_auto(small_batch, ipm_config=mtt.IPMConfig(
        n_iters=1, snap_iters=0, sigma_min=0.3, corrector=False))
    assert set(res.verdict.tolist()) == {1, 0, -1}
    v = to_np(res.solution.max_violation)
    assert (v[res.verdict == mtt.UNDETERMINED] >= 1e-4).all()
    assert (res.tier[res.escalated] == 1).all()


def test_merged_rows_are_each_tiers_own(small_batch):
    """Rows that pass the gate carry tier 0's solution bit for bit; escalated
    rows carry what the lanes IPM returns for exactly those rows from tier
    0's iterate and duals (tier 1 gathers the failing rows, nothing else)."""
    ts, df, times, waypoints, radii, values = small_batch
    a = mtt.solve_qcqp_batch(ts, df, times, waypoints, radii,
                             config=mtt.ADMMConfig(**ADMM_KW),
                             warmstart_values=values, device="cpu")
    res = _port_auto(small_batch)
    keep = ~res.escalated
    idx = np.nonzero(res.escalated)[0]
    pol = mtt.solve_qcqp_ipm_lanes(
        ts, df[idx], times[idx], waypoints[idx], radii[idx],
        config=mtt.IPMConfig(**IPM_KW), x0=a.d_free[idx],
        lam0_ball=a.dual_ball[idx], lam0_half=a.dual_half[idx], device="cpu")
    for name in mtt.QCQPSolution._fields:
        merged, tier0 = getattr(res.solution, name), getattr(a, name)
        if name == "infeasible":
            assert tier0 is None and merged is None
            continue
        np.testing.assert_array_equal(to_np(merged)[keep],
                                      to_np(tier0)[keep], err_msg=name)
        landed = res.tier[idx] == 1       # rows no restart touched
        np.testing.assert_array_equal(to_np(merged)[idx][landed],
                                      to_np(getattr(pol, name))[landed],
                                      err_msg=name)
    assert not np.array_equal(to_np(res.solution.d_free)[idx],
                              to_np(a.d_free)[idx])


def test_no_escalation_fast_path(small_batch):
    ts, df, times, waypoints, radii, values = small_batch
    df = to_np(mtt.extract_fixed_values(ts, tt(values)))
    wide = np.full_like(radii, 0.8)
    res = mtt.solve_qcqp_auto(
        ts, df, times, waypoints, wide, admm_config=mtt.ADMMConfig(**ADMM_KW),
        ipm_config=mtt.IPMConfig(**IPM_KW), warmstart_values=values,
        tier2_f64=False, device="cpu")
    assert res.n_escalated == 0 and not res.escalated.any()
    assert (res.verdict == mtt.FEASIBLE).all() and (res.tier == 0).all()
    assert res.solution.infeasible is None     # tier 0's own object


def test_speculative_restart_keeps_the_contract(small_batch):
    res0 = _port_auto(small_batch, tier1_spec=0)
    res2 = _port_auto(small_batch, tier1_spec=2)
    np.testing.assert_array_equal(res0.escalated, res2.escalated)
    assert (res2.verdict[[0, 1, 4, 5, 6]] == mtt.FEASIBLE).all()
    assert res2.verdict[7] == mtt.INFEASIBLE
    v0 = to_np(res0.solution.max_violation)
    v2 = to_np(res2.solution.max_violation)
    assert (v2[res2.escalated & (res2.verdict == mtt.FEASIBLE)] < 1e-4).all()
    # best-by-violation: the restarted slice can only improve on tier 1
    assert (v2[res2.escalated] <= v0[res0.escalated] + 1e-7).all() or \
        (res0.tier[res0.escalated] > 1).any()


class _FakeLanes:
    """Stands in for ``solve_qcqp_ipm_lanes``: returns, call after call, the
    hand-made (max_violation, infeasible) lists it was given, with every
    other field filled with the call's number -- so that a merged row says
    which call it came from."""

    def __init__(self, template, results):
        self.template, self.results, self.calls = template, results, []

    def __call__(self, structure, d_fixed, *args, **kw):
        n_call = len(self.calls) + 1
        viol, inf = self.results[len(self.calls)]
        rows = d_fixed.shape[0]
        assert rows == len(viol), (n_call, rows, viol)
        self.calls.append(dict(rows=rows, config=kw["config"],
                               x0=kw["x0"].clone()))
        fields = {}
        for name in mtt.QCQPSolution._fields:
            if name == "infeasible":
                fields[name] = torch.tensor(inf)
            elif name == "max_violation":
                fields[name] = torch.tensor(viol, dtype=torch.float32)
            else:
                t = getattr(self.template, name)
                fields[name] = torch.full((rows,) + t.shape[1:],
                                          float(n_call)).to(t.dtype)
        return mtt.QCQPSolution(**fields)


def test_merge_semantics_on_hand_made_tier_results(small_batch, monkeypatch):
    """Certificate replaces, violation merges by minimum, solution rows merge
    best-by-violation -- through the speculative restart and the chain, on
    fabricated tier results (escalated rows 2, 3, 7 -> positions 0, 1, 2).

    call 1, tier 1:        viol [0.5, 0.3, 2e-5]  cert [True, False, False]
    call 2, speculative restart on the two worst (positions 0, 1, by topk):
                           viol [0.7, 1e-5]       cert [False, True]
      position 0: worse -> keeps call 1's row; its certificate is REPLACED by
                  the restart's False, so the row is open again;
      position 1: better -> takes call 2's row; certified by the restart, but
                  exhibition outranks a certificate: FEASIBLE.
    call 3, chain restart #1 on position 0 alone (the only open row):
                           viol [0.6]             cert [True]
      worse than 0.5 -> row stays call 1's, t1_viol stays min = 0.5, the
      certificate is replaced by True: INFEASIBLE, and restart #2 has nothing
      left to run on.
    """
    ts, df, times, waypoints, radii, values = small_batch
    a = mtt.solve_qcqp_batch(ts, df, times, waypoints, radii,
                             config=mtt.ADMMConfig(**ADMM_KW),
                             warmstart_values=values, device="cpu")
    fake = _FakeLanes(a, [([0.5, 0.3, 2e-5], [True, False, False]),
                          ([0.7, 1e-5], [False, True]),
                          ([0.6], [True])])
    monkeypatch.setattr(tlanes, "solve_qcqp_ipm_lanes", fake)
    res = _port_auto(small_batch, tier1_spec=2)
    assert [c["rows"] for c in fake.calls] == [3, 2, 1]
    assert fake.calls[1]["config"] == tauto.RESTART_CONFIGS[0]
    assert fake.calls[2]["config"] == tauto.RESTART_CONFIGS[0]
    # the restarts warm-start from the best iterate so far: call 1's rows
    assert (fake.calls[1]["x0"] == 1.0).all()
    assert (fake.calls[2]["x0"] == 1.0).all()
    np.testing.assert_array_equal(res.verdict[ESCALATED],
                                  [mtt.INFEASIBLE, mtt.FEASIBLE,
                                   mtt.FEASIBLE])
    np.testing.assert_array_equal(res.tier[ESCALATED], [2, 1, 1])
    d_free = to_np(res.solution.d_free)
    assert (d_free[2] == 1.0).all()        # call 1's row survived two worse
    assert (d_free[3] == 2.0).all()        # the speculative restart's row
    assert (d_free[7] == 1.0).all()
    np.testing.assert_allclose(to_np(res.solution.max_violation)[ESCALATED],
                               [0.5, 1e-5, 2e-5], rtol=1e-6)
    assert res.solution.infeasible is None   # tier 0 (ADMM) has none to merge
    # rows that passed the gate are tier 0's, untouched by any fake
    np.testing.assert_array_equal(to_np(res.solution.d_free)[0],
                                  to_np(a.d_free)[0])


def test_chain_on_seeded_state_touches_only_open_rows(small_batch,
                                                      monkeypatch):
    """``_run_tier15_chain`` on hand-made per-row state with sentinels: a row
    under the gate and a certified row are left exactly as seeded (no min, no
    replacement, no tier mark, no solve); the open row goes through both
    restarts: violation merged by minimum, certificate replaced by the latest
    restart's, solution row taken from the restart that improved it."""
    ts, df, times, waypoints, radii, values = small_batch
    a = mtt.solve_qcqp_batch(ts, df, times, waypoints, radii,
                             config=mtt.ADMMConfig(**ADMM_KW),
                             warmstart_values=values, device="cpu")
    a = a._replace(infeasible=torch.zeros(8, dtype=torch.bool))
    a_mask = tuple(f is not None for f in a)
    fields = [f for f in a]
    pos = tauto._sel_positions(a_mask)
    assert fields[pos["max_violation"]] is a.max_violation
    fields[pos["max_violation"]] = torch.full((8,), 0.25)
    fake = _FakeLanes(a, [([0.125], [False]), ([0.5], [True])])
    monkeypatch.setattr(tlanes, "solve_qcqp_ipm_lanes", fake)
    idx = np.array(ESCALATED)
    t1_viol = np.array([0.25, 7.7e-5, 0.9], np.float32)     # sentinels
    t1_inf = np.array([False, False, True])
    mark = np.array([1, 1, 1], np.int8)
    d32, t32, w32, r32 = (tt(x) for x in (df, times, waypoints, radii))
    merged = tauto._run_tier15_chain(ts, d32, t32, w32, r32, idx, t1_viol,
                                     t1_inf, fields, a_mask, 1e-4,
                                     tier_mark=mark)
    # restart #1 lands 0.125: better, so its row is taken, but still open
    # (>= gate, no certificate), so restart #2 runs on it, from restart #1's
    # iterate; it comes back worse (0.5) and certified
    assert [c["rows"] for c in fake.calls] == [1, 1]
    assert [c["config"] for c in fake.calls] == list(tauto.RESTART_CONFIGS)
    np.testing.assert_array_equal(fake.calls[0]["x0"], a.d_free[2:3])
    assert (fake.calls[1]["x0"] == 1.0).all()
    np.testing.assert_array_equal(
        t1_viol, np.array([0.125, 7.7e-5, 0.9], np.float32))  # min, not last
    np.testing.assert_array_equal(t1_inf, [True, False, True])  # replaced
    np.testing.assert_array_equal(mark, [3, 1, 1])
    d_free = to_np(merged[pos["d_free"]])
    assert (d_free[2] == 1.0).all()          # kept the better restart's row
    np.testing.assert_allclose(to_np(merged[pos["max_violation"]])[2], 0.125)
    np.testing.assert_array_equal(d_free[3], to_np(a.d_free)[3])
    np.testing.assert_array_equal(d_free[7], to_np(a.d_free)[7])


def test_tier2_raises_before_any_work(small_batch):
    ts, df, times, waypoints, radii, values = small_batch
    for fn in (mtt.solve_qcqp_auto, mtt.solve_qcqp_strict):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(ts, df, times, waypoints, radii, warmstart_values=values)
        with pytest.raises(NotImplementedError, match="tier2_f64=False"):
            fn(ts, df, times, waypoints, radii, device="cpu",
               tier2_f64=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mtt.solve_qcqp_strict(ts, df, times, waypoints, radii,
                                  tier2_f64=False)


def test_strict_entry_point_defaults(small_batch):
    """``solve_qcqp_strict``: gate 1e-4 for both gates, two snap sweeps in
    tier 0, it6 + speculative restart; every FEASIBLE row exhibits < 1e-4."""
    ts, df, times, waypoints, radii, values = small_batch
    res = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii,
                                warmstart_values=values, tier2_f64=False,
                                device="cpu")
    v = to_np(res.solution.max_violation)
    assert (v[res.verdict == mtt.FEASIBLE] < 1e-4).all()
    assert (res.verdict[:7] == mtt.FEASIBLE).all()
    assert res.verdict[7] == mtt.INFEASIBLE and res.escalated[7]
    assert (v[~res.escalated] < 1e-4).all()
    assert res.solution.coefficients.shape == (8, K, N, 3)
    import inspect
    sig = inspect.signature(mtt.solve_qcqp_strict).parameters
    assert sig["tier2_f64"].default is True and sig["tier1_spec"].default == 128
    sig = inspect.signature(mtt.solve_qcqp_auto).parameters
    assert (sig["gate"].default, sig["strict_gate"].default,
            sig["tier0_snap"].default, sig["tier1_spec"].default,
            sig["tier2_f64"].default) == (1e-2, 1e-4, 0, 0, True)


def test_topk_picks_the_worst_rows_on_distinct_values():
    v = np.array([3e-4, 9e-3, 2e-5, 4e-2, 1e-3, 7e-4], np.float32)
    ours = to_np(torch.topk(tt(v), 3).indices)
    import jax
    ref = np.asarray(jax.lax.top_k(jnp.asarray(v), 3)[1])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [3, 1, 4])


@pytest.mark.gpu
def test_strict_on_the_card_matches_host(small_batch):
    """The strict router through the CUDA kernels against the host run.
    Needs an NVIDIA card and nvcc; skipped on hosts without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    ts, df, times, waypoints, radii, values = small_batch
    kw = dict(warmstart_values=values, tier2_f64=False)
    host = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii,
                                 device="cpu", **kw)
    before = dict(ipm_kernel.launches)
    card = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii, **kw)
    assert all(ipm_kernel.launches[n] > before[n] for n in before)
    v_h = to_np(host.solution.max_violation)
    v_c = to_np(card.solution.max_violation)
    sure = ~(((v_h > 5e-5) & (v_h < 2e-4)) | ((v_c > 5e-5) & (v_c < 2e-4)))
    np.testing.assert_array_equal(card.verdict[sure], host.verdict[sure])
    assert (v_c[card.verdict == mtt.FEASIBLE] < 1e-4).all()
    assert card.verdict[7] == mtt.INFEASIBLE
