"""The port's verdict router (``solver/auto.py``, tiers 0, 1, 1.5 and the
float64 tier 2) against the JAX package's, on the fixture of
``tests/test_auto_fast.py`` (K=4, batch 8: generous corridors, two tight
ones, one structurally infeasible row) with its light configurations, and
the router's merge semantics on hand-made tier results.

Verdicts are discrete, and both routers branch on float32 violations against
a gate, so a verdict is compared only on rows whose violation (in either
package) is not within a factor 2 of the gate it is tested against; on this
fixture that leaves every row.  With tier 2 on, every row must end
determinate in both packages, and the float64 rows are held to the gate by a
wide margin (violations of 1e-9 to 1e-14 against 1e-4).
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
from mav_tube_trajectory_generation_tpu_torch.solver import ipm as tipm
from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes as tlanes

from torch_port_util import N, router_batch, to_np, tt

K = 4
ADMM_KW = dict(rho=0.005, n_stages=1, n_iters=24, rho_tube_factor=0.125,
               rho_half_factor=0.125)
IPM_KW = dict(n_iters=8, snap_iters=2, sigma_min=0.3, corrector=False)
ESCALATED = [2, 3, 7]


@pytest.fixture(scope="module")
def small_batch():
    """8 scenarios: generous corridors (gate pass), tight ones (escalate),
    one structurally infeasible (escalate + certificate)."""
    return router_batch()


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
    """The float64 tier is there: the entry points run with their defaults
    (``tier2_f64=True``) and no longer raise NotImplementedError.  What still
    raises before any work is a missing card with ``device=None``."""
    ts, df, times, waypoints, radii, values = small_batch
    assert not hasattr(tauto, "_TIER2_MESSAGE")
    res = mtt.solve_qcqp_auto(
        ts, df, times, waypoints, radii,
        admm_config=mtt.ADMMConfig(**ADMM_KW),
        ipm_config=mtt.IPMConfig(**IPM_KW), warmstart_values=values,
        device="cpu")
    assert (res.verdict != mtt.UNDETERMINED).all()
    if not torch.cuda.is_available():
        for fn in (mtt.solve_qcqp_auto, mtt.solve_qcqp_strict):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(ts, df, times, waypoints, radii, warmstart_values=values)


def _tier0(batch):
    ts, df, times, waypoints, radii, values = batch
    return mtt.solve_qcqp_batch(ts, df, times, waypoints, radii,
                                config=mtt.ADMMConfig(**ADMM_KW),
                                warmstart_values=values, device="cpu")


def _jax_tier0(batch):
    ts, df, times, waypoints, radii, values = batch
    js = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    a = jqcqp.solve_qcqp_batch(
        js, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii),
        config=jqcqp.ADMMConfig(use_pallas=False, **ADMM_KW),
        warmstart_values=jnp.asarray(values), scenario_block=4)
    return js, a


def test_tier2_f64_tiny_fast(small_batch):
    """Tier-2 semantics on a two-row residue, as
    tests/test_auto_fast.py::test_tier2_f64_tiny_fast asks them of the
    reference, and against the reference on the same fabricated state:
    exhibition outranks a certificate, and the float64 certificate replaces
    the float32 one."""
    ts, df, times, waypoints, radii, values = small_batch
    # both packages start tier 2 from the reference's tier-0 solution
    js, ja = _jax_tier0(small_batch)
    a = mtt.solution_from_numpy(ja, device="cpu")
    assert a.infeasible is None and a.cost.dtype == torch.float32
    np.testing.assert_array_equal(to_np(a.d_free), np.asarray(ja.d_free))
    a_mask = tuple(af is not None for af in a)
    a_fields = [af for m, af in zip(a_mask, a) if m]
    # Row 2: tight (r = 0.1) but feasible; row 7: structurally infeasible.
    # Both forced into tier 2; row 2 carries a false float32 certificate.
    idx = np.array([2, 7])
    t1_viol = np.array([1.0, 1.0], np.float32)
    t1_inf = np.array([True, False])
    merged, stage_rows = tauto._run_tier2_f64(
        ts, df, times, waypoints, radii, idx, t1_viol, t1_inf, a_fields,
        a_mask, 1e-4, device="cpu")
    assert t1_viol[0] < 1e-4, t1_viol
    assert not t1_inf[0], "a false float32 certificate must not survive"
    assert t1_inf[1], (t1_viol, t1_inf)
    pos = tauto._sel_positions(a_mask)
    assert float(merged[pos["max_violation"]][2]) < 1e-4
    assert all(m.dtype == f.dtype for m, f in zip(merged, a_fields))
    # stage 0 takes both rows; the feasible one lands there, the certified
    # one goes through stage 1 as well (a certificate can false-fire where a
    # longer run exhibits a point) and then rests: restarts are for
    # undetermined rows only
    assert stage_rows == [2, 1]
    # rows of the batch that were not handed over are not touched
    others = [0, 1, 3, 4, 5, 6]
    for m, f in zip(merged, a_fields):
        np.testing.assert_array_equal(to_np(m)[others], to_np(f)[others])

    j_mask = tuple(af is not None for af in ja)
    j_fields = [jnp.asarray(af) for m, af in zip(j_mask, ja) if m]
    j_viol = np.array([1.0, 1.0], np.float32)
    j_inf = np.array([True, False])
    j_merged = jauto._run_tier2_f64(
        js, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), idx, j_viol, j_inf, j_fields, j_mask,
        tuple(af.dtype.name for af in j_fields), 1e-4)
    np.testing.assert_array_equal(t1_inf, j_inf)
    assert j_viol[0] < 1e-6 and t1_viol[0] < 1e-6       # float64 points
    np.testing.assert_allclose(t1_viol[1], j_viol[1], rtol=1e-5)
    j_pos = jauto._sel_positions(j_mask)
    # the float64 optimum of the feasible row: the same point in both
    np.testing.assert_allclose(
        to_np(merged[pos["d_free"]])[2],
        np.asarray(j_merged[j_pos["d_free"]])[2], rtol=0,
        atol=1e-4 * np.abs(np.asarray(j_merged[j_pos["d_free"]])[2]).max())


def test_tier2_optimality_repair_chain_landed(small_batch):
    """A row the float32 restart chain landed (feasible by exhibition but
    possibly far from optimal, tier_mark 2 or 3) joins the float64 stages
    anyway, and the float64 interior-point iterate replaces the repaired
    point once it is strictly feasible.  Without the chain mark the same
    feasible row is left untouched.  The per-row state is seeded with
    sentinels (a violation just under the gate, a certificate that is not
    true), so that the write-back itself is what the asserts see."""
    ts, df, times, waypoints, radii, values = small_batch
    a = _tier0(small_batch)
    a_mask = tuple(af is not None for af in a)
    pos = tauto._sel_positions(a_mask)
    sel = [i for i, m in enumerate(a_mask) if m]
    pos["cost"] = sel.index(mtt.QCQPSolution._fields.index("cost"))
    row = 2                     # tight (r = 0.1) but feasible corridor

    def fabricate():
        """Merged fields with row 2 feasible by exhibition but carrying a
        cost inflated ten times (a snap-repaired exhibit)."""
        fields = [af.clone() for m, af in zip(a_mask, a) if m]
        fields[pos["cost"]][row] *= 10.0
        fields[pos["max_violation"]][row] = 9.0e-5
        return fields

    args = (ts, df, times, waypoints, radii, np.array([row]))
    inflated = float(fabricate()[pos["cost"]][row])

    # No chain mark: the feasible row never enters tier 2.
    t1_viol = np.array([9.0e-5], np.float32)
    t1_inf = np.array([True])                           # sentinel
    kept, stage_rows = tauto._run_tier2_f64(
        *args, t1_viol, t1_inf, fabricate(), a_mask, 1e-4, device="cpu")
    assert float(kept[pos["cost"]][row]) == inflated
    assert stage_rows == [] and t1_inf[0] and t1_viol[0] == np.float32(9e-5)
    mark = np.array([1], np.int8)
    _, stage_rows = tauto._run_tier2_f64(
        *args, t1_viol, t1_inf, fabricate(), a_mask, 1e-4, tier_mark=mark,
        device="cpu")
    assert stage_rows == [] and mark[0] == 1

    # Chain mark (tier_mark 2 = restart #1): the row joins stage 0 and the
    # near-optimal float64 point replaces the repaired one.
    mark = np.array([2], np.int8)
    merged, stage_rows = tauto._run_tier2_f64(
        *args, t1_viol, t1_inf, fabricate(), a_mask, 1e-4, tier_mark=mark,
        device="cpu")
    assert stage_rows == [1]                 # landed at once: no later stage
    assert float(merged[pos["cost"]][row]) < 0.5 * inflated
    assert float(merged[pos["max_violation"]][row]) < 1e-6
    # the running minimum took the float64 violation, the certificate was
    # replaced by the float64 solve's, the row is float64-landed
    assert t1_viol[0] < 1e-6 and not t1_inf[0] and mark[0] == 4


class _FakeRows:
    """Stands in for the float64 row solvers of ``solver.ipm``: returns,
    stage after stage, the hand-made (max_violation, infeasible) lists it was
    given, with every other field filled with the stage's iteration count --
    so that a merged row says which stage it came from."""

    def __init__(self, template, results):
        self.template, self.results, self.calls = template, results, []

    def _answer(self, d_fixed, cfg, x0):
        viol, inf = self.results[len(self.calls)]
        rows = d_fixed.shape[0]
        assert rows == len(viol), (len(self.calls), rows, viol)
        assert d_fixed.dtype == torch.float64
        self.calls.append(dict(rows=rows, n_iters=cfg.n_iters,
                               x0=None if x0 is None else x0.clone()))
        fields = {}
        for name in mtt.QCQPSolution._fields:
            if name == "infeasible":
                fields[name] = torch.tensor(inf)
            elif name == "max_violation":
                fields[name] = torch.tensor(viol, dtype=torch.float64)
            else:
                t = getattr(self.template, name)
                fields[name] = torch.full((rows,) + t.shape[1:],
                                          float(cfg.n_iters),
                                          dtype=torch.float64)
        return mtt.QCQPSolution(**fields)

    def polished(self, structure, d_fixed, *args, ipm_config=None, **kw):
        return self._answer(d_fixed, ipm_config, None)

    def restart(self, structure, d_fixed, *args, config=None, x0=None,
                lam0_ball=None, lam0_half=None):
        assert lam0_ball.shape[0] == lam0_half.shape[0] == d_fixed.shape[0]
        return self._answer(d_fixed, config, x0)


def test_tier2_stage_semantics_on_hand_made_results(small_batch,
                                                    monkeypatch):
    """Which rows enter which stage, and what is merged, on fabricated
    float64 results (escalated rows 2, 3, 5, 7 -> positions 0..3):

      position 0: undetermined (0.5); 1: certified by float32 (0.3, True);
      2: landed by the restart chain (5e-5, tier_mark 2): pending;
      3: landed by tier 1 (2e-5): never touched.

    stage 0 (30 it) takes 0, 1, 2:  viol [0.4, 0.2, 3e-4]  cert [F, T, F]
    stage 1 (120)   takes 0, 1, 2 (certified rows included, pending rides):
                                    viol [0.45, 1e-5, 2e-4] cert [T, F, F]
      0: worse than 0.4 -> keeps stage 0's row, minimum stays 0.4, the
         certificate is replaced by True: it rests from here on;
      1: under the gate -> takes stage 1's row, FEASIBLE;
      2: still not under the gate in float64 -> the float32 exhibit stays.
    stage 2 (60, restart) takes 2 alone, warm-started from its best float64
      iterate (stage 1's, 2e-4 < 3e-4):  viol [5e-6]  cert [F]
      -> the float64 row replaces the repaired one, pending is cleared.
    stage 3 has nothing left.
    """
    ts, df, times, waypoints, radii, values = small_batch
    a = _tier0(small_batch)
    a = a._replace(infeasible=torch.zeros(8, dtype=torch.bool))
    a_mask = tuple(f is not None for f in a)
    pos = tauto._sel_positions(a_mask)
    idx = np.array([2, 3, 5, 7])
    t1_viol = np.array([0.5, 0.3, 5e-5, 2e-5], np.float32)
    t1_inf = np.array([False, True, False, False])
    mark = np.array([1, 1, 2, 1], np.int8)
    fields = [f.clone() for f in a]
    fields[pos["max_violation"]][idx] = torch.tensor(t1_viol)
    fake = _FakeRows(a, [([0.4, 0.2, 3e-4], [False, True, False]),
                         ([0.45, 1e-5, 2e-4], [True, False, False]),
                         ([5e-6], [False])])
    monkeypatch.setattr(tipm, "_solve_qcqp_polished_rows", fake.polished)
    monkeypatch.setattr(tipm, "_solve_qcqp_ipm_rows", fake.restart)
    merged, stage_rows = tauto._run_tier2_f64(
        ts, df, times, waypoints, radii, idx, t1_viol, t1_inf, fields,
        a_mask, 1e-4, tier_mark=mark, device="cpu")
    assert stage_rows == [3, 3, 1]
    assert [c["n_iters"] for c in fake.calls] == [30, 120, 60]
    assert fake.calls[0]["x0"] is None and fake.calls[1]["x0"] is None
    assert (fake.calls[2]["x0"] == 120.0).all()        # best float64 iterate
    np.testing.assert_allclose(t1_viol, [0.4, 1e-5, 5e-6, 2e-5], rtol=1e-6)
    np.testing.assert_array_equal(t1_inf, [True, False, False, False])
    np.testing.assert_array_equal(mark, [4, 4, 4, 1])
    d_free = to_np(merged[pos["d_free"]])
    assert (d_free[2] == 30.0).all()         # stage 0's row survived a worse
    assert (d_free[3] == 120.0).all()
    assert (d_free[5] == 60.0).all()
    np.testing.assert_array_equal(d_free[7], to_np(a.d_free)[7])
    np.testing.assert_allclose(to_np(merged[pos["max_violation"]])[idx],
                               [0.4, 1e-5, 5e-6, 2e-5], rtol=1e-6)
    assert merged[pos["d_free"]].dtype == a.d_free.dtype    # float32 kept
    verdict = np.where(t1_viol < 1e-4, 1, np.where(t1_inf, -1, 0))
    np.testing.assert_array_equal(verdict, [-1, 1, 1, 1])


def test_tier2_chunks_give_what_one_batch_gives(small_batch, monkeypatch):
    """Rows are independent: solving the residue one row at a time
    (``TIER2_CHUNK_ROWS = 1``) gives the verdict data and the merged rows of
    one batch: 1e-3 of each field's scale on the feasible rows (measured
    8e-5 in the coefficients: once the merit is at rounding level, which of
    the last iterates is "best" is decided by noise)."""
    ts, df, times, waypoints, radii, values = small_batch
    a = _tier0(small_batch)
    a_mask = tuple(af is not None for af in a)
    idx = np.array([2, 3, 7])
    outs = []
    for chunk in (512, 1):
        monkeypatch.setattr(tauto, "TIER2_CHUNK_ROWS", chunk)
        viol = np.array([1.0, 1.0, 1.0], np.float32)
        inf = np.array([False, False, False])
        merged, rows = tauto._run_tier2_f64(
            ts, df, times, waypoints, radii, idx, viol, inf,
            [af for m, af in zip(a_mask, a) if m], a_mask, 1e-4,
            device="cpu")
        outs.append((viol, inf, rows, merged))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][1], [False, False, True])
    assert outs[0][2] == outs[1][2]
    assert (outs[0][0][:2] < 1e-6).all() and (outs[1][0][:2] < 1e-6).all()
    # the feasible rows end at the same optimum (the infeasible row's
    # iterate diverges, and 150 steps amplify the rounding of a batched
    # against a single factorization: its certificate is what is compared)
    feas = [0, 1, 2, 3, 4, 5, 6]
    for m0, m1 in zip(outs[0][3], outs[1][3]):
        if m0.dtype.is_floating_point:
            np.testing.assert_allclose(
                to_np(m0)[feas], to_np(m1)[feas], rtol=0,
                atol=1e-3 * max(1e-30, float(m0[feas].abs().max())))


@pytest.fixture(scope="module")
def strict_both(small_batch):
    """Both routers with tier 2 on, both gates at 1e-4, the light
    configurations (the call of
    tests/test_auto_fast.py::test_strict_determinacy_contract)."""
    ts, df, times, waypoints, radii, values = small_batch
    js = jsm.make_structure(jsm.free_interior_mask(K + 1, N), 3, N)
    ref = jauto.solve_qcqp_auto(
        js, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii),
        admm_config=jqcqp.ADMMConfig(use_pallas=False, **ADMM_KW),
        ipm_config=JIPM(**IPM_KW), warmstart_values=jnp.asarray(values),
        gate=1e-4, strict_gate=1e-4, tier2_f64=True, interpret=True)
    res = mtt.solve_qcqp_auto(
        ts, df, times, waypoints, radii,
        admm_config=mtt.ADMMConfig(**ADMM_KW),
        ipm_config=mtt.IPMConfig(**IPM_KW), warmstart_values=values,
        gate=1e-4, strict_gate=1e-4, device="cpu")
    return res, ref


def test_strict_determinacy_contract(strict_both):
    """With tier 2 on (the default) every verdict is determinate (+1 / -1,
    never 0): the contract the strict entry point ships."""
    res, _ = strict_both
    assert (res.verdict != mtt.UNDETERMINED).all(), res.verdict
    v = to_np(res.solution.max_violation)
    assert (v[res.verdict == mtt.FEASIBLE] < 1e-4).all()
    assert res.verdict[7] == mtt.INFEASIBLE
    assert (res.verdict[:7] == mtt.FEASIBLE).all()
    assert res.tier[7] == 4                 # certified rows go through tier 2
    assert res.solution.cost.dtype == torch.float32


def test_router_with_tier2_against_reference(strict_both):
    """Verdict and last tier row by row, and what FEASIBLE exhibits."""
    res, ref = strict_both
    v_o = to_np(res.solution.max_violation)
    v_r = np.asarray(ref.solution.max_violation)
    print("port", res.verdict, res.tier, v_o, "reference", ref.verdict,
          ref.tier, v_r)
    assert (ref.verdict != jauto.UNDETERMINED).all()
    np.testing.assert_array_equal(res.verdict, ref.verdict)
    np.testing.assert_array_equal(res.escalated, ref.escalated)
    # the last tier that re-ran a row: equal, except that a row within a
    # factor 2 of the gate after a float32 tier (in either package) may be
    # landed one tier earlier or later
    differs = res.tier != ref.tier
    assert differs.sum() <= 1, (res.tier, ref.tier)
    assert (v_o[res.verdict == mtt.FEASIBLE] < 1e-4).all()
    assert (v_r[ref.verdict == jauto.FEASIBLE] < 1e-4).all()
    # rows the float64 tier landed in both are the same optimum
    both = (res.tier == 4) & (ref.tier == 4) & (res.verdict == mtt.FEASIBLE)
    if both.any():
        np.testing.assert_allclose(to_np(res.solution.cost)[both],
                                   np.asarray(ref.solution.cost)[both],
                                   rtol=1e-4)


def test_strict_entry_point_defaults(small_batch):
    """``solve_qcqp_strict``: gate 1e-4 for both gates, two snap sweeps in
    tier 0, it6 + speculative restart; every FEASIBLE row exhibits < 1e-4."""
    ts, df, times, waypoints, radii, values = small_batch
    res = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii,
                                warmstart_values=values, device="cpu")
    v = to_np(res.solution.max_violation)
    assert (res.verdict != mtt.UNDETERMINED).all()
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
    kw = dict(warmstart_values=values)        # the defaults: tier 2 on
    host = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii,
                                 device="cpu", **kw)
    before = dict(ipm_kernel.launches)
    card = mtt.solve_qcqp_strict(ts, df, times, waypoints, radii, **kw)
    assert all(ipm_kernel.launches[n] > before[n]
               for n in ("gt_matvec", "ipm_eval_step", "ipm_pipe_step"))
    assert (card.verdict != mtt.UNDETERMINED).all()
    v_h = to_np(host.solution.max_violation)
    v_c = to_np(card.solution.max_violation)
    sure = ~(((v_h > 5e-5) & (v_h < 2e-4)) | ((v_c > 5e-5) & (v_c < 2e-4)))
    np.testing.assert_array_equal(card.verdict[sure], host.verdict[sure])
    assert (v_c[card.verdict == mtt.FEASIBLE] < 1e-4).all()
    assert card.verdict[7] == mtt.INFEASIBLE
