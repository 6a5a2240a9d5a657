"""The port's scenario-parallel layer (``parallel/mesh.py``, the sharded
strict router ``solve_qcqp_strict_sharded`` and ``dryrun_multichip``) against
the JAX package's on the same seeded NumPy inputs.

The port's ranks are gloo child processes on the CPU
(``tests/torch_sharded_worker.py``: they cannot import JAX), meeting through
a file store in the test's temporary directory; each child has a timeout of
its own and is killed when it expires.  The JAX side runs on two devices of
the conftest's virtual CPU mesh.  Each rank solves its own contiguous block
of the batch; the tests concatenate the ranks' rows in rank order.

Tolerances: the linear solve to rtol 1e-9 / atol 1e-10 (float64, the same
sums), the world of one against the world of two to 1e-12; the QCQP in
float64 to 1e-6 of each output's scale (the bound of the unsharded slice:
another assembly and KKT solve, the same math); verdicts, which are
discrete and branch on float32 violations, only on rows whose violation is
not within a factor 2 of the gate they are tested against.
"""

import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import mav_tube_trajectory_generation_tpu as jmtg
from mav_tube_trajectory_generation_tpu.parallel import mesh as jpmesh
from mav_tube_trajectory_generation_tpu.solver import auto as jauto
from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu.solver.ipm import IPMConfig as JIPM
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.parallel import mesh as pmesh
from mav_tube_trajectory_generation_tpu_torch.solver import auto as tauto

from torch_port_util import N, router_batch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_sharded_worker.py")
CHILD_TIMEOUT = 300.0                   # seconds, each child
WORLD2_CASES = ("linear", "shard", "qcqp", "strict", "router", "dryrun")
QCQP_FIELDS = ("d_free", "coefficients", "cost", "max_violation",
               "primal_residual", "dual_residual", "dual_ball", "dual_half")
ADMM_KW = dict(rho=0.005, n_stages=1, n_iters=24, rho_tube_factor=0.125,
               rho_half_factor=0.125)


def _linear_inputs():
    """``make_batch(16)`` of tests/test_parallel.py: K=10, standard mask."""
    k, b = 10, 16
    rng = np.random.RandomState(0)
    structure = jsm.make_structure(jsm.standard_mask(k + 1, N), 3, N)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, k + 1, 3)), axis=1)
    values = np.zeros((b, k + 1, 5, 3))
    values[:, :, 0, :] = waypoints
    times = np.asarray(jmtg.segment_times_nfabian(waypoints, 3.0, 5.0))
    d_fixed = np.asarray(jmtg.extract_fixed_values(structure,
                                                   jnp.asarray(values)))
    return structure, dict(d_fixed=d_fixed, times=times)


def _qcqp_inputs():
    """The fixture of test_solve_qcqp_sharded_matches_unsharded: K=4,
    batch 8, seed 2, radii 0.6, float64."""
    k, b = 4, 8
    rng = np.random.RandomState(2)
    wp = np.cumsum(rng.uniform(0.5, 1.5, size=(b, k + 1, 3)), axis=1)
    free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    vals = np.zeros((b, k + 1, 5, 3))
    vals[:, :, 0] = wp
    dff = np.stack([np.asarray(jlinear.extract_fixed_values(
        free, jnp.asarray(v))) for v in vals])
    times = rng.uniform(0.8, 1.5, size=(b, k))
    return free, dict(d_fixed=dff, times=times, waypoints=wp,
                      radii=np.full((b, k, 2), 0.6))


def _strict_inputs():
    """The fixture of test_strict_router_sharded_matches_single: K=4,
    batch 16, seed 7, rows 4-7 at radius 0.1, float32.  Over two ranks
    rank 1 holds no row that escalates."""
    k, b = 4, 16
    rng = np.random.RandomState(7)
    wp = np.cumsum(rng.uniform(0.5, 2.0, size=(b, k + 1, 3)),
                   axis=1).astype(np.float32)
    free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    vals = np.zeros((b, k + 1, 5, 3), np.float32)
    vals[:, :, 0, :] = wp
    tms = np.asarray(jmtg.segment_times_nfabian(wp, 3.0, 5.0), np.float32)
    radii = np.full((b, k, 2), 0.8, np.float32)
    radii[4:8] = 0.1
    df = np.array(jlinear.extract_fixed_values(free, jnp.asarray(vals)),
                  np.float32)
    return dict(d_fixed=df, times=tms, waypoints=wp, radii=radii,
                values=vals)


def _router_inputs():
    _, df, times, waypoints, radii, values = router_batch()
    return dict(d_fixed=df, times=times, waypoints=waypoints, radii=radii,
                values=values)


class _Ranks:
    """Gloo worlds of child processes, started at once, read on demand."""

    def __init__(self, tmp, inputs):
        self.tmp, self.runs, self.results = tmp, {}, {}
        self.inputs = os.path.join(tmp, "inputs.npz")
        np.savez(self.inputs, **inputs)
        self.env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                        OMP_NUM_THREADS="1")

    def start(self, world, cases):
        store = os.path.join(self.tmp, f"store{world}")
        outs = [os.path.join(self.tmp, f"out{world}_{r}.npz")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), store, self.inputs,
             outs[r], *cases], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=self.env)
            for r in range(world)]
        self.runs[world] = (procs, outs, time.monotonic() + CHILD_TIMEOUT)

    def get(self, world):
        """Each rank's results (dicts of arrays, in rank order)."""
        if world not in self.results:
            procs, outs, deadline = self.runs[world]
            for r, p in enumerate(procs):
                try:
                    _, err = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"rank {r} of {world} timed out")
                assert p.returncode == 0, (r, world, err[-4000:])
            self.results[world] = [dict(np.load(o)) for o in outs]
        return self.results[world]

    def kill(self):
        for procs, _, _ in self.runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {}
    for case, arrays in (("linear", _linear_inputs()[1]),
                         ("shard", _linear_inputs()[1]),
                         ("qcqp", _qcqp_inputs()[1]),
                         ("strict", _strict_inputs()),
                         ("router", _router_inputs())):
        inputs.update({f"{case}_{n}": a for n, a in arrays.items()})
    r = _Ranks(str(tmp_path_factory.mktemp("ranks")), inputs)
    r.start(2, WORLD2_CASES)
    r.start(1, ("linear",))
    yield r
    r.kill()


def _rows(results, key):
    """The ranks' rows of one output, concatenated in rank order."""
    return np.concatenate([res[key] for res in results])


def _jax_mesh2():
    return jpmesh.make_mesh(jax.devices()[:2])


# ---------------------------------------------------------------------------
# Without a process group.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards,want", [(13, 8, 16), (16, 8, 16),
                                           (1, 8, 8)])
def test_pad_batch(n, shards, want):
    assert pmesh.pad_batch(n, shards) == jpmesh.pad_batch(n, shards) == want
    assert pmesh.DATA_AXIS == jpmesh.DATA_AXIS


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.make_mesh()


def test_local_rows_is_the_data_layout():
    """Rank r's block is the r-th device's shard of ``P("data")``."""
    from jax.sharding import NamedSharding, PartitionSpec
    x = np.arange(8 * 3).reshape(8, 3).astype(np.float64)
    devices = jax.devices()[:4]
    jmesh = jpmesh.make_mesh(devices)
    sharded = jax.device_put(
        x, NamedSharding(jmesh, PartitionSpec(jpmesh.DATA_AXIS)))
    shard_of = {s.device: np.asarray(s.data)
                for s in sharded.addressable_shards}
    for rank, dev in enumerate(devices):
        mesh = pmesh.Mesh(None, rank, 4, torch.device("cpu"))
        np.testing.assert_array_equal(pmesh.local_rows(x, mesh),
                                      shard_of[dev])
        np.testing.assert_array_equal(
            pmesh.local_rows(torch.as_tensor(x), mesh).numpy(),
            shard_of[dev])
    with pytest.raises(ValueError, match="pad_batch"):
        pmesh.local_rows(x[:7], pmesh.Mesh(None, 0, 4, torch.device("cpu")))


def _one_rank(monkeypatch):
    """A mesh of one rank whose reductions are the identity."""
    monkeypatch.setattr(pmesh, "_all_reduce",
                        lambda mesh, t, op=None: t.clone())
    monkeypatch.setattr(tauto, "_all_reduce",
                        lambda mesh, t, op=None: t.clone())
    return pmesh.Mesh(None, 0, 1, torch.device("cpu"))


def test_empty_shard_metrics(monkeypatch):
    """A rank without rows contributes 0 scenarios, 0 cost and -inf."""
    mesh = _one_rank(monkeypatch)
    _, x = _linear_inputs()
    std = mtt.make_structure(mtt.standard_mask(10 + 1, N), 3, N)
    sol, m = pmesh.solve_linear_sharded(std, mesh, x["d_fixed"][:0],
                                        x["times"][:0])
    assert sol.coefficients.shape[0] == 0
    assert [float(v) for v in m] == [0.0, 0.0, 0.0, -np.inf]
    assert m.n_scenarios.dtype == torch.float32
    assert m.total_cost.dtype == torch.float64


def test_strict_sharded_defaults_are_the_jax_mesh_routers(monkeypatch):
    """it10 with no speculative restart, two snap sweeps, both gates 1e-4,
    tier 2 on: the JAX package's mesh-router schedule, routed per rank."""
    import inspect
    sig = inspect.signature(mtt.solve_qcqp_strict_sharded).parameters
    jsig = inspect.signature(jauto.solve_qcqp_strict_sharded).parameters
    for name in ("gate", "strict_gate", "tier0_snap", "tier2_f64"):
        assert sig[name].default == jsig[name].default, name
    mesh = _one_rank(monkeypatch)
    seen = {}
    real = tauto.solve_qcqp_auto

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tauto, "solve_qcqp_auto", spy)
    ts, df, times, waypoints, radii, values = router_batch()
    wide = np.full_like(radii, 0.8)[:2]
    res, n_strict = mtt.solve_qcqp_strict_sharded(
        ts, df[:2], times[:2], waypoints[:2], wide, mesh=mesh,
        warmstart_values=values[:2],
        admm_config=mtt.ADMMConfig(**ADMM_KW))
    assert seen["ipm_config"] == mtt.IPMConfig(n_iters=10, sigma_min=0.3,
                                               corrector=False)
    assert (seen["tier1_spec"], seen["tier0_snap"], seen["gate"],
            seen["strict_gate"], seen["tier2_f64"]) == (0, 2, 1e-4, 1e-4,
                                                        True)
    assert seen["device"] == mesh.device
    assert n_strict.dtype == torch.float32 and n_strict.dim() == 0
    assert float(n_strict) == float(
        (res.solution.max_violation < 1e-4).sum())


# ---------------------------------------------------------------------------
# Two gloo ranks (and one) against the JAX package's mesh.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_router(ranks):
    """JAX ``solve_qcqp_strict_sharded`` on two devices, the small router
    batch, tier 2 off.  (Requests ``ranks`` so that the children are
    already at work while this runs.)"""
    ts, df, times, waypoints, radii, values = router_batch()
    js = jsm.make_structure(jsm.free_interior_mask(4 + 1, N), 3, N)
    res, n_strict = jauto.solve_qcqp_strict_sharded(
        js, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), mesh=_jax_mesh2(),
        warmstart_values=jnp.asarray(values),
        admm_config=jqcqp.ADMMConfig(use_pallas=False, **ADMM_KW),
        ipm_config=JIPM(n_iters=8, snap_iters=2, sigma_min=0.3,
                        corrector=False),
        tier2_f64=False, interpret=True, scenario_block=2, tier1_block=1)
    return res, float(n_strict)


def test_sharded_router_against_jax_router(ranks, jax_router):
    ref, ref_n_strict = jax_router
    got = ranks.get(2)
    verdict = _rows(got, "router_verdict")
    escalated = _rows(got, "router_escalated")
    v_o = _rows(got, "router_max_violation")
    v_r = np.asarray(ref.solution.max_violation)
    np.testing.assert_array_equal(escalated, ref.escalated)
    np.testing.assert_array_equal(np.nonzero(escalated)[0], [2, 3, 7])

    def clear_of(gate):
        return np.array([not (gate / 2 < a < gate * 2 or
                              gate / 2 < b < gate * 2)
                         for a, b in zip(v_o, v_r)])

    sure = clear_of(1e-4)                    # both gates are 1e-4 here
    assert sure.sum() >= 6
    print("violations port", v_o, "reference", v_r, "verdicts", verdict,
          ref.verdict)
    # as test_torch_auto.py's router comparison: equal, except that a row
    # the reference leaves open may be FEASIBLE here at a violation well
    # under the gate; never FEASIBLE against INFEASIBLE
    for i in np.nonzero(sure)[0]:
        if verdict[i] != ref.verdict[i]:
            assert (ref.verdict[i] == jauto.UNDETERMINED
                    and verdict[i] == mtt.FEASIBLE
                    and v_o[i] < 0.5e-4), (i, verdict, ref.verdict)
    assert (verdict[sure] == ref.verdict[sure]).sum() >= sure.sum() - 1
    assert verdict[7] == mtt.INFEASIBLE
    assert (verdict[[0, 1, 4, 5, 6]] == mtt.FEASIBLE).all()
    # the reduced count is this batch's, on both ranks
    for res in got:
        assert float(res["router_n_strict"]) == float((v_o < 1e-4).sum())
    assert ref_n_strict == float((v_r < 1e-4).sum())


@pytest.fixture(scope="module")
def jax_linear():
    structure, x = _linear_inputs()
    mesh = _jax_mesh2()
    sol, metrics = jpmesh.solve_linear_sharded(
        structure, mesh, jnp.asarray(x["d_fixed"]), jnp.asarray(x["times"]))

    def per_shard(df, t):
        return jax.vmap(lambda a, b: jmtg.solve_linear(structure, a, b))(
            df, t).cost

    costs = jpmesh.shard_scenarios(per_shard, mesh, 2)(
        jnp.asarray(x["d_fixed"]), jnp.asarray(x["times"]))
    return sol, metrics, np.asarray(costs)


def test_solve_linear_sharded_against_jax(ranks, jax_linear):
    ref, ref_m, _ = jax_linear
    got = ranks.get(2)
    np.testing.assert_allclose(_rows(got, "linear_coefficients"),
                               np.asarray(ref.coefficients),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_rows(got, "linear_cost"),
                               np.asarray(ref.cost), rtol=1e-9)
    n, n_finite, total, top = got[0]["linear_metrics"]
    assert n == float(ref_m.n_scenarios) == 16
    assert n_finite == float(ref_m.n_finite) == 16
    assert total == pytest.approx(float(ref_m.total_cost), rel=1e-9)
    assert top == pytest.approx(float(ref_m.max_cost), rel=1e-9)


def test_linear_metrics_are_the_same_on_every_rank(ranks):
    got = ranks.get(2)
    np.testing.assert_array_equal(got[0]["linear_metrics"],
                                  got[1]["linear_metrics"])
    assert got[0]["linear_cost"].shape == got[1]["linear_cost"].shape == (8,)


def test_world_of_one_gives_the_two_rank_rows(ranks):
    one, two = ranks.get(1), ranks.get(2)
    for name in ("linear_coefficients", "linear_cost"):
        np.testing.assert_allclose(one[0][name], _rows(two, name),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(one[0]["linear_metrics"],
                               two[0]["linear_metrics"], rtol=1e-12)


def test_make_mesh_default_device_needs_a_card(ranks):
    """Inside a group, ``make_mesh()`` means the CUDA card: without one it
    raises, on every rank of either world."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legitimate")
    for world in (1, 2):
        assert all(bool(res["linear_default_device_raised"])
                   for res in ranks.get(world))


def test_shard_scenarios_against_jax(ranks, jax_linear):
    _, _, ref_costs = jax_linear
    for res in ranks.get(2):                 # the whole batch on each rank
        np.testing.assert_allclose(res["shard_costs"], ref_costs, rtol=1e-9)


def test_shard_scenarios_refuses_unequal_rows(ranks):
    for res in ranks.get(2):
        assert bool(res["shard_unequal_raised"])
        assert int(res["shard_calls_after_unequal"]) == 0   # before any work


def test_solve_qcqp_sharded_against_jax(ranks):
    free, x = _qcqp_inputs()
    cfg = jqcqp.ADMMConfig(rho=0.01, n_stages=2, n_iters=25,
                           use_pallas=False)
    # x0=None on both sides: each rank runs solve_qcqp_batch's own cold
    # start, as the unsharded call does
    ref = jax.vmap(lambda a, t, w, r: jqcqp.solve_qcqp(
        free, a, t, w, r, config=cfg))(
        *(jnp.asarray(x[n]) for n in ("d_fixed", "times", "waypoints",
                                      "radii")))
    assert ref.cost.dtype == jnp.float64
    got = ranks.get(2)
    for name in QCQP_FIELDS:
        want = np.asarray(getattr(ref, name))
        ours = _rows(got, f"qcqp_{name}")
        assert ours.dtype == np.float64, name
        np.testing.assert_allclose(
            ours, want, rtol=0,
            atol=1e-6 * max(float(np.abs(want).max()), 1.0), err_msg=name)
    n_ok = float((np.asarray(ref.max_violation) < 1e-2).sum())
    assert [float(res["qcqp_n_ok"]) for res in got] == [n_ok, n_ok]


def test_strict_sharded_with_tier2(ranks):
    """The assertions of test_strict_router_sharded_matches_single on two
    ranks, one of which has no row to escalate (so it reaches the final
    reduction straight from tier 0)."""
    got = ranks.get(2)
    verdict = _rows(got, "strict_verdict")
    escalated = _rows(got, "strict_escalated")
    v = _rows(got, "strict_max_violation")
    for res in got:
        assert float(res["strict_n_strict"]) == float(np.sum(v < 1e-4))
    assert not got[1]["strict_escalated"].any()
    assert escalated[4:8].all()
    assert not escalated[:4].any() and not escalated[8:].any()
    assert (verdict[:4] == mtt.FEASIBLE).all()
    assert (verdict[8:] == mtt.FEASIBLE).all()
    assert (v[verdict == mtt.FEASIBLE] < 1e-4).all()
    assert (verdict != mtt.UNDETERMINED).all(), verdict

    # the single-process router with the same schedule
    x = _strict_inputs()
    free = mtt.make_structure(mtt.free_interior_mask(4 + 1, N), 3, N)
    res1 = mtt.solve_qcqp_auto(
        free, x["d_fixed"], x["times"], x["waypoints"], x["radii"],
        admm_config=mtt.ADMMConfig(**ADMM_KW),
        ipm_config=mtt.IPMConfig(n_iters=6, sigma_min=0.3, corrector=False),
        warmstart_values=x["values"], gate=1e-4, strict_gate=1e-4,
        tier0_snap=2, tier2_f64=True, tier1_spec=0, device="cpu")
    keep = ~escalated
    np.testing.assert_array_equal(verdict[keep], res1.verdict[keep])
    np.testing.assert_array_equal(escalated, res1.escalated)
    assert (res1.verdict != mtt.UNDETERMINED).all()


def test_dryrun_multichip_on_two_ranks(ranks):
    """The dry run passes on two ranks whose processes cannot import JAX,
    and its reduced numbers are the same on both."""
    got = ranks.get(2)
    for res in got:
        assert res["dryrun_jax_modules"].size == 0, res["dryrun_jax_modules"]
    keys = sorted(k for k in got[0] if k.startswith("dryrun_")
                  and k != "dryrun_jax_modules")
    for k in keys:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    out = {k[len("dryrun_"):]: got[0][k].item() for k in keys}
    assert out["batch"] == 4 and out["n_determinate"] == 4
    assert out["n_escalated"] >= 1           # the tight row 3
    assert out["n_ok"] == 4 and np.isfinite(out["mean_cost"])
