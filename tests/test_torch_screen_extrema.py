"""The feasibility screen (the benchmark's ``extrema_k10`` cell) on the host:
the port's ``solve_linear`` and ``max_magnitude`` against the plain float64
reference ``portbench/reference/min_snap_extrema.py``; the reference's own
maxima against dense sampling and known maxima; the cell's check on a small
copy of the cell, with each control and planted fault of
``portbench/screen_faults.py``; the spans and counters of ``solve_linear``
and ``min_max_magnitude``; and the readers of the cell's per-layer metrics.

Tolerances against the reference (K=10, N=10, snap, 64 rows of the cell's
generator; measured on three seeds):
  * float64: cost, control points (m) and maxima within 1e-8, relative (the
    maxima, cost) or absolute (the points); the two solves differ by
    2.7e-11 - 3.6e-11 (the equilibrated R_pp's conditioning), the maxima by
    1.1e-11 - 2.0e-11;
  * float32: the cost within 1e-6 (it is summed in float64 from the float32
    derivatives and moves at second order: 4.9e-8 - 5.7e-8 read); control
    points within 1e-2 m (float32 coefficients in real time, whose terms
    c_i t^i cancel at the segment's end: 1.9e-3 - 2.3e-3 m read); maxima
    within 5e-3 (the float32 solve moves them: 7.1e-4 - 9.2e-4 read).

This file imports no JAX.  Its card tests (the TF32 control, the float64
route's rounding, chip_smoke.py's collision box gate):
``python3 -m pytest tests/test_torch_screen_extrema.py --noconftest -m gpu``.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch import _build
from mav_tube_trajectory_generation_tpu_torch.ops import roots
from mav_tube_trajectory_generation_tpu_torch.solver import linear
from mav_tube_trajectory_generation_tpu_torch.utils import timing

from torch_port_util import BENCH_KW, N, problem, tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench import core, screen_faults  # noqa: E402
from portbench.gen import scenarios  # noqa: E402
from portbench.reference import min_snap_extrema as ref  # noqa: E402
from portbench.reference.tube_qcqp import control_points  # noqa: E402

K = 10
TOL = {torch.float64: dict(cost=1e-8, points=1e-8, maxima=1e-8),
       torch.float32: dict(cost=1e-6, points=1e-2, maxima=5e-3)}
CELL = "extrema_k10"
READERS = {"linear_solve_ms": ("linear", "linear"),
           "extrema_candidates_ms": ("extrema", "extrema/candidates"),
           "extrema_select_ms": ("extrema", "extrema/select"),
           "linear_refused_rows": ("linear", "linear.refused_rows"),
           "extrema_roots_found": ("extrema", "extrema.roots")}


@pytest.fixture(autouse=True)
def _fresh():
    timing.clear_span_log()
    yield
    timing.clear_span_log()


def _std(k=K):
    return mtt.make_structure(mtt.standard_mask(k + 1, N), 3, N)


def _screen(batch, dtype):
    std = _std()
    sol = mtt.solve_linear(std, mtt.extract_fixed_values(
        std, batch["values"].to(dtype)), batch["times"].to(dtype))
    traj = mtt.Trajectory(sol.coefficients, sol.times)
    return (sol, mtt.max_magnitude(traj, 1, n_grid=64).value,
            mtt.max_magnitude(traj, 2, n_grid=64).value)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_against_the_reference(dtype):
    b = scenarios.make_batch(K, 64, seed=21)
    sol, vmax, amax = _screen(b, dtype)
    r = ref.screen(b["waypoints"].double(), b["times"].double())
    tol = TOL[dtype]
    t = b["times"].double()
    assert ((sol.cost.double() - r["cost"]).abs() / r["cost"]).max() \
        < tol["cost"]
    gap = torch.linalg.vector_norm(
        control_points(sol.coefficients.double(), t)
        - control_points(r["coefficients"], t), dim=-1)
    assert gap.max() < tol["points"]
    for got, want in ((vmax, r["max_1"]), (amax, r["max_2"])):
        assert ((got.double() - want).abs() / want).max() < tol["maxima"]


def test_reference_maxima_against_dense_sampling():
    """The analytic maxima are maxima over points of the segments, so the
    sampled maxima never exceed them (beyond float64 rounding), and with
    2048 points a segment they fall short by little."""
    b = scenarios.make_batch(K, 32, seed=5)
    t = b["times"].double()
    r = ref.screen(b["waypoints"].double(), t)
    for d in (1, 2):
        sampled = ref.sampled_maxima(r["coefficients"], t, d, 2048)
        rel = sampled / r[f"max_{d}"] - 1.0
        assert rel.max() < 1e-12
        assert rel.min() > -1e-5


@pytest.mark.parametrize("t_end", [2.0, 0.5])
def test_reference_maxima_of_known_polynomials(t_end):
    """x(t) = (t^2 - t^3 / (1.5 T), t, 0) on one segment of length T: the
    speed sqrt(1 + (2t - 2t^2/T)^2) peaks inside, at t = T/2, at
    sqrt(1 + T^2/4); the acceleration |2 - 4t/T| at both ends, at 2.  The
    higher coefficients are 0, so the candidate polynomial's leading ones
    vanish."""
    c = torch.zeros(1, 1, N, 3, dtype=torch.float64)
    c[0, 0, 2, 0] = 1.0
    c[0, 0, 3, 0] = -1.0 / (1.5 * t_end)
    c[0, 0, 1, 1] = 1.0
    times = torch.tensor([[t_end]], dtype=torch.float64)
    vmax = ref.magnitude_maxima(c, times, 1)
    amax = ref.magnitude_maxima(c, times, 2)
    assert float(vmax) == pytest.approx(math.sqrt(1 + t_end ** 2 / 4),
                                        rel=1e-12)
    assert float(amax) == pytest.approx(2.0, rel=1e-12)
    # the port's bracket reads the same
    traj = mtt.Trajectory(c, times)
    assert float(mtt.max_magnitude(traj, 1).value) == pytest.approx(
        float(vmax), rel=1e-12)


# ---- the cell's check ------------------------------------------------------

def small_cell(batch, rows):
    """The cell at a host size: ``batch`` rows a batch, a pool of 2."""
    cell = core.Cell(core.read_bench(ROOT), CELL, ROOT)
    cell.traffic.update(batch=batch, pool=2)
    cell.check.update(rows_per_batch=rows, trace_calls=1)
    return cell


FAULTS = ("grid_2", "endpoints_only", "slice_times_stretched",
          "answer_altered", "slice_rejected", "reference_tf32")


def _run(variant, device="cpu", batch=32, rows=32):
    cell = small_cell(batch, rows)
    with screen_faults.planted(variant):
        return core.run_cell(cell, 2_500_000_021, 0.0, False, device=device,
                             calls=3)


def _failed(out):
    return {k for k, v in out["checks"].items() if not v["value"] <= v["limit"]}


@pytest.mark.parametrize("variant", ("none", "grid_4") + FAULTS)
def test_check_passes_the_program_and_fails_each_fault(variant):
    """Every row sampled at 32 rows a batch: ``slice_times_stretched``
    touches rows 0 and 16 of each.  On the host ``reference_tf32`` is the
    float32 reference (TF32 exists on the card only), which fails too.
    ``grid_4`` finds the same maxima as the program: a witness the check
    must pass.  ``slice_rejected`` rejects feasible rows, which the
    verdicts' own reading sees."""
    out = _run(variant)
    assert out["failed"] == 0
    if variant in ("none", "grid_4"):
        assert out["correct"] and not _failed(out), out["checks"]
    else:
        assert _failed(out), out["checks"]
    if variant == "slice_rejected":
        assert "verdict_mismatch_rows" in _failed(out)
        assert out["checks"]["false_feasible_rows"]["value"] == 0


def test_cell_files_agree_with_the_benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = core.Cell(bench, CELL, ROOT)
    (entry,) = [c for c in bench["configs"]
                if c["name"] == cell.entry["config"]]
    for key in ("name", "source", "reduced"):
        assert cell.config[key] == entry[key]
    assert cell.config["sources"] == [] and cell.chips == 1
    layer = {m["name"] for m in cell.metrics_layer}
    assert layer == set(READERS) | {"device_idle_share.solves"}
    assert {m["name"] for m in cell.metrics_e2e} == {
        "solves_per_s", "batch_ms_p95", "setup_s"}
    for m in cell.metrics_layer:
        assert m["moves"] == "solves_per_s"
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_no_library_is_built_for_the_cell():
    before = dict(_build._LIBS)
    assert _build.prebuild(()) < 1.0
    assert _build._LIBS == before


@pytest.mark.gpu
def test_program_tf32_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    out = _run("program_tf32", device="cuda", batch=2048, rows=256)
    assert _failed(out), out["checks"]


# ---- spans and counters ----------------------------------------------------

def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_screen_spans_only_under_a_profiler():
    b = scenarios.make_batch(K, 8, seed=3)
    _screen(b, torch.float32)
    assert timing.span_log() == []
    sol, vmax, amax = _profiled(lambda: _screen(b, torch.float32))
    log = timing.span_log()
    assert [c["root"] for c in log] == ["linear", "extrema", "extrema"]
    lin, ext_v, ext_a = log
    assert set(lin["spans"]) == {"linear"}
    assert lin["counters"] == {"linear.refused_rows": 0.0}
    for call, d in ((ext_v, 1), (ext_a, 2)):
        assert set(call["spans"]) == {"extrema", "extrema/candidates",
                                      "extrema/select"}
        assert all(s["n"] == 1 and s["device_ms"] is None
                   for s in call["spans"].values())
        traj = mtt.Trajectory(sol.coefficients, sol.times)
        _, valid = roots.magnitude_minmax_candidates(
            traj.coefficients, d, torch.zeros_like(traj.times), traj.times,
            n_grid=64)
        assert call["counters"] == {
            "extrema.roots": float(valid[..., 2:].sum())}
    assert bool(torch.isfinite(vmax).all() & torch.isfinite(amax).all())


def test_refused_rows_are_counted():
    """A row with a negative segment time has an indefinite R_pp: its
    factor is refused, its answer NaN, and the counter counts it; the
    "schur" route runs no factor and counts nothing."""
    b = scenarios.make_batch(K, 6, seed=4)
    std = _std()
    df = mtt.extract_fixed_values(std, b["values"].double())
    times = b["times"].double().clone()
    times[2, 3] = -times[2, 3]
    sol = _profiled(lambda: mtt.solve_linear(std, df, times))
    (call,) = timing.span_log()
    assert call["counters"]["linear.refused_rows"] == 1.0
    assert not bool(torch.isfinite(sol.cost[2]))
    assert bool(torch.isfinite(sol.cost[[0, 1, 3, 4, 5]]).all())
    timing.clear_span_log()
    _profiled(lambda: mtt.solve_linear(std, df, b["times"].double(),
                                       method="schur"))
    (call,) = timing.span_log()
    assert "linear.refused_rows" not in call["counters"]
    assert "linear/spd_inverse" in call["spans"]


def test_solve_linear_answers_as_before_under_spans():
    b = scenarios.make_batch(K, 8, seed=6)
    std = _std()
    df = mtt.extract_fixed_values(std, b["values"])
    plain = mtt.solve_linear(std, df, b["times"])
    traced = _profiled(lambda: mtt.solve_linear(std, df, b["times"]))
    for a, c in zip(plain, traced):
        assert torch.equal(a, c)
    assert torch.equal(linear.solve_free_derivatives(std, df, b["times"]),
                       plain.d_free)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_free_derivatives_are_the_cholesky_solve(dtype, rtol):
    """The solve computes what ``cholesky_solve`` computes: float32 by two
    triangular solves (the card's batched ``cholesky_solve`` is MAGMA's,
    which stalls its caller now and then), float64 by ``cholesky_solve``
    itself; a refused row stays NaN."""
    b = scenarios.make_batch(K, 16, seed=8)
    std = _std()
    df = mtt.extract_fixed_values(std, b["values"].to(dtype))
    times = b["times"].to(dtype).clone()
    times[5, 2] = -times[5, 2]
    got = linear.solve_free_derivatives(std, df, times)
    nf = std.n_fixed
    r = linear.assemble_r(std, times)
    scale = torch.rsqrt(torch.diagonal(r[:, nf:, nf:], dim1=-2, dim2=-1))
    chol, info = torch.linalg.cholesky_ex(
        r[:, nf:, nf:] * scale[:, :, None] * scale[:, None, :])
    want = torch.cholesky_solve(-(r[:, nf:, :nf] @ df) * scale[:, :, None],
                                chol) * scale[:, :, None]
    ok = info == 0
    assert ok.tolist() == [i != 5 for i in range(16)]
    assert torch.allclose(got[ok], want[ok], rtol=rtol, atol=0.0)
    assert bool(torch.isnan(got[5]).all())


def test_float64_keeps_cholesky_solve(monkeypatch):
    """float64 solves by ``cholesky_solve`` (the rounding the nonlinear
    optimizer's float64 start was validated with on the card); float32 by
    the two triangular solves."""
    calls = []
    orig = torch.cholesky_solve

    def counted(*args, **kw):
        calls.append(args[0].dtype)
        return orig(*args, **kw)
    monkeypatch.setattr(torch, "cholesky_solve", counted)
    b = scenarios.make_batch(K, 4, seed=9)
    std = _std()
    for dtype in (torch.float32, torch.float64):
        mtt.solve_linear(std, mtt.extract_fixed_values(
            std, b["values"].to(dtype)), b["times"].to(dtype))
    assert calls == [torch.float64]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the routes round alike on the host")
    return torch.device("cuda")


@pytest.mark.gpu
def test_float64_solve_is_cholesky_solve_on_the_card():
    """On the card the float64 free derivatives are ``cholesky_solve``'s
    bit for bit (a batched MAGMA solve there, whose last bits the
    triangular route does not reproduce)."""
    dev = _card()
    b = scenarios.make_batch(K, 256, seed=10)
    std = _std()
    df = mtt.extract_fixed_values(std, b["values"].double().to(dev))
    times = b["times"].double().to(dev)
    got = linear.solve_free_derivatives(std, df, times)
    nf = std.n_fixed
    r = linear.assemble_r(std, times)
    scale = torch.rsqrt(torch.diagonal(r[:, nf:, nf:], dim1=-2, dim2=-1))
    chol, _ = torch.linalg.cholesky_ex(
        r[:, nf:, nf:] * scale[:, :, None] * scale[:, None, :])
    want = torch.cholesky_solve(-(r[:, nf:, :nf] @ df) * scale[:, :, None],
                                chol) * scale[:, :, None]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_collision_box_gate_on_the_card():
    """chip_smoke.py's nonlinear_collision box gate: with w_c = 1000 every
    row the JAX package clears clears on the card too (float64, batch
    256); with w_c = 0 some such row does not."""
    _card()
    import chip_smoke
    demo = chip_smoke.load_demo()
    allowed = set(chip_smoke.JAX_BOX_ROWS_MISSED)
    assert set(chip_smoke.box_case(mtt, 1000.0, demo)) <= allowed
    assert not set(chip_smoke.box_case(mtt, 0.0, demo)) <= allowed


def test_qcqp_span_paths_unchanged():
    """``solve_qcqp_batch`` calls the linear helpers directly: its log
    holds the phases it held before and no span of the linear planner."""
    k = 4
    p = problem(k=k, batch=8)
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    cfg = mtt.ADMMConfig(n_stages=1, **{**BENCH_KW, "n_iters": 4})
    _profiled(lambda: mtt.solve_qcqp_batch(
        ts, d_fixed, p["times"], p["waypoints"], p["radii"], config=cfg,
        device="cpu", warmstart_values=p["values"]))
    (call,) = timing.span_log()
    assert call["root"] == "qcqp"
    assert set(call["spans"]) == {
        "qcqp", "qcqp/pre", "qcqp/pre/spd_inverse", "qcqp/band",
        "qcqp/factor", "qcqp/factor/spd_inverse", "qcqp/stage", "qcqp/post"}
    assert set(call["counters"]) == {"spd_inverse.lu_blocks",
                                     "spd_inverse.kernel_blocks"}


# ---- the readers of the cell's per-layer metrics ---------------------------

def _reader(name):
    return core.load_file(os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"),
                          "test_screen_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_a_log(name, monkeypatch):
    assert _reader(name).read(None) is None
    monkeypatch.delattr(timing, "span_log")
    assert _reader(name).read(None) is None


def test_idle_share_reader_without_a_trace():
    ctx = core.Context()
    assert _reader("device_idle_share.solves").read(ctx) is None


def _planted_log():
    """Three logged screens on the card, one off it, and a QCQP call whose
    span and counter names must not be read."""
    calls = []
    for i, (ms, on_card) in enumerate([(5.0, True), (2.0, True), (9.0, True),
                                       (1.0, False)]):
        def dev(x):
            return x if on_card else None
        calls.append({"root": "linear", "counters": {
            "linear.refused_rows": float(i)}, "spans": {
            "linear": {"host_ms": 30.0, "n": 1, "device_ms": dev(ms)}}})
        for d in (1, 2):
            calls.append({"root": "extrema", "counters": {
                "extrema.roots": float(10 * i + d)}, "spans": {
                p: {"host_ms": 30.0, "n": 1, "device_ms": dev(ms * d + j)}
                for j, p in enumerate(("extrema", "extrema/candidates",
                                       "extrema/select"))}})
    calls.append({"root": "qcqp", "counters": {
        "linear.refused_rows": 99.0, "extrema.roots": 99.0}, "spans": {
        p: {"host_ms": 1.0, "n": 1, "device_ms": 99.0}
        for p in ("linear", "extrema/candidates", "extrema/select")}})
    return calls


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_planted_log(name, monkeypatch):
    monkeypatch.setattr(timing, "span_log", _planted_log)
    got = _reader(name).read(None)
    root, key = READERS[name]
    if name == "linear_refused_rows":
        assert got == pytest.approx((0 + 1 + 2 + 3) / 4)
    elif name == "extrema_roots_found":
        assert got == pytest.approx(np.mean([10 * i + d for i in range(4)
                                             for d in (1, 2)]))
    elif name == "linear_solve_ms":
        assert got == pytest.approx(float(np.median([5.0, 2.0, 9.0])))
    else:
        j = 1 if key.endswith("candidates") else 2
        assert got == pytest.approx(float(np.median(
            [ms * d + j for ms in (5.0, 2.0, 9.0) for d in (1, 2)])))
