"""The port's spans and counters (``utils.timing``) on the host: off without a
profiler session, on under one, on the profiler's own clock; the counter of
``spd_inverse``'s LU fallback; the router's tier spans; and the benchmark's
readers of the span log (``portbench/metrics/admm_*``)."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import linalg
from mav_tube_trajectory_generation_tpu_torch.utils import timing

from torch_port_util import BENCH_KW, N, problem, router_batch, tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench import core  # noqa: E402

K = 4
PHASES = ("qcqp/pre", "qcqp/band", "qcqp/factor", "qcqp/stage", "qcqp/post")


@pytest.fixture(autouse=True)
def _fresh():
    timing.clear_span_log()
    timing.Timing.reset()
    yield
    timing.clear_span_log()
    timing.Timing.reset()


def _solve(n_stages, n_iters=4):
    p = problem(k=K, batch=8)
    ts = mtt.make_structure(mtt.free_interior_mask(K + 1, N), 3, N)
    d_fixed = mtt.extract_fixed_values(ts, tt(p["values"]))
    cfg = mtt.ADMMConfig(n_stages=n_stages,
                         **{**BENCH_KW, "n_iters": n_iters})
    return mtt.solve_qcqp_batch(ts, d_fixed, p["times"], p["waypoints"],
                                p["radii"], config=cfg, device="cpu",
                                warmstart_values=p["values"])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_no_profiler_records_nothing():
    timing.Timing.add("kept", 1.0)
    before = timing.Timing.print()
    _solve(n_stages=1)
    assert timing.span_log() == []
    assert timing.Timing.print() == before
    # off: the one shared no-op, whatever the device; no event is made
    assert timing.span("x", torch.device("cuda")) is timing._OFF
    with timing.span("x", "cuda"):
        timing.count("c", 1)
    assert timing.span_log() == [] and timing._events == []


@pytest.mark.parametrize("n_stages", [1, 2])
def test_profiled_call_records_its_phases(n_stages):
    sol, _ = _profiled(lambda: _solve(n_stages))
    assert bool(torch.isfinite(sol.cost).all())
    (call,) = timing.span_log()
    assert call["root"] == "qcqp"
    spans = call["spans"]
    for path in PHASES:
        want = n_stages if path in ("qcqp/factor", "qcqp/stage") else 1
        assert spans[path]["n"] == want, path
        assert spans[path]["device_ms"] is None          # host run
        assert timing.Timing.get_num_samples(path) == want
    # the warm start's inverse and one per band block of every stage
    assert spans["qcqp/pre/spd_inverse"]["n"] == 1
    assert spans["qcqp/factor/spd_inverse"]["n"] == 3 * n_stages
    assert call["counters"] == {"spd_inverse.lu_blocks": 0.0}
    # the phases tile the call and nest inside it, one after another
    _, t0, t1 = call["intervals"][-1]
    assert (t0, t1) == (call["t0_ns"], call["t1_ns"])
    tops = [iv for iv in call["intervals"] if iv[0] in PHASES]
    assert [iv[0] for iv in tops] == (["qcqp/pre", "qcqp/band"]
                                      + ["qcqp/factor", "qcqp/stage"]
                                      * n_stages + ["qcqp/post"])
    edges = [t0] + [t for _, a, b in tops for t in (a, b)] + [t1]
    assert edges == sorted(edges)
    assert sum(spans[p]["host_ms"] for p in PHASES) <= spans["qcqp"]["host_ms"]


def test_spans_bracket_the_profilers_events():
    """Span stamps and the profiler's events are on one clock: no aten::
    event crosses a span's edge, and each Cholesky factor lies inside the
    one ``spd_inverse`` span that ran it."""
    _, prof = _profiled(lambda: _solve(n_stages=2))
    (call,) = timing.span_log()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert events
    for path, t0, t1 in call["intervals"]:
        for name, a, b in events:
            if a < t1 and b > t0:            # overlaps the span
                assert t0 <= a and b <= t1, (path, name, a - t0, b - t1)
    chol = [(a, b) for name, a, b in events
            if name == "aten::linalg_cholesky_ex"]
    inv = [(t0, t1) for path, t0, t1 in call["intervals"]
           if path.endswith("/spd_inverse")]
    assert len(chol) == len(inv) == 7
    for t0, t1 in inv:
        assert sum(t0 <= a and b <= t1 for a, b in chol) == 1


def test_lu_blocks_counts_the_refused_blocks():
    g = torch.Generator().manual_seed(3)
    m = torch.randn(64, 6, 6, generator=g)
    a = m @ m.transpose(-1, -2) + 0.5 * torch.eye(6)
    # one indefinite block with a positive diagonal: [[1, 2], [2, 1]] in it
    a[17] = torch.eye(6)
    a[17, 0, 1] = a[17, 1, 0] = 2.0
    refused = torch.linalg.cholesky_ex(a)[1] != 0
    assert int(refused.sum()) == 1
    plain = linalg.spd_inverse(a)
    inv, _ = _profiled(lambda: linalg.spd_inverse(a))
    assert torch.equal(inv, plain)
    (call,) = timing.span_log()
    assert call["root"] == "spd_inverse"
    assert call["counters"]["spd_inverse.lu_blocks"] == float(refused.sum())
    assert torch.allclose(inv[17] @ a[17], torch.eye(6), atol=1e-4)


def test_router_tier_spans():
    ts, df, times, waypoints, radii, values = router_batch()
    res, _ = _profiled(lambda: mtt.solve_qcqp_auto(
        ts, df, times, waypoints, radii,
        admm_config=mtt.ADMMConfig(rho=0.005, n_stages=1, n_iters=24,
                                   rho_tube_factor=0.125,
                                   rho_half_factor=0.125),
        ipm_config=mtt.IPMConfig(n_iters=8, snap_iters=2, sigma_min=0.3,
                                 corrector=False),
        warmstart_values=values, tier2_f64=False, tier1_spec=2,
        device="cpu"))
    assert res.n_escalated > 0
    (call,) = timing.span_log()
    assert call["root"] == "strict"
    spans = call["spans"]
    for path in ("strict/tier0", "strict/tier1", "strict/tier1_restart",
                 "strict/tier15"):
        assert spans[path]["n"] == 1, path
    assert "strict/tier2" not in spans                   # tier2_f64=False
    for path in PHASES:
        assert spans["strict/tier0/" + path]["n"] == 1, path
    tiers = sum(spans[p]["host_ms"] for p in spans if p.count("/") == 1)
    assert tiers <= spans["strict"]["host_ms"]


# ---- the benchmark's readers of the span log ------------------------------

READERS = {"admm_pre_ms": "qcqp/pre", "admm_band_ms": "qcqp/band",
           "admm_factor_ms": "qcqp/factor", "admm_post_ms": "qcqp/post",
           "admm_lu_fallback_blocks": "spd_inverse.lu_blocks"}


def _reader(name):
    return core.load_file(os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"), "test_metric_" + name)


def _planted(key):
    """Four logged calls of ``solve_qcqp_batch`` (one off the card), one of
    the router: the value of ``key`` in each."""
    calls = []
    for i, (ms, lu, on_card) in enumerate([(5.0, 0, True), (2.0, 4, True),
                                           (9.0, 2, True), (1.0, 9, False)]):
        spans = {p: {"host_ms": 30.0, "n": 1,
                     "device_ms": (ms + j) if on_card else None}
                 for j, p in enumerate(PHASES)}
        calls.append({"root": "qcqp", "spans": spans,
                      "counters": {"spd_inverse.lu_blocks": float(lu)}})
    calls.append({"root": "strict", "spans": {
        "strict/tier0/" + key: {"host_ms": 1.0, "n": 1, "device_ms": 99.0}},
        "counters": {"spd_inverse.lu_blocks": 99.0}})
    return calls


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_an_empty_log(name):
    assert timing.span_log() == []
    assert _reader(name).read(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(timing, "span_log")
    assert _reader(name).read(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_planted_log(name, monkeypatch):
    monkeypatch.setattr(timing, "span_log", lambda: _planted(READERS[name]))
    got = _reader(name).read(None)
    if name == "admm_lu_fallback_blocks":
        # the mean over every call of solve_qcqp_batch, on the card or not
        assert got == pytest.approx((0 + 4 + 2 + 9) / 4)
    else:
        # the median of the device times of the calls on the card
        j = PHASES.index(READERS[name])
        assert got == pytest.approx(float(np.median([5.0, 2.0, 9.0])) + j)
