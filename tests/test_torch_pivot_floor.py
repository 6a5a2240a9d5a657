"""The pivot floor of the whole polish's band factor and what reports on it:
``ops.ipm_kernel._floored_elimination``'s unfloored pivots, the shift E that
``_band_factor_solve`` returns, ``chip_smoke.counting_floors``'s split into
Newton steps and snap sweeps, the fused path's gate read as margins
(``chip_smoke.fused_gate``, ``margins_vs_scan``) and the candidate floors of
``pivot_floor_sweep.py``.  Float64 on the host, small seeded inputs."""

import ctypes

import numpy as np
import pytest
import torch

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel as tk
from mav_tube_trajectory_generation_tpu_torch.solver.qcqp import QCQPSolution

import chip_smoke
import pivot_floor_sweep
from torch_port_util import BENCH_KW


def _unit_diagonal_spd(n, seed, last_pivot=None):
    """(2, n, n) SPD matrices with unit diagonal; with ``last_pivot`` the
    last diagonal entry moved so that the Cholesky's last pivot is that."""
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.randn(2, n, n))[0]
    a = q @ (np.linspace(1.6, 0.3, n)[None, :, None] * q.transpose(0, 2, 1))
    d = np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    a = a / d[:, :, None] / d[:, None, :]
    if last_pivot is not None:
        a[:, -1, -1] += last_pivot - np.linalg.cholesky(a)[:, -1, -1] ** 2
    return torch.from_numpy(a)


@pytest.mark.parametrize("last_pivot", [0.5, 1e-6, -0.01])
def test_floored_elimination_reports_the_raw_pivots(last_pivot):
    """``raw`` gets the pivots before the floor: the Cholesky's own where
    none falls under it (and then the result is the unfloored one), the last
    one as built here otherwise, with the floor in its place in L."""
    a = _unit_diagonal_spd(6, 3, last_pivot)
    eye = torch.eye(6, dtype=torch.float64).expand_as(a).clone()
    raw = []
    linv = tk._floored_elimination(a, eye, raw=raw)
    (pivots,) = raw
    assert pivots.shape == (2, 6)
    np.testing.assert_allclose(pivots[:, -1].numpy(), last_pivot, rtol=0,
                               atol=1e-12)
    chol = np.linalg.cholesky(a[:, :5, :5].numpy())
    np.testing.assert_allclose(pivots[:, :5].numpy(), np.diagonal(
        chol, axis1=1, axis2=2) ** 2, rtol=1e-12)
    floored = torch.diagonal(linv, dim1=1, dim2=2) ** -2
    np.testing.assert_allclose(floored[:, -1].numpy(),
                               max(last_pivot, tk.PIVOT_FLOOR), rtol=1e-10)
    if last_pivot >= tk.PIVOT_FLOOR:
        unfloored = tk._floored_elimination(a, eye, -float("inf"))
        np.testing.assert_array_equal(linv.numpy(), unfloored.numpy())


def _one_block_band(last_pivot, scale):
    """A band of one 6 x 6 block (m = 1: the factor is one elimination) of
    H = D^-1 A D^-1, A the matrix above, D = diag(scale)."""
    a = _unit_diagonal_spd(6, 5, last_pivot)
    d = torch.tensor(scale, dtype=torch.float64)
    h = a / d[:, None] / d[None, :]
    zu = torch.zeros((2, 0, 6, 6), dtype=torch.float64)
    return h[:, None], zu, torch.zeros_like(h[:, None]), zu, d


@pytest.mark.parametrize("last_pivot", [0.5, 3e-6, float("nan")])
def test_band_factor_shift_is_the_floor_less_the_pivot(last_pivot):
    """``return_shift``: E is zero where no pivot falls under the floor, and
    (floor - pivot) / D^2 (in H's coordinates, D the equilibration) on the
    pivot that does, so that dx solves (H + E) dx = rhs; a NaN pivot gives
    a NaN shift, never a finite one."""
    scale = [1.0, 2.0, 0.5, 4.0, 1.5, 3.0]
    pivot = 0.5 if np.isnan(last_pivot) else last_pivot
    gd, gu, pe_d, pe_u, d = _one_block_band(pivot, scale)
    if np.isnan(last_pivot):
        gd = gd.clone()
        gd[:, 0, -1, -1] = float("nan")
    rhs = torch.from_numpy(np.random.RandomState(7).randn(2, 6, 1))
    dx, e = tk._band_factor_solve(gd, gu, pe_d, pe_u, 0.0, rhs, 6,
                                  return_shift=True)
    assert e.shape == (2, 6, 1)
    if np.isnan(last_pivot):
        assert bool(torch.isnan(e[:, -1]).all())
        assert not bool(torch.isnan(e[:, :-1]).any())
        return
    # the last pivot of the equilibrated block, as a Schur complement
    h = gd[:, 0].numpy()
    dsc = 1.0 / np.sqrt(np.diagonal(h, axis1=1, axis2=2))
    a = h * dsc[:, :, None] * dsc[:, None, :]
    piv = a[:, -1, -1] - np.einsum("bi,bi->b", a[:, -1, :-1], np.linalg.solve(
        a[:, :-1, :-1], a[:, :-1, -1:])[:, :, 0])
    assert ((piv < tk.PIVOT_FLOOR) == (last_pivot < tk.PIVOT_FLOOR)).all()
    want = np.maximum(tk.PIVOT_FLOOR - piv, 0.0) / dsc[:, -1] ** 2
    np.testing.assert_allclose(e[:, -1, 0].numpy(), want, rtol=1e-6,
                               atol=0)
    assert not bool(e[:, :-1].any())
    h = gd[:, 0] + torch.diag_embed(e[:, :, 0])
    np.testing.assert_allclose((h @ dx).numpy(), rhs.numpy(), rtol=0,
                               atol=1e-9 * float(rhs.abs().max()))


@pytest.mark.parametrize("n_iters,snap_iters", [(2, 1), (0, 2), (3, 0)])
def test_counting_floors_splits_newton_steps_and_snap_sweeps(n_iters,
                                                             snap_iters):
    """``chip_smoke.counting_floors`` over two plain polishes of one recorded
    call (float32, then float64): its "newton" rows are the rows whose shift
    is positive in one of the first n_iters factor calls of a polish, its
    "snap" rows those of the next snap_iters calls."""
    sc = mtt.make_inputs(4, 4, seed=2, device="cpu")
    fused = []
    keep = tk.ipm_solve_fused

    def record(*a, **kw):
        fused.append((a, kw))
        return keep(*a, **kw)

    tk.ipm_solve_fused = record
    try:
        mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=mtt.ADMMConfig(n_stages=1, **BENCH_KW),
            ipm_config=mtt.IPMConfig(n_iters=n_iters, snap_iters=snap_iters,
                                     sigma_min=0.3, corrector=False,
                                     fused=True),
            warmstart_values=sc.values, device="cpu")
    finally:
        tk.ipm_solve_fused = keep
    (args, kw), = fused
    shifts = []
    factor = tk._band_factor_solve

    def spy(*a):
        dx, e = factor(*a, return_shift=True)
        shifts.append(((e > 0) | torch.isnan(e)).flatten(1).any(1))
        return dx

    sink = {}
    with chip_smoke.counting_floors(tk, sink, kw):
        for dtype in (torch.float32, torch.float64):
            tk.ipm_solve_fused_plain(*(a.to(dtype) for a in args), **kw)
    tk._band_factor_solve = spy
    try:
        for dtype in (torch.float32, torch.float64):
            tk.ipm_solve_fused_plain(*(a.to(dtype) for a in args), **kw)
    finally:
        tk._band_factor_solve = factor
    steps = n_iters + snap_iters
    assert len(shifts) == 2 * steps
    want = {}
    for i, dtype in enumerate(("float32", "float64")):
        calls = shifts[i * steps:(i + 1) * steps]
        want[dtype] = {name: int(torch.stack(part).any(0).sum())
                       for name, part in (("newton", calls[:n_iters]),
                                          ("snap", calls[n_iters:]))
                       if part}
    assert chip_smoke.floored_counts(sink) == want


def _solution(cost, violation, infeasible):
    n = len(cost)
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    empty = torch.zeros(n)
    return QCQPSolution(empty, empty, empty, empty, t(cost),
                        torch.ones(n, dtype=torch.bool), empty, empty,
                        t(violation), empty, empty,
                        t(infeasible, torch.bool))


@pytest.mark.parametrize("case", ["holds", "cost", "under_gate",
                                  "violation", "infeasible"])
def test_fused_gate_margins_are_the_bars(case):
    """``chip_smoke.fused_gate`` reads each of the fused path's bars as its
    reading over its limit: on 2000 rows the bars are a cost gap median of
    1e-3 and 99th percentile of 1e-2 with at most 5 rows beyond it, at most
    10 rows fewer under the strict gate, a 99th-percentile violation within
    3x the plain run's + 1e-6, and at most 2x + 2 rows certified infeasible.
    A pair that breaks one bar fails on that margin alone."""
    rng = np.random.RandomState(4)
    n = 2000
    cost = rng.uniform(1.0, 2.0, n)
    viol = rng.uniform(0.0, 2.5e-5, n)
    plain = _solution(cost, viol, np.zeros(n, bool))
    k_cost, k_viol, k_inf = cost * (1 + 5e-4), viol.copy(), np.zeros(n, bool)
    if case == "cost":
        k_cost[:8] *= 1.1                     # 8 rows beyond 1e-2
    elif case == "under_gate":
        k_viol[:11] = 2e-4                    # 11 rows leave the gate
    elif case == "violation":
        k_viol[:] = 3.5 * viol
    elif case == "infeasible":
        k_inf[:3] = True
    entry = chip_smoke.fused_gate(_solution(k_cost, k_viol, k_inf), plain, 0)
    over = {name for name, v in entry["margins"].items() if v > 1.0}
    want = {"holds": set(), "cost": {"rows_over_1e_2"},
            "under_gate": {"under_gate_below_plain"},
            "violation": {"p99_violation"},
            "infeasible": {"infeasible"}}[case]
    assert over == want and entry["ok"] == (case == "holds")
    scan = chip_smoke.margins_vs_scan(plain, plain)
    assert scan["cost_gap_median"] == 0.0 and scan["under_gate"] == 0.98


@pytest.mark.parametrize("label", pivot_floor_sweep.FLOORS.split(","))
def test_sweep_candidates_build_the_floor_they_name(label):
    """Each candidate of ``pivot_floor_sweep.py`` is handed to nvcc as a C
    float literal that rounds to the float32 value the plain version is
    given (the wrapper refuses a library whose floor is another), and the
    shipped floor is the first candidate."""
    value = pivot_floor_sweep.floor_value(label)
    (define,) = pivot_floor_sweep.floor_defines(value)
    name, literal = define.split("=")
    assert name == "IPM_PIVOT_FLOOR" and literal.endswith("f")
    assert ctypes.c_float(float(literal[:-1])).value == \
        ctypes.c_float(value).value > 0.0
    if label == "positive":
        assert value == float(torch.finfo(torch.float32).tiny)
    assert pivot_floor_sweep.floor_value(
        pivot_floor_sweep.FLOORS.split(",")[0]) == tk.PIVOT_FLOOR
