"""The whole polish's band factor (``ops.ipm_kernel._band_factor_solve``, the
plain version of #11's) against the JAX kernel's (``_band_factor_solve`` of
the JAX package's ``ops/ipm_kernel.py``), in float64 on the host, on the
bands the port's own fused polish factors (K=4 and K=10, six rows of
``make_inputs``, seeds 0 and 1): its first Newton step's and its first snap
sweep's.

The two factor the same H = blocktridiag(pe_d + gd + reg I, pe_u + gu) in
different ways: the port a twisted block Cholesky with its pivots floored at
``PIVOT_FLOOR`` of the equilibrated diagonal, so that it factors H + E (E
diagonal, E >= 0, nonzero only where a pivot falls under the floor, and
returned by ``return_shift``); the JAX kernel block-Thomas with Gauss-Jordan
inverses of the pivot blocks, which factors H.

* The bands are the float32 polish's, taken to float64 with their diagonal
  blocks made symmetric: the Cholesky reads one triangle of a pivot block
  and Gauss-Jordan inverts the whole block, so on a band that float32 left
  asymmetric by an ulp (1e-7 of an entry) the two solve matrices that
  differ by that ulp, times the band's condition (1e5 at K=10).
* The JAX kernel's products ask for float32 results (``_sdot3``'s
  ``preferred_element_type``, its precision on the TPU).  The tests give
  that one helper float64 products, so that everything else -- the
  equilibration, the Gauss-Jordan inverses, the block-Thomas order -- is the
  JAX function's own, in float64.
* ``PARITY_RTOL`` = 1e-9: where no pivot floors, the two float64 solves
  agree to the band's condition times float64's rounding (measured: 6e-13
  at K=4, 3e-10 at K=10, on these bands).
* Where a pivot floors, dx is the solve of H + E: its backward error
  against H + E, in the equilibrated coordinates the factor works in, is at
  most ``BACKWARD_TOL`` = 1e-13 of the scale (measured 2e-15), and it
  differs from the JAX solve in those rows only.

The second half runs the port's fused polish (the plain factor) and the
scan polish at K=4 and K=10 on a few rows and counts, with
``chip_smoke.counting_floors``, the rows in which the factor floors a pivot,
Newton steps and snap sweeps apart, as ``chip_smoke.py`` reports them at the
benchmark's shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import ipm_kernel as jk
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel as tk

import chip_smoke
from torch_port_util import to_np

PARITY_RTOL = 1e-9
BACKWARD_TOL = 1e-13
ROWS = 6
N_ITERS = 10
CASES = [(seed, k) for k in (4, 10) for seed in (0, 1)]
ADMM = dict(rho=0.005, n_stages=1, n_iters=48, rho_tube_factor=0.125,
            rho_half_factor=0.125)


def _polish(k, seed, fused=True, rows=ROWS):
    """The port's polish of ``rows`` scenarios of ``make_inputs`` on the
    host, with the calls of the plain band factor and of the fused kernel's
    wrapper recorded: (solution, [factor args], [(fused args, kw)])."""
    sc = mtt.make_inputs(k, rows, seed=seed, device="cpu")
    factors, fused_calls = [], []
    keep_factor, keep_fused = tk._band_factor_solve, tk.ipm_solve_fused

    def factor(*a, **kw):
        factors.append(a)
        return keep_factor(*a, **kw)

    def wrapper(*a, **kw):
        fused_calls.append((a, kw))
        return keep_fused(*a, **kw)

    tk._band_factor_solve, tk.ipm_solve_fused = factor, wrapper
    try:
        sol = mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=mtt.ADMMConfig(**ADMM),
            ipm_config=mtt.IPMConfig(n_iters=N_ITERS, sigma_min=0.3,
                                     corrector=False, fused=fused),
            warmstart_values=sc.values, device="cpu")
    finally:
        tk._band_factor_solve, tk.ipm_solve_fused = keep_factor, keep_fused
    return sol, factors, fused_calls


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"seed{c[0]}-K{c[1]}")
def bands(request):
    """(seed, K, the first Newton step's band, the first snap sweep's), each
    a float64 tuple (gd, gu, pe_d, pe_u, reg, rhs, blk) with symmetric
    diagonal blocks."""
    seed, k = request.param
    _, factors, _ = _polish(k, seed)
    assert len(factors) == N_ITERS + 2

    def f64(call):
        gd, gu, pe_d, pe_u, reg, rhs, blk = call
        sym = lambda a: 0.5 * (a + a.transpose(-1, -2))
        return (sym(gd.double()), gu.double(), sym(pe_d.double()),
                pe_u.double(), reg, rhs.double(), blk)

    return seed, k, f64(factors[0]), f64(factors[N_ITERS])


def _jax_solve(gd, gu, pe_d, pe_u, reg, rhs, blk, monkeypatch):
    """The JAX kernel's ``_band_factor_solve`` on the same band in float64
    (its products in float64: see the top)."""
    bsz, m = gd.shape[:2]
    nfd = m * blk
    gram = np.zeros((bsz, nfd, nfd))
    for i in range(m):
        gram[:, i * blk:(i + 1) * blk, i * blk:(i + 1) * blk] = to_np(gd[:, i])
        if i + 1 < m:
            gram[:, i * blk:(i + 1) * blk, (i + 1) * blk:(i + 2) * blk] = \
                to_np(gu[:, i])
    monkeypatch.setattr(jk, "_sdot3", lambda a, b: jnp.einsum(
        "snk,skm->snm", a, b, precision=jax.lax.Precision.HIGHEST))
    out = jk._band_factor_solve(jnp.asarray(gram), jnp.asarray(to_np(pe_d)),
                                jnp.asarray(to_np(pe_u)), reg,
                                jnp.asarray(to_np(rhs)), blk)
    assert out.dtype == jnp.float64
    return np.asarray(out)


def _dense(gd, gu, pe_d, pe_u, reg, blk):
    """H as a dense (B, nfd, nfd) float64 array."""
    gd, gu, pe_d, pe_u = (to_np(a) for a in (gd, gu, pe_d, pe_u))
    bsz, m = gd.shape[:2]
    nfd = m * blk
    h = np.zeros((bsz, nfd, nfd))
    for i in range(m):
        r = slice(i * blk, (i + 1) * blk)
        h[:, r, r] = gd[:, i] + pe_d[:, i] + reg * np.eye(blk)
        if i + 1 < m:
            q = slice((i + 1) * blk, (i + 2) * blk)
            h[:, r, q] = gu[:, i] + pe_u[:, i]
            h[:, q, r] = np.swapaxes(h[:, r, q], 1, 2)
    return h


def _far(a, b, rtol):
    """(B,) rows where a and b part by more than rtol of b (2-norms)."""
    d = np.linalg.norm((a - b).reshape(a.shape[0], -1), axis=1)
    return d > rtol * np.linalg.norm(b.reshape(b.shape[0], -1), axis=1)


def test_band_factor_matches_jax_where_no_pivot_floors(bands, monkeypatch):
    """The first Newton step's band: no pivot falls under the floor (the
    shift is zero in every row), and the port's factor is the JAX kernel's
    to ``PARITY_RTOL`` in every row, and the dense solve's too."""
    _, _, newton, _ = bands
    dx, shift = tk._band_factor_solve(*newton, return_shift=True)
    assert dx.dtype == torch.float64
    assert not bool(shift.any())
    dx = to_np(dx)
    ref = _jax_solve(*newton, monkeypatch)
    assert not _far(dx, ref, PARITY_RTOL).any()
    gd, gu, pe_d, pe_u, reg, rhs, blk = newton
    exact = np.linalg.solve(_dense(gd, gu, pe_d, pe_u, reg, blk), to_np(rhs))
    assert not _far(dx, exact, PARITY_RTOL).any()
    # without return_shift the same direction alone
    np.testing.assert_array_equal(to_np(tk._band_factor_solve(*newton)), dx)


def test_band_factor_solves_h_plus_e_where_a_pivot_floors(bands, monkeypatch):
    """The Newton step's rows and the first snap sweep's in one batch: the
    sweep's bands floor a pivot in some rows (their equilibrated pivots lie
    under float32's resolution, float64 too).  In every row the port's dx is
    the solve of H + E with the E it reports (backward error); in the rows
    whose E is zero it is the JAX kernel's dx, and the rows where the two
    part are rows whose E is not zero.  The right-hand side is drawn from
    the seed (a sweep's own is zero in the rows it finds feasible, and
    would show nothing of the factor there)."""
    seed, _, newton, snap = bands
    gd, gu, pe_d, pe_u = (torch.cat([a, b]) for a, b in zip(newton[:4],
                                                           snap[:4]))
    blk = newton[6]
    rhs = torch.from_numpy(np.random.RandomState(seed).randn(
        2 * ROWS, gd.shape[1] * blk, 1))
    # reg differs between the two (1e-9 and 1e-6): fold it into pe_d
    eye = torch.eye(blk, dtype=torch.float64)
    pe_d = torch.cat([pe_d[:ROWS] + newton[4] * eye, pe_d[ROWS:]
                      + snap[4] * eye])
    dx, shift = tk._band_factor_solve(gd, gu, pe_d, pe_u, 0.0, rhs, blk,
                                      return_shift=True)
    dx, e = to_np(dx), to_np(shift)[:, :, 0]
    assert (e >= 0).all()
    floored = (e > 0).any(axis=1)
    assert not floored[:ROWS].any() and floored[ROWS:].any()
    h = _dense(gd, gu, pe_d, pe_u, 0.0, blk)
    d = 1.0 / np.sqrt(np.diagonal(h, axis1=1, axis2=2))  # the equilibration
    he = (h + e[:, :, None] * np.eye(h.shape[1])) * d[:, :, None] \
        * d[:, None, :]
    x, b = dx[:, :, 0] / d, to_np(rhs)[:, :, 0] * d
    residual = np.linalg.norm(np.einsum("bij,bj->bi", he, x) - b, axis=1)
    scale = (np.linalg.norm(he, ord=2, axis=(1, 2))
             * np.linalg.norm(x, axis=1) + np.linalg.norm(b, axis=1))
    assert (residual <= BACKWARD_TOL * scale).all(), residual / scale
    ref = _jax_solve(gd, gu, pe_d, pe_u, 0.0, rhs, blk, monkeypatch)
    apart = _far(dx, ref, PARITY_RTOL)
    assert not (apart & ~floored).any()
    assert apart[floored].any()


def _factor_calls(args, kw, dtype, monkeypatch):
    """The band factor's calls (their arguments) in the plain fused polish
    of the recorded call ``args`` run in ``dtype``."""
    calls = []
    keep = tk._band_factor_solve

    def rec(*a, **k):
        calls.append(a)
        return keep(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(tk, "_band_factor_solve", rec)
        tk.ipm_solve_fused_plain(*(a.to(dtype) for a in args), **kw)
    return calls


def _rows_under_floor(call, monkeypatch):
    """(B,) rows in which the band factor's elimination, run without a
    floor, meets a pivot under ``PIVOT_FLOOR``: up to that pivot it is the
    floored elimination, so these are the rows the floor lifts."""
    gd, gu, pe_d, pe_u, reg, _, blk = call
    seen, keep = [], tk._floored_elimination

    def unfloored(a, r, raw):
        out = keep(a, r, -float("inf"), raw)
        seen.append(raw[-1])
        return out

    with monkeypatch.context() as m:
        m.setattr(tk, "_floored_elimination", unfloored)
        tk._band_factor_solve(gd, gu, pe_d, pe_u, reg, torch.zeros(
            gd.shape[0], gd.shape[1] * blk, 1, dtype=gd.dtype), blk)
    return (torch.cat(seen, 1) < tk.PIVOT_FLOOR).any(1)


@pytest.mark.parametrize("k", [4, 10])
def test_fused_polish_floor_counts_and_ends(k, monkeypatch):
    """The port's fused polish (the plain factor on the host) and the scan
    polish on eight rows of seed 0.  The rows ``chip_smoke.counting_floors``
    counts, Newton steps and snap sweeps apart, in float32 and in float64,
    are the rows in which the factor's elimination run without a floor
    meets a pivot under it: none in the first Newton step's band, which
    needs no floor; in the snap sweeps, whose equilibrated pivots lie under
    the floor in float64 too, at least half the rows, as ``chip_smoke.py``
    reports nearly every row at the benchmark's shape.  And the polish's ends hold the scan polish's to
    today's bars: the cost gap's median within 1e-3 and its worst row within
    1e-2, no fewer rows under the strict gate, and a worst violation within
    3x the scan's + 1e-6."""
    rows = 8
    sol, _, fused_calls = _polish(k, 0, rows=rows)
    scan, _, _ = _polish(k, 0, fused=False, rows=rows)
    (args, kw), = fused_calls
    sink = {}
    with chip_smoke.counting_floors(tk, sink, kw):
        for dtype in (torch.float32, torch.float64):
            tk.ipm_solve_fused_plain(*(a.to(dtype) for a in args), **kw)
    counts = chip_smoke.floored_counts(sink)
    for dtype in (torch.float32, torch.float64):
        hits = [_rows_under_floor(c, monkeypatch)
                for c in _factor_calls(args, kw, dtype, monkeypatch)]
        assert len(hits) == N_ITERS + 2
        assert not bool(hits[0].any())
        steps = {"newton": torch.stack(hits[:N_ITERS]).any(0),
                 "snap": torch.stack(hits[N_ITERS:]).any(0)}
        assert counts[str(dtype)[6:]] == {n: int(v.sum())
                                          for n, v in steps.items()}
        assert 2 * int(steps["snap"].sum()) >= rows
    gap = to_np((sol.cost - scan.cost).abs() / scan.cost.abs())
    assert np.median(gap) <= chip_smoke.FUSED_COST_MEDIAN
    assert gap.max() <= chip_smoke.FUSED_COST_P99
    viol, scan_viol = to_np(sol.max_violation), to_np(scan.max_violation)
    gate = chip_smoke.STRICT_GATE
    assert (viol < gate).sum() >= (scan_viol < gate).sum()
    assert viol.max() <= 3.0 * max(scan_viol.max(), 0.0) + 1e-6
