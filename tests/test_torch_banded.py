"""The port's block-tridiagonal KKT structure test, LDL^T factorization and
factored solve against the JAX package's ``solver/banded.py``.

The two factorizations invert their pivot blocks differently (recursive
block-Schur in JAX, equilibrated Cholesky in the port), so they agree to
rounding, not to the bit: rtol 1e-8 in float64; in float32 the band of the
stage KKT has cond ~1e3, so factors agree to ~1e-3 relative and solutions
are compared through the residual of the system they solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.solver import banded as jbanded
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch.solver import banded as tbanded
from mav_tube_trajectory_generation_tpu_torch.solver import structure as tsm

from torch_port_util import to_np, tt

CASES = [("free", 4, 10, 3), ("free", 10, 10, 3), ("free", 2, 10, 3),
         ("standard", 4, 10, 3), ("free", 3, 12, 3), ("free", 4, 10, 1),
         ("mixed", 4, 10, 3), ("open_end", 4, 10, 3)]


def _mask(mod, kind, k, n):
    if kind == "free":
        return mod.free_interior_mask(k + 1, n)
    mask = mod.standard_mask(k + 1, n)
    if kind == "mixed":
        mask[2, 1] = True
    if kind == "open_end":
        mask[-1, 3] = False
    return mask


@pytest.mark.parametrize("kind,k,n,dim", CASES)
def test_structure_tests_agree(kind, k, n, dim):
    js = jsm.make_structure(_mask(jsm, kind, k, n), dim, n)
    ts = tsm.make_structure(_mask(tsm, kind, k, n), dim, n)
    jp = jbanded.uniform_interior_pattern(js)
    tp = tbanded.uniform_interior_pattern(ts)
    assert (jp is None) == (tp is None)
    if jp is not None:
        np.testing.assert_array_equal(tp, jp)
    assert tbanded.kkt_tridiag_block(ts) == jbanded.kkt_tridiag_block(js)


def test_flagship_block_size():
    ts = tsm.make_structure(tsm.free_interior_mask(11, 10), 3, 10)
    assert tbanded.kkt_tridiag_block(ts) == 15
    assert ts.n_free * 3 == 135


def _spd_band(rng, batch, m, b, cond_scale=1.0):
    """A random SPD block-tridiagonal system: (dense, dblk, ublk)."""
    n = m * b
    dense = np.zeros((batch, n, n))
    for i in range(m):
        a = rng.randn(batch, b, b)
        dense[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = \
            a @ a.transpose(0, 2, 1) + 4.0 * b * np.eye(b)
    for i in range(m - 1):
        u = rng.randn(batch, b, b) * cond_scale
        dense[:, i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = u
        dense[:, (i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = \
            u.transpose(0, 2, 1)
    dblk = np.stack([dense[:, i * b:(i + 1) * b, i * b:(i + 1) * b]
                     for i in range(m)], axis=1)
    ublk = np.stack([dense[:, i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b]
                     for i in range(m - 1)], axis=1)
    return dense, dblk, ublk


@pytest.mark.parametrize("m,b", [(3, 15), (9, 15), (4, 6)])
def test_factor_and_solve_f64(m, b):
    rng = np.random.RandomState(m * 100 + b)
    dense, dblk, ublk = _spd_band(rng, 3, m, b)
    rhs = rng.randn(3, m * b, 2)
    js_inv, jt = jbanded.spd_block_tridiag_factor(jnp.asarray(dblk),
                                                  jnp.asarray(ublk))
    ts_inv, tt_ = tbanded.spd_block_tridiag_factor(tt(dblk), tt(ublk))
    assert tt_[0] is None and len(ts_inv) == m
    for i in range(m):
        np.testing.assert_allclose(to_np(ts_inv[i]), np.asarray(js_inv[i]),
                                   rtol=1e-8, atol=1e-12)
        if i:
            np.testing.assert_allclose(to_np(tt_[i]), np.asarray(jt[i]),
                                       rtol=1e-8, atol=1e-12)
    ours = tbanded.spd_block_tridiag_solve_factored(ts_inv, tt_, tt(rhs))
    ref = jbanded.spd_block_tridiag_solve_factored(js_inv, jt,
                                                   jnp.asarray(rhs))
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(ours), np.linalg.solve(dense, rhs),
                               rtol=1e-8, atol=1e-12)


def test_factor_accepts_lists_of_blocks():
    rng = np.random.RandomState(5)
    _, dblk, ublk = _spd_band(rng, 2, 4, 6)
    a = tbanded.spd_block_tridiag_factor(tt(dblk), tt(ublk))
    b = tbanded.spd_block_tridiag_factor(
        [tt(dblk[:, i]) for i in range(4)], [tt(ublk[:, i]) for i in range(3)])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def test_factor_and_solve_f32():
    """float32: both packages against the float64 solution of the same
    system.  The system is diagonally dominant (cond ~10), so a float32
    factored solve keeps ~5 digits; 2e-4 relative to the solution's scale."""
    rng = np.random.RandomState(7)
    dense, dblk, ublk = _spd_band(rng, 4, 9, 15)
    rhs = rng.randn(4, 135, 1)
    exact = np.linalg.solve(dense, rhs)
    f32 = np.float32
    ts_inv, tt_ = tbanded.spd_block_tridiag_factor(
        tt(dblk.astype(f32)), tt(ublk.astype(f32)))
    assert ts_inv[0].dtype == torch.float32
    ours = to_np(tbanded.spd_block_tridiag_solve_factored(
        ts_inv, tt_, tt(rhs.astype(f32))))
    js_inv, jt = jbanded.spd_block_tridiag_factor(
        jnp.asarray(dblk.astype(f32)), jnp.asarray(ublk.astype(f32)))
    ref = np.asarray(jbanded.spd_block_tridiag_solve_factored(
        js_inv, jt, jnp.asarray(rhs.astype(f32))))
    scale = np.abs(exact).max()
    assert np.abs(ours - exact).max() < 2e-4 * scale
    assert np.abs(ours - ref).max() < 2e-4 * scale
    for i in range(9):
        np.testing.assert_allclose(to_np(ts_inv[i]), np.asarray(js_inv[i]),
                                   atol=2e-4 * np.abs(js_inv[i]).max())


def test_bad_blocks_touch_their_own_scenario_only():
    """One scenario of a batch whose pivot block is indefinite (positive
    diagonal, one negative eigenvalue) and one with a NaN entry.
    ``torch.linalg.cholesky`` raised ``LinAlgError`` for the whole batch
    here.  The factor now returns without raising; like the JAX package's
    matmul-only inverse it gives the indefinite scenario the factors of the
    matrix it was handed (float64, rtol 1e-8 against the reference on every
    finite scenario, the indefinite one included), and the NaN scenario is
    non-finite from its bad pivot on -- alone."""
    rng = np.random.RandomState(21)
    _, dblk, ublk = _spd_band(rng, 5, 3, 15)
    bad, nan = 3, 1
    v = rng.randn(15)
    v /= np.linalg.norm(v)
    dblk[bad, 1] -= np.linalg.eigvalsh(dblk[bad, 1]).max() * np.outer(v, v)
    assert np.linalg.eigvalsh(dblk[bad, 1]).min() < 0 < \
        np.diag(dblk[bad, 1]).min()
    dblk[nan, 1, 4, 4] = np.nan
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(tt(dblk[[0, bad], 1]))      # the old fault
    ts_inv, tt_ = tbanded.spd_block_tridiag_factor(tt(dblk), tt(ublk))
    js_inv, jt = jbanded.spd_block_tridiag_factor(jnp.asarray(dblk),
                                                  jnp.asarray(ublk))
    finite = np.arange(5) != nan
    for i in range(3):
        ours = to_np(ts_inv[i])
        assert np.isfinite(ours[finite]).all()
        np.testing.assert_allclose(ours[finite],
                                   np.asarray(js_inv[i])[finite],
                                   rtol=1e-8, atol=1e-12)
        if i:
            np.testing.assert_allclose(to_np(tt_[i])[finite],
                                       np.asarray(jt[i])[finite],
                                       rtol=1e-8, atol=1e-12)
    assert np.isfinite(to_np(ts_inv[0])).all()        # before the bad pivot
    assert not np.isfinite(to_np(ts_inv[1])[nan]).any()
    assert not np.isfinite(to_np(ts_inv[2])[nan]).any()
    rhs = rng.randn(5, 45, 1)
    x = to_np(tbanded.spd_block_tridiag_solve_factored(ts_inv, tt_, tt(rhs)))
    assert np.isfinite(x[finite]).all() and not np.isfinite(x[nan]).all()
    # the indefinite scenario's solve is the solve of its (indefinite) system
    dense = _dense_from_band(dblk[bad], ublk[bad])
    np.testing.assert_allclose(x[bad], np.linalg.solve(dense, rhs[bad]),
                               rtol=1e-8, atol=1e-12)


def _dense_from_band(dblk, ublk):
    m, b = dblk.shape[0], dblk.shape[-1]
    dense = np.zeros((m * b, m * b))
    for i in range(m):
        dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = dblk[i]
    for i in range(m - 1):
        dense[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = ublk[i]
        dense[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = ublk[i].T
    return dense
