"""Batched real roots in an interval, and interval extrema.

Counterpart of the JAX package's ``ops/roots.py``.  The reference finds
derivative extrema with the scalar Jenkins-Traub solver (rpoly); here only
the real roots inside a known interval [t0, t1] are needed (extrema
candidates, polynomial.cpp:102-114), and they are found with the same
fixed-shape two-phase scheme as the JAX package:

  1. evaluate the polynomial on a grid of ``n_grid`` cells over [t0, t1];
  2. bracket the cells with a sign change (or an exact zero at the cell's
     left node) and refine each with a fixed count of bisections.

Strict extrema occur only where the derivative crosses zero, so sign-change
brackets lose nothing for min/max: the interval's endpoints are always
candidates.  The grid bracket is kept for parity with the JAX package (it
exists there because the TPU compiler had no nonsymmetric eigensolver).

``roots_companion`` (NumPy, the host) is the test oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .basis import convolve_full, derivative_coefficients, polyval

# Two real roots of a degree <= 21 polynomial in one of 256 cells (and so
# missed) needs pathological clustering.
DEFAULT_GRID = 256
DEFAULT_BISECTIONS = 52


def _polyval_raw(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of raw coefficients (no derivative table)."""
    n = coeffs.shape[-1]
    acc = coeffs[..., n - 1]
    for j in range(n - 2, -1, -1):
        acc = acc * t + coeffs[..., j]
    return acc


def _interval(coeffs: torch.Tensor, t0, t1, batch_shape
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t0, t1 as tensors of the coefficients' dtype and device, broadcast to
    ``batch_shape`` together with each other."""
    t0 = torch.as_tensor(t0, dtype=coeffs.dtype, device=coeffs.device)
    t1 = torch.as_tensor(t1, dtype=coeffs.dtype, device=coeffs.device)
    batch = torch.broadcast_shapes(batch_shape, t0.shape, t1.shape)
    return t0.expand(batch), t1.expand(batch)


class IntervalRoots(NamedTuple):
    roots: torch.Tensor   # (..., max_roots) root locations (t0 where invalid)
    valid: torch.Tensor   # (..., max_roots) bool


def roots_in_interval(coeffs: torch.Tensor, t0, t1,
                      n_grid: int = DEFAULT_GRID,
                      n_bisections: int = DEFAULT_BISECTIONS
                      ) -> IntervalRoots:
    """All sign-crossing real roots of ``coeffs`` in [t0, t1], fixed shape.

    Args:
      coeffs: (..., L) increasing-power coefficients.
      t0, t1: scalars or tensors broadcastable to the batch shape.
      n_grid: number of grid cells for bracketing.
      n_bisections: bisection steps per bracket (always all of them).

    Returns:
      IntervalRoots with ``max_roots = L - 1`` slots, in ascending cell
      order; unused slots hold t0.
    """
    ell = coeffs.shape[-1]
    max_roots = max(ell - 1, 1)
    t0, t1 = _interval(coeffs, t0, t1, coeffs.shape[:-1])
    dtype, dev = coeffs.dtype, coeffs.device

    # Phase 1: the grid.  tau in [0, 1] keeps the grid's shape fixed.
    tau = torch.arange(n_grid + 1, dtype=dtype, device=dev) / n_grid
    tgrid = t0[..., None] + (t1 - t0)[..., None] * tau          # (..., G+1)
    vals = _polyval_raw(coeffs[..., None, :], tgrid)            # (..., G+1)

    lo_vals = vals[..., :-1]
    hi_vals = vals[..., 1:]
    crossing = (torch.sign(lo_vals) * torch.sign(hi_vals)) < 0
    bracket = crossing | (lo_vals == 0)                          # (..., G)

    # Up to max_roots bracketed cells in ascending order: the key puts them
    # first and keeps the cells' order (the keys are unique).
    cell_idx = torch.arange(n_grid, device=dev)
    key = torch.where(bracket, cell_idx, n_grid + cell_idx)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :max_roots]
    valid = torch.gather(bracket, -1, order)

    cell_w = (t1 - t0)[..., None] / n_grid
    lo = t0[..., None] + order.to(dtype) * cell_w                # (..., R)
    hi = lo + cell_w
    flo = torch.gather(lo_vals, -1, order)

    # Phase 2: bisection on every bracket; an exact zero at mid goes left.
    for _ in range(n_bisections):
        mid = 0.5 * (lo + hi)
        fmid = _polyval_raw(coeffs[..., None, :], mid)
        go_right = torch.sign(fmid) == torch.sign(flo)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
        flo = torch.where(go_right, fmid, flo)
    roots = torch.where(valid, 0.5 * (lo + hi), t0[..., None])
    return IntervalRoots(roots=roots, valid=valid)


def roots_companion(coeffs: np.ndarray) -> np.ndarray:
    """All complex roots via the companion matrix (NumPy, the tests'
    oracle).  Trailing (high-order) zero coefficients are trimmed as the
    reference's findLastNonZeroCoeff does (rpoly_ak1.cpp:70-117)."""
    c = np.asarray(coeffs, dtype=np.float64)
    nz = np.flatnonzero(np.abs(c) > 0)
    if nz.size == 0 or nz[-1] == 0:
        return np.zeros((0,), dtype=np.complex128)
    c = c[: nz[-1] + 1]
    deg = len(c) - 1
    comp = np.zeros((deg, deg))
    comp[1:, :-1] = np.eye(deg - 1)
    comp[:, -1] = -c[:-1] / c[-1]
    return np.linalg.eigvals(comp)


class IntervalMinMax(NamedTuple):
    t_min: torch.Tensor
    v_min: torch.Tensor
    t_max: torch.Tensor
    v_max: torch.Tensor


def _with_endpoints(r: IntervalRoots, t0, t1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(candidate times, valid mask): t0, t1, then the roots."""
    t0, t1 = _interval(r.roots, t0, t1, r.roots.shape[:-1])
    cand_t = torch.cat([t0[..., None], t1[..., None], r.roots], dim=-1)
    ends = torch.ones(t0.shape + (2,), dtype=torch.bool, device=t0.device)
    return cand_t, torch.cat([ends, r.valid], dim=-1)


def minmax_in_interval(coeffs: torch.Tensor, t0, t1, derivative: int = 0,
                       n_grid: int = DEFAULT_GRID,
                       n_bisections: int = DEFAULT_BISECTIONS
                       ) -> IntervalMinMax:
    """Min/max of the ``derivative``-th derivative over [t0, t1].

    Candidates: the interval's endpoints and the real roots of the
    (derivative+1)-th derivative (Polynomial::computeMinMax,
    polynomial.cpp:102-114).  Ties go to the first candidate.
    """
    n = coeffs.shape[-1]
    # the known-zero tail is dropped so that the root count stays tight
    dcoeffs = derivative_coefficients(coeffs, derivative + 1)
    dcoeffs = dcoeffs[..., : max(n - derivative - 1, 1)]
    r = roots_in_interval(dcoeffs, t0, t1, n_grid, n_bisections)
    cand_t, cand_valid = _with_endpoints(r, t0, t1)

    vals = polyval(coeffs[..., None, :], cand_t, derivative)
    big = torch.finfo(coeffs.dtype).max
    imin = torch.argmin(torch.where(cand_valid, vals, big), dim=-1,
                        keepdim=True)
    imax = torch.argmax(torch.where(cand_valid, vals, -big), dim=-1,
                        keepdim=True)

    def take(a, i):
        return torch.gather(a, -1, i)[..., 0]
    return IntervalMinMax(
        t_min=take(cand_t, imin), v_min=take(vals, imin),
        t_max=take(cand_t, imax), v_max=take(vals, imax))


def magnitude_candidate_polynomial(coeffs: torch.Tensor, derivative: int
                                   ) -> torch.Tensor:
    """Coefficients of d/dt ||x^(d)(t)||^2 / 2 = sum_dim x^(d) x^(d+1).

    Args:
      coeffs: (..., N, D) per-dimension monomial coefficients.
      derivative: derivative order d.

    Returns:
      (..., 2(N-d) - 2) product polynomial, summed over the dimensions
      (Segment::computeMinMaxMagnitudeCandidateTimes, segment.cpp:82-123).
    """
    coeffs = coeffs.transpose(-1, -2)                    # (..., D, N)
    n = coeffs.shape[-1]
    n_d = n - derivative
    d = derivative_coefficients(coeffs, derivative)[..., :n_d]
    dd = derivative_coefficients(coeffs, derivative + 1)[..., :n_d - 1]
    return convolve_full(d, dd).sum(dim=-2)


def magnitude_minmax_candidates(coeffs: torch.Tensor, derivative: int,
                                t0, t1, n_grid: int = DEFAULT_GRID,
                                n_bisections: int = DEFAULT_BISECTIONS
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate times for the extrema of ||x^(d)(t)|| over [t0, t1]:
    (times (..., 2 + max_roots), valid mask), the endpoints first, then the
    roots of the magnitude's derivative
    (Segment::computeMinMaxMagnitudeCandidateTimes, segment.cpp:82-133)."""
    conv = magnitude_candidate_polynomial(coeffs, derivative)
    r = roots_in_interval(conv, t0, t1, n_grid, n_bisections)
    return _with_endpoints(r, t0, t1)
