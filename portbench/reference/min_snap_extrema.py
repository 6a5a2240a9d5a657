"""Plain reference of the feasibility screen: the unconstrained minimum-snap
solve on the standard mask, and the maxima of ||x'(t)|| and ||x''(t)||.

Written from the problem's equations (the reference C++ ``solveLinear``,
linear_impl.h:337-379; ``computeMaximumOfMagnitude``, linear_impl.h:455-487;
``Segment::computeMinMaxMagnitudeCandidates``, segment.cpp:82-158) in plain
PyTorch, in any float dtype, on any device.  It imports nothing of the
program under test and takes nothing the program made: from the raw
waypoints and segment times it builds the standard mask (every waypoint's
position fixed, the start and the goal at rest up to derivative N/2-1, the
interior vertices' higher derivatives free), the cost in the endpoint
derivatives, and solves R_pp d_p = -R_pf d_f.

The maxima are found another way than the program's grid bracket: the
real roots in [0, 1] of d/dtau ||x^(d)||^2 / 2 (in unit time tau = t / T,
degree 2N - 2d - 3) are the eigenvalues of its companion matrix, their real
parts clamped to the segment and polished by Newton steps, and the
segment's two ends are added.  Every candidate lies in the segment, so the
largest magnitude among them can never exceed the true maximum; it reaches
it wherever the eigenvalues find the critical points.  ``sampled_maxima``,
the magnitude on a dense grid, is the lower bound it is held to.

Functions:
  * ``screen`` -- the solve and both maxima of a block of rows;
  * ``solve`` -- coefficients and cost of the standard-mask solve;
  * ``magnitude_maxima`` -- the largest ||x^(d)|| of given coefficients;
  * ``sampled_maxima`` -- the same on ``per_segment`` points a segment.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .tube_qcqp import (_c, falling_factorials, hessian_unit, mapping_unit,
                        row_orders, snap_cost)

#: Newton steps that polish each eigenvalue's real part.
NEWTON_STEPS = 4


def standard_maps(k: int, n: int):
    """Columns of the standard mask: fixed = the start's and the goal's
    derivatives 0..h-1 and every interior vertex's position, free = the
    interior vertices' derivatives 1..h-1, as (vertex, derivative) lists;
    ``gather[s, r]`` is the column of segment s's row r (r < h: derivative r
    at vertex s, else derivative r - h at vertex s + 1)."""
    h = n // 2
    fixed = [(v, j) for v in range(k + 1) for j in range(h)
             if v in (0, k) or j == 0]
    free = [(v, j) for v in range(1, k) for j in range(1, h)]
    col = {vc: i for i, vc in enumerate(fixed + free)}
    gather = np.zeros((k, n), dtype=np.int64)
    for s in range(k):
        for j in range(h):
            gather[s, j] = col[(s, j)]
            gather[s, h + j] = col[(s + 1, j)]
    return fixed, free, gather


def solve(waypoints: torch.Tensor, times: torch.Tensor, n: int = 10,
          d: int = 4) -> Dict[str, torch.Tensor]:
    """The minimum-``d``-derivative trajectory through ``waypoints``
    (B, K+1, 3) with segment times ``times`` (B, K), at rest at its ends:
    coefficients (B, K, N, 3) in real time and cost 0.5 sum c^T Q c (B,),
    in the dtype and on the device of ``times``."""
    bsz, k = times.shape
    fixed, free, gather = standard_maps(k, n)
    nf, n_tot = len(fixed), len(fixed) + len(free)
    d_fixed = torch.zeros((bsz, nf, 3), dtype=times.dtype, device=times.device)
    for i, (v, j) in enumerate(fixed):
        if j == 0:
            d_fixed[:, i] = waypoints[:, v]
    onehot = np.zeros((k, n, n_tot))
    for s in range(k):
        onehot[s, np.arange(n), gather[s]] = 1.0
    m_hot = _c(onehot, times)
    # the cost in segment s's endpoint derivatives: T^(1-2d) D H_hat D with
    # D = diag(T^i) of each row's derivative order i
    tpow = times[..., None] ** _c(row_orders(n), times)
    hk = ((times ** (1 - 2 * d))[..., None, None] * tpow[..., :, None]
          * tpow[..., None, :] * _c(hessian_unit(n, d), times))
    r = torch.einsum('kru,zkrc,kcv->zuv', m_hot, hk, m_hot)
    r_pf, r_pp = r[:, nf:, :nf], r[:, nf:, nf:]
    # Jacobi equilibration: R's entries span many decades of T
    scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))
    r_eq = r_pp * scale[:, :, None] * scale[:, None, :]
    d_free = torch.linalg.solve(r_eq, -(r_pf @ d_fixed) * scale[:, :, None]
                                ) * scale[:, :, None]
    d_all = torch.cat([d_fixed, d_free], dim=1)
    d_seg = d_all[:, torch.as_tensor(gather.reshape(-1), device=d_all.device)
                  ].reshape(bsz, k, n, 3)
    jpow = times[..., None] ** _c(np.arange(n, dtype=np.float64), times)
    coeffs = torch.einsum('ij,bkjd->bkid', _c(np.linalg.inv(mapping_unit(n)),
                                              times),
                          d_seg * tpow[..., None]) / jpow[..., None]
    return dict(coefficients=coeffs, cost=snap_cost(coeffs, times, d))


def _derivative(p: torch.Tensor, d: int) -> torch.Tensor:
    """The d-th derivative of polynomials p (..., L) in increasing powers:
    (..., L - d)."""
    ell = p.shape[-1]
    return p[..., d:] * _c(falling_factorials(ell)[d, d:], p)


def _multiply(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The product of polynomials p (..., P) and q (..., Q): (..., P+Q-1)."""
    out = torch.zeros(p.shape[:-1] + (p.shape[-1] + q.shape[-1] - 1,),
                      dtype=p.dtype, device=p.device)
    for j in range(q.shape[-1]):
        out[..., j:j + p.shape[-1]] += p * q[..., j:j + 1]
    return out


def _horner(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """p (..., L) at points t (..., C): (..., C)."""
    acc = torch.zeros_like(t) + p[..., -1:]
    for j in range(p.shape[-1] - 2, -1, -1):
        acc = acc * t + p[..., j:j + 1]
    return acc


def _unit_time(coeffs: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """(B, K, 3, N) coefficients of x(T tau) per dimension."""
    n = coeffs.shape[-2]
    tj = times[..., None] ** _c(np.arange(n, dtype=np.float64), times)
    return (coeffs * tj[..., None]).transpose(-1, -2)


def _real_roots_in_unit(p: torch.Tensor) -> torch.Tensor:
    """(..., L-1) points of [0, 1]: the real parts of p's roots (p (..., L)
    in increasing powers), clamped and polished by Newton steps.  A root
    off the real axis gives a point of [0, 1] too, which is harmless: every
    point is a candidate, not a claim."""
    scale = p.abs().amax(-1, keepdim=True)
    tiny = 1e-13 * scale
    lead = p[..., -1:]
    # a vanishing leading coefficient: its roots go far off, the others stay
    lead = torch.where(lead.abs() < tiny,
                       torch.where(lead < 0, -tiny, tiny), lead)
    lead = torch.where(scale > 0, lead, torch.ones_like(lead))
    deg = p.shape[-1] - 1
    comp = torch.zeros(p.shape[:-1] + (deg, deg), dtype=p.dtype,
                       device=p.device)
    comp[..., 1:, :-1] = torch.eye(deg - 1, dtype=p.dtype, device=p.device)
    comp[..., :, -1] = -p[..., :-1] / lead
    t = torch.linalg.eigvals(comp).real.clamp(0.0, 1.0)
    dp = _derivative(p, 1)
    for _ in range(NEWTON_STEPS):
        f, g = _horner(p, t), _horner(dp, t)
        step = torch.where(g != 0, f / torch.where(g != 0, g, 1.0), 0.0)
        t = (t - step).clamp(0.0, 1.0)
    return t


def magnitude_maxima(coeffs: torch.Tensor, times: torch.Tensor,
                     derivative: int) -> torch.Tensor:
    """(B,) the largest ||x^(d)(t)|| over every segment of monomial
    coefficients (B, K, N, 3) with times (B, K): candidates are the
    segments' ends and the critical points of ||x^(d)||^2 (module
    docstring)."""
    a = _unit_time(coeffs, times)                          # (B, K, 3, N)
    xd = _derivative(a, derivative)
    crit = _multiply(xd, _derivative(a, derivative + 1)).sum(-2)  # (B, K, L)
    t = _real_roots_in_unit(crit)
    ends = torch.tensor([0.0, 1.0], dtype=t.dtype, device=t.device)
    cand = torch.cat([ends.expand(t.shape[:-1] + (2,)), t], dim=-1)
    mag = torch.linalg.vector_norm(_horner(xd, cand[..., None, :]), dim=-2)
    return (mag.amax(-1) * times ** (-derivative)).amax(-1)


def sampled_maxima(coeffs: torch.Tensor, times: torch.Tensor,
                   derivative: int, per_segment: int = 2048,
                   rows: int = 64) -> torch.Tensor:
    """(B,) the largest ||x^(d)|| on ``per_segment`` evenly spaced points of
    every segment, ends included, ``rows`` rows at a time: a lower bound of
    the maximum."""
    xd = _derivative(_unit_time(coeffs, times), derivative)
    tau = torch.linspace(0.0, 1.0, per_segment, dtype=coeffs.dtype,
                         device=coeffs.device)
    out = []
    for i in range(0, xd.shape[0], rows):
        vals = _horner(xd[i:i + rows], tau.expand(xd[i:i + rows].shape[:-1]
                                                  + (per_segment,)))
        mag = torch.linalg.vector_norm(vals, dim=-2).amax(-1)
        out.append((mag * times[i:i + rows] ** (-derivative)).amax(-1))
    return torch.cat(out)


def screen(waypoints: torch.Tensor, times: torch.Tensor, n: int = 10,
           d: int = 4, derivatives: Sequence[int] = (1, 2),
           block: int = 1024) -> Dict[str, torch.Tensor]:
    """The solve and the maxima of ``derivatives`` of rows (B, ...) in
    blocks of ``block`` rows: coefficients, cost, and ``max_<d>`` (B,) for
    each derivative d."""
    parts = []
    for i in range(0, times.shape[0], block):
        sol = solve(waypoints[i:i + block], times[i:i + block], n, d)
        for der in derivatives:
            sol[f"max_{der}"] = magnitude_maxima(sol["coefficients"],
                                                 times[i:i + block], der)
        parts.append(sol)
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
