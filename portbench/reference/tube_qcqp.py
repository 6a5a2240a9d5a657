"""Plain reference of the tube-constrained minimum-snap QCQP.

Written from the problem's equations (the reference C++
``polynomial_optimization_qcqp.h`` / ``qcqp_impl.h``: spheres at interior
vertices, tubes and end caps on the mid Bezier control points of every
segment) in plain PyTorch, in any float dtype, on any device.  It imports
nothing of the program under test and takes nothing the program made: from
the raw inputs (waypoints, segment times, radii, fixed derivatives, vertex
values) it builds again the structure's maps, the cost Hessians, the
control-point maps, the equilibrated constraint system, the position-
constrained warm start, and runs the same over-relaxed ADMM on a dense KKT
inverse.

Functions:
  * ``admm`` -- the ADMM solve of a block of rows (the float64 answer the
    program's float32 solve is held to);
  * ``corridor_violation`` -- the largest violation of the corridor by given
    monomial coefficients, through their Bernstein control points;
  * ``trajectory`` -- the coefficients that given free derivatives define;
  * ``snap_cost`` -- 0.5 sum_k c^T Q(T_k) c of given coefficients;
  * ``rest_to_rest_violation`` -- the corridor violation of the witness
    that stops at every waypoint and runs along the straight segments: below
    zero whenever every radius is positive, so every such row is feasible.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Constants (float64 NumPy, cast to the working dtype on use)
# ---------------------------------------------------------------------------

def falling_factorials(n: int) -> np.ndarray:
    """bc[d, j] = j! / (j - d)! for j >= d, else 0."""
    bc = np.zeros((n, n))
    for d in range(n):
        for j in range(d, n):
            bc[d, j] = math.factorial(j) / math.factorial(j - d)
    return bc


def mapping_unit(n: int) -> np.ndarray:
    """A(T=1): rows 0..h-1 sample derivative i at t=0, rows h..2h-1 at t=1,
    of the monomial coefficients c_0 .. c_{n-1}."""
    h = n // 2
    bc = falling_factorials(n)
    a = np.zeros((n, n))
    for i in range(h):
        a[i, i] = bc[i, i]
        a[h + i, i:] = bc[i, i:]
    return a


def row_orders(n: int) -> np.ndarray:
    h = n // 2
    return np.concatenate([np.arange(h), np.arange(h)]).astype(np.float64)


def cost_unit(n: int, d: int) -> np.ndarray:
    """2 x the Gram of the d-th derivative over [0, 1] (cost = 0.5 c^T Q c)."""
    bc = falling_factorials(n)
    q = np.zeros((n, n))
    for r in range(d, n):
        for c in range(d, n):
            q[r, c] = 2.0 * bc[d, r] * bc[d, c] / (r + c + 1 - 2 * d)
    return q


def hessian_unit(n: int, d: int) -> np.ndarray:
    """A^-T Q A^-1 at T = 1: the cost in endpoint derivatives."""
    ainv = np.linalg.inv(mapping_unit(n))
    h = ainv.T @ cost_unit(n, d) @ ainv
    return 0.5 * (h + h.T)


def bernstein_from_monomial(n: int) -> np.ndarray:
    """Control points of x(T tau) = sum_i a_i tau^i: cp_j = sum_{i<=j}
    C(j, i) / C(n-1, i) a_i."""
    deg = n - 1
    b = np.zeros((n, n))
    for j in range(n):
        for i in range(j + 1):
            b[j, i] = math.comb(j, i) / math.comb(deg, i)
    return b


def free_interior_maps(k: int, n: int):
    """Columns of the free-interior family: fixed = every derivative
    0..h-1 of the start and the goal, free = every derivative of the
    interior vertices, each sorted by (vertex, derivative); ``gather[k, r]``
    is the column of segment k's row r (r < h: derivative r at vertex k,
    else derivative r - h at vertex k + 1)."""
    h = n // 2
    fixed = [(0, j) for j in range(h)] + [(k, j) for j in range(h)]
    free = [(v, j) for v in range(1, k) for j in range(h)]
    col = {vc: i for i, vc in enumerate(fixed + free)}
    gather = np.zeros((k, n), dtype=np.int64)
    for s in range(k):
        for j in range(h):
            gather[s, j] = col[(s, j)]
            gather[s, h + j] = col[(s + 1, j)]
    return fixed, free, gather


def _c(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Checks of given coefficients
# ---------------------------------------------------------------------------

def control_points(coeffs: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """(B, K, N, 3) Bernstein control points of monomial coefficients."""
    n = coeffs.shape[-2]
    tpow = times[..., None] ** _c(np.arange(n, dtype=np.float64), times)
    return torch.einsum('ji,bki,bkid->bkjd',
                        _c(bernstein_from_monomial(n), coeffs),
                        tpow, coeffs)


def corridor_violation_of_points(cp: torch.Tensor, waypoints: torch.Tensor,
                                 radii: torch.Tensor) -> torch.Tensor:
    """(B,) the largest violation of the corridor by control points cp
    (B, K, N, 3): spheres |cp_{N-1}(k) - w_{k+1}| <= r2_k (k < K-1), tubes
    |P_k (cp_j(k) - w_k)| <= r1_k and the end caps -n_k.(cp_j - s_k) <= 0,
    n_k.(cp_j - e_k) <= 0 on the mid control points j = 1..N-2, with
    s_k = w_k - n_k r_prev, e_k = w_{k+1} + n_k r2_k, r_prev = r2_{k-1}
    (r1_0 for the first segment)."""
    k = cp.shape[1]
    n = cp.shape[2]
    p0, p1 = waypoints[:, :-1], waypoints[:, 1:]
    seg = p1 - p0
    nv = seg / torch.clamp(torch.linalg.vector_norm(seg, dim=-1,
                                                    keepdim=True), min=1e-12)
    mid = cp[:, :, 1:n - 1]                                # (B, K, M, 3)
    rel = mid - p0[:, :, None]
    along = (rel * nv[:, :, None]).sum(-1, keepdim=True)
    perp = torch.linalg.vector_norm(rel - along * nv[:, :, None], dim=-1)
    tube = (perp - radii[:, :, None, 0]).amax(dim=(1, 2))
    sphere = (torch.linalg.vector_norm(cp[:, :k - 1, n - 1] - waypoints[:, 1:k],
                                       dim=-1) - radii[:, :k - 1, 1]).amax(1)
    r_prev = torch.cat([radii[:, :1, 0], radii[:, :-1, 1]], dim=1)
    s = p0 - nv * r_prev[..., None]
    e = p1 + nv * radii[:, :, 1:2]
    cap0 = (-(mid - s[:, :, None]) * nv[:, :, None]).sum(-1).amax(dim=(1, 2))
    cap1 = ((mid - e[:, :, None]) * nv[:, :, None]).sum(-1).amax(dim=(1, 2))
    return torch.stack([tube, sphere, cap0, cap1]).amax(0)


def corridor_violation(coeffs, times, waypoints, radii) -> torch.Tensor:
    """(B,) the corridor violation of monomial coefficients (B, K, N, 3)."""
    return corridor_violation_of_points(control_points(coeffs, times),
                                        waypoints, radii)


def rest_to_rest_violation(waypoints: torch.Tensor, radii: torch.Tensor,
                           n: int) -> torch.Tensor:
    """(B,) the corridor violation of the trajectory that rests at every
    waypoint and runs straight between them: its first N/2 control points
    are w_k and its last N/2 are w_{k+1}, so it hits every fixed start and
    goal derivative and is feasible wherever the result is below zero."""
    h = n // 2
    p0, p1 = waypoints[:, :-1], waypoints[:, 1:]
    cp = torch.cat([p0[:, :, None].expand(-1, -1, h, -1),
                    p1[:, :, None].expand(-1, -1, h, -1)], dim=2)
    return corridor_violation_of_points(cp, waypoints, radii)


def trajectory(d_fixed: torch.Tensor, d_free: torch.Tensor,
               times: torch.Tensor) -> torch.Tensor:
    """(B, K, N, 3) monomial coefficients of the free-interior trajectory
    with the start's and goal's derivatives ``d_fixed`` (B, N, 3) and the
    interior vertices' ``d_free`` (B, (K-1) N/2, 3), in (vertex,
    derivative) order: c = A(T)^-1 d per segment."""
    bsz, k = times.shape
    n = d_fixed.shape[1]
    _, _, gather = free_interior_maps(k, n)
    d_all = torch.cat([d_fixed, d_free], dim=1)
    d_seg = d_all[:, torch.as_tensor(gather.reshape(-1),
                                     device=d_all.device)].reshape(bsz, k, n, 3)
    tpow = times[..., None] ** _c(row_orders(n), times)
    jpow = times[..., None] ** _c(np.arange(n, dtype=np.float64), times)
    return torch.einsum('ij,bkjd->bkid', _c(np.linalg.inv(mapping_unit(n)),
                                           times),
                        d_seg * tpow[..., None]) / jpow[..., None]


def snap_cost(coeffs: torch.Tensor, times: torch.Tensor, d: int = 4
              ) -> torch.Tensor:
    """(B,) 0.5 sum_k sum_dim c^T Q(T_k) c with Q(T) = T^(1-2d) diag(T^j)
    Qhat diag(T^j)."""
    n = coeffs.shape[-2]
    tj = times[..., None] ** _c(np.arange(n, dtype=np.float64), times)
    sc = coeffs * tj[..., None]
    per_seg = torch.einsum('bkid,ij,bkjd->bk', sc, _c(cost_unit(n, d), sc), sc)
    return 0.5 * (per_seg * times ** (1 - 2 * d)).sum(-1)


# ---------------------------------------------------------------------------
# The ADMM solve
# ---------------------------------------------------------------------------

def admm(waypoints, times, radii, d_fixed, cfg: Dict) -> Dict[str, torch.Tensor]:
    """The ADMM answer for a block of free-interior rows, in the dtype and on
    the device of ``times``.

    Args: waypoints (B, K+1, 3) (the interior ones are the warm start's
    positions and the corridor's axis), times (B, K), radii (B, K, 2)
    (tube r1, sphere r2), d_fixed (B, N, 3) (start then goal derivatives
    0..N/2-1); cfg: rho, sigma, alpha, n_iters, n_stages, rho_min,
    rho_max, rho_sphere_factor, rho_tube_factor, rho_half_factor,
    n_coefficients, derivative.

    Returns coefficients (B, K, N, 3), d_free (B, n_free, 3), cost (B,),
    violation (B,)."""
    dt, dev = times.dtype, times.device
    bsz, k = times.shape
    n = int(cfg["n_coefficients"])
    h = n // 2
    dd = int(cfg["derivative"])
    fixed, free, gather = free_interior_maps(k, n)
    nf, n_free = len(fixed), len(free)
    n_tot = nf + n_free
    onehot = np.zeros((k, n, n_tot))
    for s in range(k):
        onehot[s, np.arange(n), gather[s]] = 1.0
    m_hot = _c(onehot, times)
    iord = _c(row_orders(n), times)

    # Cost in the compact derivatives: R = sum_k M_k^T H_k M_k.
    tpow = times[..., None] ** iord                        # (B, K, N)
    hk = ((times ** (1 - 2 * dd))[..., None, None] * tpow[..., :, None]
          * tpow[..., None, :] * _c(hessian_unit(n, dd), times))
    r = torch.einsum('kru,zkrc,kcv->zuv', m_hot, hk, m_hot)
    r_pf, r_pp = r[:, nf:, :nf], r[:, nf:, nf:]
    q_lin = r_pf @ d_fixed
    d_scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))
    p_eq = r_pp * d_scale[:, :, None] * d_scale[:, None, :]
    q_eq = q_lin * d_scale[:, :, None]

    # Warm start: the interior positions pinned to the waypoints, the rest
    # the minimum of the cost given them.
    pos = [i for i, (v, j) in enumerate(free) if j == 0]
    rest = [i for i, (v, j) in enumerate(free) if j != 0]
    pos_t = torch.as_tensor(pos, device=dev)
    rest_t = torch.as_tensor(rest, device=dev)
    r_rr = r_pp[:, rest_t][:, :, rest_t]
    r_rp = r_pp[:, rest_t][:, :, pos_t]
    wp_int = waypoints[:, 1:-1]
    x_r = torch.linalg.solve(r_rr, -(q_lin[:, rest_t] + r_rp @ wp_int))
    x0 = torch.zeros((bsz, n_free, 3), dtype=dt, device=dev)
    x0[:, pos_t] = wp_int
    x0[:, rest_t] = x_r
    x_flat = (x0 / d_scale[:, :, None]).reshape(bsz, -1)

    # Control points as affine maps of the free derivatives: cp = cp0 + Ecp x.
    binv = _c(bernstein_from_monomial(n) @ np.linalg.inv(mapping_unit(n)),
              times)
    binv_t = binv[None, None] * tpow[:, :, None, :]        # (B, K, N, N)
    cp0 = torch.einsum('bkjr,krf,bfd->bkjd', binv_t, m_hot[:, :, :nf], d_fixed)
    ecp = torch.einsum('bkjr,krp->bkjp', binv_t, m_hot[:, :, nf:])

    # The constraints: y = G x + g in a ball (spheres, tubes) or <= 0 (caps).
    p0, p1 = waypoints[:, :-1], waypoints[:, 1:]
    seg = p1 - p0
    nv = seg / torch.clamp(torch.linalg.vector_norm(seg, dim=-1, keepdim=True),
                           min=1e-12)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    proj = eye3 - nv[..., :, None] * nv[..., None, :]
    mid = slice(1, n - 1)
    n_mid = n - 2
    ecp_s = ecp * d_scale[:, None, None, :]
    g_sph = ecp_s[:, :k - 1, n - 1][:, :, None, :, None] * eye3[:, None, :]
    b_sph = cp0[:, :k - 1, n - 1] - waypoints[:, 1:k]
    g_tube = torch.einsum('bkid,bkjp->bkjipd', proj, ecp_s[:, :, mid])
    b_tube = torch.einsum('bkid,bkjd->bkji', proj, cp0[:, :, mid]
                          - p0[:, :, None])
    dirs = torch.stack([-nv, nv], dim=2)                   # (B, K, 2, 3)
    r_prev = torch.cat([radii[:, :1, 0], radii[:, :-1, 1]], dim=1)
    caps = torch.stack([p0 - nv * r_prev[..., None],
                        p1 + nv * radii[:, :, 1:2]], dim=2)
    g_half = torch.einsum('bksd,bkjp->bkjspd', dirs, ecp_s[:, :, mid])
    b_half = (torch.einsum('bksd,bkjd->bkjs', dirs, cp0[:, :, mid])
              - (dirs * caps).sum(-1)[:, :, None, :])
    gb = torch.cat([g_sph, g_tube.reshape(bsz, k * n_mid, 3, n_free, 3)], 1)
    bb = torch.cat([b_sph, b_tube.reshape(bsz, k * n_mid, 3)], 1)
    rb = torch.cat([radii[:, :k - 1, 1],
                    radii[:, :, :1].expand(bsz, k, n_mid).reshape(bsz, -1)], 1)
    gh = g_half.reshape(bsz, k * n_mid * 2, n_free, 3)
    bh = b_half.reshape(bsz, -1)

    # Row equilibration, clamped, times sqrt(the family's penalty factor).
    lo, hi = (1e-2, 1e2) if n <= 10 else (1e-4, 1e4)
    sb = 1.0 / torch.clamp(torch.sqrt((gb ** 2).sum(dim=(2, 3, 4)) / 3.0),
                           lo, hi)
    sh = 1.0 / torch.clamp(torch.sqrt((gh ** 2).sum(dim=(2, 3))), lo, hi)
    n_ball = gb.shape[1]
    fac = torch.full((n_ball,), math.sqrt(cfg["rho_tube_factor"]), dtype=dt,
                     device=dev)
    fac[:k - 1] = math.sqrt(cfg["rho_sphere_factor"])
    sb = sb * fac
    sh = sh * math.sqrt(cfg["rho_half_factor"])
    mb = 3 * n_ball
    nfd = 3 * n_free
    g_all = torch.cat([(gb * sb[:, :, None, None, None]).transpose(1, 2)
                       .reshape(bsz, mb, nfd),
                       (gh * sh[:, :, None, None]).reshape(bsz, -1, nfd)], 1)
    b_all = torch.cat([(bb * sb[:, :, None]).transpose(1, 2).reshape(bsz, mb),
                       bh * sh], 1)
    rbs = rb * sb

    def project(v):
        vb = v[:, :mb].reshape(bsz, 3, n_ball)
        sq = (vb * vb).sum(1)
        scale = torch.where(sq > rbs * rbs,
                            rbs / torch.sqrt(torch.clamp(sq, min=1e-30)),
                            torch.ones_like(sq))
        return torch.cat([(vb * scale[:, None]).reshape(bsz, mb),
                          torch.clamp(v[:, mb:], max=0.0)], 1)

    def mv(mat, vec):
        return (mat @ vec[:, :, None])[:, :, 0]

    # Over-relaxed ADMM in stages, rho rebalanced between them.
    p_big = torch.einsum('bpq,cd->bpcqd', p_eq, eye3).reshape(bsz, nfd, nfd)
    q_flat = q_eq.reshape(bsz, nfd)
    g_t = g_all.transpose(1, 2)
    gtg = g_t @ g_all
    eye = torch.eye(nfd, dtype=dt, device=dev)
    alpha = float(cfg["alpha"])
    rho = torch.full((bsz,), float(cfg["rho"]), dtype=dt, device=dev)
    x = x_flat
    z = project(mv(g_all, x) + b_all)
    u = torch.zeros_like(z)
    for stage in range(int(cfg["n_stages"])):
        w_inv = torch.linalg.inv(p_big + rho[:, None, None] * gtg
                                 + float(cfg["sigma"]) * eye)
        wgt = w_inv @ g_t
        xq = -mv(w_inv, q_flat)
        z_prev = z
        for _ in range(int(cfg["n_iters"])):
            x = xq + rho[:, None] * mv(wgt, z - u - b_all)
            y = mv(g_all, x) + b_all
            y_rel = alpha * y + (1 - alpha) * z
            z_prev = z
            z = project(y_rel + u)
            u = u + y_rel - z
        if stage + 1 < int(cfg["n_stages"]):
            prim = (y - z).abs().amax(-1)
            dual = rho * mv(g_t, z - z_prev).abs().amax(-1)
            ratio = torch.sqrt(torch.clamp(prim, min=1e-30)
                               / torch.clamp(dual, min=1e-30))
            new_rho = torch.clamp(rho * ratio, float(cfg["rho_min"]),
                                  float(cfg["rho_max"]))
            u = u * (rho / new_rho)[:, None]
            rho = new_rho

    d_free = x.reshape(bsz, n_free, 3) * d_scale[:, :, None]
    coeffs = trajectory(d_fixed, d_free, times)
    return dict(coefficients=coeffs, d_free=d_free,
                cost=snap_cost(coeffs, times, dd),
                violation=corridor_violation(coeffs, times, waypoints, radii))
