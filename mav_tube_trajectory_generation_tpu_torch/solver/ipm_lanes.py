"""Plane-layout batched interior-point method: the strict-feasibility polish.

Counterpart of the JAX package's ``solver/ipm_lanes.py``.  A primal-dual
interior-point method (Mehrotra predictor-corrector or single-direction
steps, fraction-to-boundary, best-iterate tracking, Farkas-style
infeasibility evidence) for the tube-constrained QCQP:

  * The constraint system lives in the same padded component-plane layout as
    the ADMM stage (``solver.qcqp._PadLayout``: lanes [ball-x | ball-y |
    ball-z | half], packed half rows in the ball planes' tails), assembled
    once by ``qcqp._padded_constraint_system`` or taken over from the ADMM
    solve (``pre=``); no per-step Jacobian is materialized.
  * Per Newton step one kernel pass (``ops.ipm_kernel.ipm_eval_step``) emits
    y, c, the Jacobian-transposed right-hand-side pieces and the band of the
    weighted Gram; plain batched PyTorch handles only small tensors (the
    block-tridiagonal band factor, the factored solves, the step logic), and
    the G dx products go through ``ops.ipm_kernel.gt_matvec``.  The pipelined
    schedule (``IPMConfig.pipelined``) moves the solve, the update and the
    evaluation into one kernel per step (``ops.ipm_kernel.ipm_pipe_step``),
    and ``IPMConfig.fused`` the whole polish, band factor included, into one
    launch (``ops.ipm_kernel.ipm_solve_fused``).
  * Slacks and multipliers are lane vectors (ball values replicated over the
    3 planes, pads pinned inert), so every per-constraint update is
    elementwise and the step-length and complementarity reductions are single
    lane reductions with static count weights.

float32 throughout.  All tensors carry a flat leading batch axis.

Two float32 findings of the reference are load-bearing and kept: the band
solve is Jacobi-equilibrated (the unscaled factor flips dx to an ascent
direction on stiff active sets), and every snap sweep gets a fresh factor.
Updates select with ``torch.where`` and never multiply by a 0/1 mask, so a
blown-up direction freezes its own scenario and nothing else.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .._tensors import DeviceLike, as_tensor, const, resolve_device
from ..ops import ipm_kernel
from . import banded, linear
from .ipm import IPMConfig, _static_certificate
from .qcqp import (ADMMConfig, QCQPSolution, _PadLayout, _Pre,
                   _flagship_layout, _objective_blocks,
                   _padded_constraint_system, penalty_unscale_maps,
                   solve_qcqp_batch)
from .structure import ProblemStructure


class _LaneMaps(NamedTuple):
    act: np.ndarray        # (m_p,) 1.0 on real constraint lanes, 0 pads
    cw: np.ndarray         # (m_p,) count weights: 1 on plane-0 balls + halves
    lane_src: np.ndarray   # (m_p,) int32 into [ball | half | zero-pad]
    half_lane: np.ndarray  # (n_half,) int32 lane index of half row h


_LANE_MAP_CACHE: Dict[_PadLayout, _LaneMaps] = {}


def _lane_maps(layout: _PadLayout) -> _LaneMaps:
    maps = _LANE_MAP_CACHE.get(layout)
    if maps is not None:
        return maps
    m_p, nb_p, n_ball, n_half = (layout.m_p, layout.nb_p, layout.n_ball,
                                 layout.n_half)
    act = np.zeros(m_p, np.float32)
    cw = np.zeros(m_p, np.float32)
    lane_src = np.full(m_p, n_ball + n_half, np.int32)
    half_lane = np.zeros(n_half, np.int32)
    for c in range(3):
        act[c * nb_p:c * nb_p + n_ball] = 1.0
        lane_src[c * nb_p:c * nb_p + n_ball] = np.arange(n_ball)
    cw[:n_ball] = 1.0
    for (c, lane0, off, ln) in layout.half_chunks():
        base = c * nb_p if c < 3 else 3 * nb_p
        lanes = base + lane0 + np.arange(ln)
        act[lanes] = 1.0
        cw[lanes] = 1.0
        lane_src[lanes] = n_ball + off + np.arange(ln)
        half_lane[off:off + ln] = lanes
    maps = _LaneMaps(act=act, cw=cw, lane_src=lane_src, half_lane=half_lane)
    _LANE_MAP_CACHE[layout] = maps
    return maps


def _finite_step_mask(alpha, ds, dlam):
    """Per-scenario update gate: True only where the step length is positive
    and the Newton direction is finite.

    A NaN direction makes every fraction-to-boundary ratio inf (NaN < 0
    compares False), so alpha alone comes back as a finite 1.0 and an
    ``isfinite(alpha)`` guard never fires -- the NaN must be caught on the
    direction itself or it permanently poisons the running s/lam/y state.
    dx finiteness is implied: ds and dlam both contain G dx terms.
    """
    finite = (torch.isfinite(ds) & torch.isfinite(dlam)).all(
        dim=-1, keepdim=True)
    return (alpha > 0) & finite


_c_lanes = ipm_kernel._c_lanes_k
_jdx_lanes = ipm_kernel._jdx_lanes_k


def _equilibrated_band_factor(hd, hu):
    """Jacobi-equilibrated block-LDL^T factors of the band (hd (B, m, b, b),
    hu (B, m-1, b, b)): (s_inv list, t list, d (B, n)) with d the scale.

    The penalty / complementarity-weighted Newton Hessians put O(rho)
    entries next to O(1) curvature blocks; the unpivoted float32 factor
    loses the solve at that spread (dx flips to an ascent direction on
    scenarios with a stiff active set).  Scaling to a unit diagonal first
    (D H D, the band transformed in place) bounds the factored system's
    condition.  A pivot block that is not positive definite to working
    precision still gets the inverse of what it holds, and non-finite
    entries stay with their own scenario (``ops.linalg.spd_inverse``).
    """
    bsz, m, blk, _ = hd.shape
    diag = torch.diagonal(hd, dim1=-2, dim2=-1).reshape(bsz, -1)
    d = torch.rsqrt(torch.clamp(diag, min=1e-30))          # (B, n)
    db = d.reshape(bsz, m, blk)
    hd_s = hd * db[:, :, :, None] * db[:, :, None, :]
    hu_s = hu * db[:, :-1, :, None] * db[:, 1:, None, :]
    s_inv, t_fac = banded.spd_block_tridiag_factor(hd_s, hu_s)
    return s_inv, t_fac, d


def _equilibrated_band_solve(hd, hu):
    """Jacobi-equilibrated block-tridiagonal factor; returns a
    solve(rhs_col (B, n, 1)) closure over the factors."""
    s_inv, t_fac, d = _equilibrated_band_factor(hd, hu)

    def solve(rhs_col):
        z = banded.spd_block_tridiag_solve_factored(
            s_inv, t_fac, rhs_col * d[:, :, None])
        return z * d[:, :, None]

    return solve


def _pe_band(p_eq, dim: int, blk: int):
    """Kron-expanded band of kron(p_eq, I_dim): (B, m, blk, blk) diagonal
    and (B, m-1, blk, blk) super blocks."""
    b = p_eq.shape[0]
    bp = blk // dim
    m_blk = p_eq.shape[-1] // bp
    eye_d = torch.eye(dim, dtype=p_eq.dtype, device=p_eq.device)
    pe = p_eq.reshape(b, m_blk, bp, m_blk, bp)
    pe_d = torch.stack([pe[:, i, :, i, :] for i in range(m_blk)], dim=1)
    pe_u = torch.stack([pe[:, i, :, i + 1, :] for i in range(m_blk - 1)],
                       dim=1)

    def kron(a):
        return torch.einsum('smab,cd->smacbd', a, eye_d).reshape(
            b, a.shape[1], blk, blk)

    return kron(pe_d).contiguous(), kron(pe_u).contiguous()


def _lanes_setup(structure, d_fixed, times, waypoints, radii, x0, layout):
    """Objective blocks + padded constraint system of a batch (float32)."""
    obj_cfg = ADMMConfig()          # only .sigma is read (cold-start solve)
    p_eq, q_eq, d_scale, x_init = _objective_blocks(
        structure, d_fixed, times, obj_cfg, x0)
    gt, b_pad, rb, sb, sh = _padded_constraint_system(
        structure, times, d_fixed, waypoints, radii, d_scale, layout)
    return p_eq, q_eq, d_scale, x_init, gt, b_pad, rb, sb, sh


def solve_qcqp_ipm_lanes(structure: ProblemStructure, d_fixed, times,
                         waypoints, radii,
                         config: IPMConfig = IPMConfig(),
                         x0=None, lam0_ball=None, lam0_half=None,
                         pre: Optional[_Pre] = None, pre_penalty=None,
                         device: DeviceLike = None) -> QCQPSolution:
    """Batched plane-layout IPM solve (all array args carry a leading batch
    axis), float32, for the flagship family (free interior, D = 3,
    block-tridiagonal KKT).

    x0: (B, n_free, 3) free derivatives to start from (else the
    unconstrained minimum).  lam0_ball (B, n_ball, 3) / lam0_half
    (B, n_half): dual warm start in the solution's convention, e.g. an ADMM
    solution's ``dual_ball`` / ``dual_half``; pass both or neither.

    ``pre``: the bundle ``solve_qcqp_batch(_return_pre=True)`` returns -- the
    ADMM's already-assembled padded system.  Its row scales carry the ADMM's
    per-family penalty factors (sqrt(f) baked in); pass the (f_sphere,
    f_tube, f_half) triple as ``pre_penalty`` and the system is converted
    back to the penalty-free form by static per-lane multipliers
    (``qcqp.penalty_unscale_maps``) instead of a second assembly.  Needs x0.

    ``device``: ``None`` means the CUDA card (RuntimeError without one);
    ``"cpu"`` runs the kernels' plain versions on the host.
    """
    blk = banded.kkt_tridiag_block(structure)
    if blk is None or structure.dimension != 3:
        raise ValueError("lanes IPM requires the flagship free-interior "
                         "3-D family (block-tridiagonal KKT).")
    if config.fused and config.pipelined:
        raise ValueError("fused and pipelined are mutually exclusive")
    if (config.fused or config.pipelined) and config.corrector:
        raise ValueError("the fused and the pipelined lanes IPM implement "
                         "the corrector=False schedule only")
    if (lam0_ball is None) != (lam0_half is None):
        raise ValueError("pass lam0_ball and lam0_half together")
    dev = resolve_device(device)
    f32 = torch.float32
    d_fixed, times, waypoints, radii = (
        as_tensor(a, f32, dev) for a in (d_fixed, times, waypoints, radii))
    if x0 is not None:
        x0 = as_tensor(x0, f32, dev)

    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim
    layout = _flagship_layout(structure)
    maps = _lane_maps(layout)
    nb_p, n_ball, n_half, m_p = (layout.nb_p, layout.n_ball, layout.n_half,
                                 layout.m_p)
    mc = n_ball + n_half
    act = const(("lane_act", layout), lambda: maps.act, f32, dev)[None, :]
    cw = const(("lane_cw", layout), lambda: maps.cw, f32, dev)[None, :]
    lane_src = const(("lane_src", layout), lambda: maps.lane_src,
                     torch.long, dev)
    half_lane = const(("half_lane", layout), lambda: maps.half_lane,
                      torch.long, dev)
    bsz = d_fixed.shape[0]

    sigma_min = config.sigma_min
    alpha_max = config.alpha_max
    w_cap = config.w_cap

    if pre is not None:
        if x0 is None:
            raise ValueError("pre reuse requires x0 (the tier-0 iterate)")
        if pre_penalty is None:
            pre_penalty = (1.0, 1.0, 1.0)
        lane_r, ball_r, half_r = (
            as_tensor(a, f32, dev) for a in penalty_unscale_maps(
                structure, layout, *pre_penalty))
        p_eq = pre.p_eq.to(f32)
        q_eq = pre.q_flat.to(f32).reshape(bsz, n_free, dim)
        d_scale = pre.d_scale.to(f32)
        # x0 is the tier-0 solution's d_free (true space); rescale as
        # _objective_blocks does.
        x_init = x0 / d_scale[:, :, None]
        gt = pre.gt.to(f32) * lane_r                       # (B, nfd, m_p)
        b_pad = pre.b_pad.to(f32) * lane_r                 # (B, 1, m_p)
        rb = pre.rb.to(f32) * ball_r
        sb = pre.sb.to(f32) * ball_r
        sh = pre.sh.to(f32) * half_r
    else:
        (p_eq, q_eq, d_scale, x_init, gt, b_pad, rb, sb, sh) = _lanes_setup(
            structure, d_fixed, times, waypoints, radii, x0, layout)
    gt = gt.contiguous()
    b_pad = b_pad.contiguous()

    rb_pad = torch.cat([rb, torch.ones((bsz, layout.tail), dtype=f32,
                                       device=dev)], dim=-1)   # (B, nb_p)
    rb3 = rb_pad[:, None, :].contiguous()
    pe_d, pe_u = _pe_band(p_eq, dim, blk)
    m_blk = nfd // blk
    eye_b = torch.eye(blk, dtype=f32, device=dev)
    q_flat = q_eq.reshape(bsz, nfd, 1).contiguous()
    x_flat0 = x_init.reshape(bsz, nfd, 1).contiguous()

    def gt_matvec(v_col):
        """(B, nfd, 1) -> (B, m_p): G v."""
        return ipm_kernel.gt_matvec(gt, v_col.contiguous())[:, 0, :]

    def p_big_mv(x_col):
        xm = x_col.reshape(bsz, n_free, dim)
        return (p_eq @ xm).reshape(bsz, nfd, 1)

    # ---- Initial point. ---------------------------------------------------
    y0 = x_flat0.transpose(1, 2) @ gt + b_pad              # (B, 1, m_p)
    c0 = _c_lanes(y0[:, 0, :], rb_pad, nb_p, n_ball)       # (B, m_p)
    if lam0_ball is not None:
        lam0_ball = as_tensor(lam0_ball, f32, dev)
        lam0_half = as_tensor(lam0_half, f32, dev)
        yx0 = y0[:, 0, 0:n_ball]
        yy0 = y0[:, 0, nb_p:nb_p + n_ball]
        yz0 = y0[:, 0, 2 * nb_p:2 * nb_p + n_ball]
        nrm_y0 = torch.sqrt(yx0 ** 2 + yy0 ** 2 + yz0 ** 2)
        lam_b = (torch.linalg.vector_norm(lam0_ball, dim=-1)
                 / torch.clamp(2.0 * sb * nrm_y0, min=1e-12))  # (B, n_ball)
        lam_h = lam0_half / (2.0 * sh)
        lam_flat = torch.clamp(torch.cat([lam_b, lam_h], dim=-1),
                               config.warm_lam_min, 1e8)
        lam_flat = torch.cat(
            [lam_flat, torch.zeros((bsz, 1), dtype=f32, device=dev)], dim=-1)
        lam_est = lam_flat[:, lane_src] * act              # (B, m_p) lanes
        s_lane = torch.clamp(-c0, min=config.warm_s_min) * act + (1.0 - act)
        beta = config.warm_beta
        mu0 = torch.clamp(config.warm_mu_boost
                          * (cw * s_lane * lam_est).sum(dim=-1, keepdim=True)
                          / mc, min=1e-10)
        lam_lane = torch.clamp(lam_est, min=mu0 / (beta * s_lane),
                               max=beta * mu0 / s_lane) * act
    else:
        s_lane = torch.clamp(-c0, min=config.s_init) * act + (1.0 - act)
        lam_lane = torch.full((bsz, m_p), config.lam_init, dtype=f32,
                              device=dev) * act

    def eval_step_k(x, s, lam, w_cap_k, phr=False):
        """One kernel pass; the Gram leaves it as its block-tridiagonal band
        (stacked (B, m, blk, blk) diagonal / super blocks)."""
        y, c, jtwr2, jts, hd_f, hu_f = ipm_kernel.ipm_eval_step(
            gt, b_pad, rb3, x.contiguous(), s[:, None, :].contiguous(),
            lam[:, None, :].contiguous(), nb_p=nb_p, n_ball=n_ball,
            w_cap=w_cap_k, phr=phr, band_block=blk)
        return (y[:, 0, :], c[:, 0, :], jtwr2, jts,
                hd_f.reshape(bsz, m_blk, blk, blk),
                hu_f.reshape(bsz, m_blk - 1, blk, blk))

    def max_step(v, dv):
        return ipm_kernel._max_step_k(v, dv, config.tau)

    def merit_lane(c, s, lam):
        return ipm_kernel._merit_k(c, s, lam, act, cw, mc)[:, 0]

    def newton_step(carry):
        x, s, lam, y_c, best_x, best_y, best_merit = carry
        s = torch.clamp(s, min=1e-14) * act + (1.0 - act)
        y, c, jtwr2, jts, gd, gu = eval_step_k(x, s, lam, w_cap)
        r2 = (c + s) * act
        w = torch.clamp(lam / s, max=w_cap)

        hd = pe_d + gd + config.reg * eye_b
        hu = pe_u + gu
        mu = (cw * s * lam).sum(dim=-1, keepdim=True) / mc
        rhs_a = -(p_big_mv(x) + q_flat + jtwr2)
        solve_h = _equilibrated_band_solve(hd, hu)

        def direction(rhs):
            dx = solve_h(rhs)                              # (B, nfd, 1)
            gdx = gt_matvec(dx)                            # (B, m_p)
            jdx = _jdx_lanes(gdx, y, nb_p, n_ball)
            ds = (-r2 - jdx) * act
            return dx, gdx, ds

        if config.corrector:
            _, _, ds_a = direction(rhs_a)
            dlam_a = (-lam - w * ds_a) * act
            alpha_a = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
            mu_aff = (cw * (s + alpha_a * ds_a)
                      * (lam + alpha_a * dlam_a)).sum(dim=-1,
                                                      keepdim=True) / mc
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                                sigma_min, 0.9)
        else:
            # Fixed centering: one factored solve + one G dx per step.
            sigma = torch.full((bsz, 1), sigma_min, dtype=f32, device=dev)
        sig_mu = sigma * mu                                # (B, 1)

        dx, gdx, ds = direction(rhs_a - sig_mu[:, :, None] * jts)
        dlam = ((sig_mu - lam * s) / s - w * ds) * act
        alpha = torch.clamp(torch.minimum(max_step(s, ds),
                                          max_step(lam, dlam)),
                            max=alpha_max)

        # Select, don't scale: a blown-up direction (NaN dx in the float32
        # endgame) must freeze the state of that scenario, not poison it
        # through 0 * NaN.  Gated on direction finiteness, not on alpha.
        upd = _finite_step_mask(alpha, ds, dlam)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(upd, alpha, zero)
        x_new = torch.where(upd[:, :, None], x + alpha[:, :, None] * dx, x)
        s_new = torch.where(upd, s + alpha * ds, s)
        lam_new = torch.where(
            act > 0,
            torch.where(upd, torch.clamp(lam + alpha * dlam, min=1e-16), lam),
            torch.zeros_like(lam))
        y_new = torch.where(upd, y + alpha * gdx, y)
        c_new = _c_lanes(y_new, rb_pad, nb_p, n_ball)

        merit = merit_lane(c_new, s_new, lam_new)
        better = merit < best_merit
        best_x = torch.where(better[:, None, None], x_new, best_x)
        best_y = torch.where(better[:, None], y_new, best_y)
        best_merit = torch.where(better, merit, best_merit)
        max_lam = torch.where(act > 0, lam_new,
                              torch.zeros_like(lam_new)).amax(dim=-1)
        return (x_new, s_new, lam_new, y_new, best_x, best_y,
                best_merit), max_lam

    inf_b = torch.full((bsz,), float("inf"), dtype=f32, device=dev)
    snap_iters = config.snap_iters
    snap_rho = config.snap_rho
    act3 = act.reshape(1, 1, m_p).contiguous()
    cw3 = cw.reshape(1, 1, m_p).contiguous()
    pipe_kw = dict(nb_p=nb_p, n_ball=n_ball, mc=mc,
                   sigma_min=float(sigma_min), tau=float(config.tau),
                   alpha_max=float(alpha_max), w_cap=float(w_cap),
                   reg=float(config.reg), snap_rho=float(snap_rho), blk=blk)
    if config.fused:
        # The whole polish, snap sweeps included, in one kernel launch.
        (x_fin, y_fin, s_fin, lam_fin, y_last, best_merit, lam_mid,
         lam_last) = ipm_kernel.ipm_solve_fused(
            gt, b_pad, rb3, pe_d, pe_u, q_flat, x_flat0,
            s_lane[:, None, :].contiguous(),
            lam_lane[:, None, :].contiguous(), y0.contiguous(), act3, cw3,
            n_iters=config.n_iters, snap_iters=snap_iters, **pipe_kw)
        y_fin, s_fin, lam_fin, y_last = (a[:, 0, :] for a in (
            y_fin, s_fin, lam_fin, y_last))
        best_merit = best_merit[:, 0, 0]
        if config.n_iters == 0:
            # Snap-only: the kernel's lam_mid stays 0, the ratio would be
            # huge and the dynamic certificate could fire on rows that are
            # merely unconverged.  Certificate off, as in the pipelined path.
            lam_growth = torch.ones((bsz,), dtype=f32, device=dev)
        else:
            lam_growth = lam_last[:, 0, 0] / torch.clamp(lam_mid[:, 0, 0],
                                                         min=1e-30)
    elif config.pipelined:

        def pipe(state, factors, upd_mode, eval_mode):
            outs = ipm_kernel.ipm_pipe_step(
                gt, b_pad, rb3, pe_d, pe_u, q_flat, *state, *factors, act3,
                cw3, upd_mode=upd_mode, eval_mode=eval_mode, **pipe_kw)
            return list(outs[:7]), outs[7][:, 0, 0], outs[8:11]

        def factor_band(band):
            hd_f, hu_f, rhs = band
            s_inv, t_lst, d = _equilibrated_band_factor(
                hd_f.reshape(bsz, m_blk, blk, blk),
                hu_f.reshape(bsz, m_blk - 1, blk, blk))
            t_st = torch.stack(t_lst[1:], dim=1)
            return (torch.stack(s_inv, dim=1).contiguous(),
                    t_st.contiguous(),
                    t_st.transpose(-1, -2).contiguous(),
                    d.reshape(bsz, nfd, 1).contiguous(), rhs)

        state = [x_flat0, s_lane[:, None, :].contiguous(),
                 lam_lane[:, None, :].contiguous(), y0.contiguous(),
                 x_flat0, y0.contiguous(), inf_b.reshape(bsz, 1, 1)]
        zeros_f = (torch.zeros((bsz, m_blk, blk, blk), dtype=f32, device=dev),
                   torch.zeros((bsz, m_blk - 1, blk, blk), dtype=f32,
                               device=dev),
                   torch.zeros((bsz, m_blk - 1, blk, blk), dtype=f32,
                               device=dev),
                   torch.zeros((bsz, nfd, 1), dtype=f32, device=dev),
                   torch.zeros((bsz, nfd, 1), dtype=f32, device=dev))
        first_eval = "newton" if config.n_iters else (
            "snap" if snap_iters else "none")
        state, _, band = pipe(state, zeros_f, "none", first_eval)
        lam_mid = lam_last = factors = None
        for i in range(1, config.n_iters + 1):
            eval_mode = ("newton" if i < config.n_iters
                         else ("snap" if snap_iters else "none"))
            if factors is None or (i - 1) % config.refactor_every == 0:
                factors = factor_band(band)
            else:
                # Stale factor, fresh rhs (modified Newton).
                factors = factors[:4] + (band[2],)
            state, max_lam, band = pipe(state, factors, "newton", eval_mode)
            if i == config.n_iters // 2 + 1:
                lam_mid = max_lam
            lam_last = max_lam
        for j in range(1, snap_iters + 1):
            eval_mode = "snap" if j < snap_iters else "none"
            # Every snap sweep gets a fresh factor: the clipped active set
            # moves enough between sweeps that a shared factor fattens the
            # violation tail.
            state, _, band = pipe(state, factor_band(band), "snap",
                                  eval_mode)
        _, s_row, lam_row, y_row, bx, by, bm = state
        x_fin = bx
        y_fin = by[:, 0, :]
        s_fin = s_row[:, 0, :]
        lam_fin = lam_row[:, 0, :]
        y_last = y_row[:, 0, :]
        best_merit = bm[:, 0, 0]
        if lam_last is None:            # snap-only (n_iters=0): no Newton
            lam_growth = torch.ones((bsz,), dtype=f32, device=dev)
        else:
            lam_growth = lam_last / torch.clamp(
                lam_mid if lam_mid is not None else lam_last, min=1e-30)
    else:
        if config.n_iters < 1:
            raise ValueError("the scan schedule needs n_iters >= 1 (use "
                             "pipelined=True for a snap-only run)")
        carry = (x_flat0, s_lane, lam_lane, y0[:, 0, :], x_flat0,
                 y0[:, 0, :], inf_b)
        lam_hist = []
        for _ in range(config.n_iters):
            carry, max_lam = newton_step(carry)
            lam_hist.append(max_lam)
        _, s_fin, lam_fin, y_last, x_fin, y_fin, best_merit = carry
        lam_growth = lam_hist[-1] / torch.clamp(
            lam_hist[config.n_iters // 2], min=1e-30)

        # ---- Feasibility snap (tail repair). ------------------------------
        # float32 endgames leave a fat violation tail.  Gauss-Newton on the
        # violated rows minimizes sum max(c, 0)^2 in the P metric with a grid
        # line search along the affine-in-alpha y; moves are O(violation)
        # sized and the cost changes to second order.
        for _ in range(snap_iters):
            c = _c_lanes(y_fin, rb_pad, nb_p, n_ball)
            # Violated rows get the Gauss-Newton pull (m_est = rho c > 0);
            # near-boundary rows enter the Gram only, as tangency stiffness,
            # so the step does not trade one violation for a new one.
            margin = 3.0 / snap_rho
            lam_s = torch.where((c > -margin) & (act > 0),
                                torch.full_like(c, 1e-6),
                                torch.zeros_like(c))
            s_s = lam_s / snap_rho
            _, _, jtwr2, _, gd, gu = eval_step_k(x_fin, s_s, lam_s,
                                                 w_cap_k=snap_rho, phr=True)
            dx = _equilibrated_band_solve(
                pe_d + gd + 1e-6 * eye_b, pe_u + gu)(-jtwr2)
            gdx = gt_matvec(dx)

            def phi(y_a):
                v = torch.clamp(_c_lanes(y_a, rb_pad, nb_p, n_ball), min=0.0)
                return (cw * v * v).sum(dim=-1)

            best_a = torch.zeros((bsz,), dtype=f32, device=dev)
            best_p = phi(y_fin)
            for a_t in ipm_kernel.SNAP_ALPHAS:
                p_t = phi(y_fin + a_t * gdx)
                better = p_t < best_p
                best_a = torch.where(better, torch.full_like(best_a, a_t),
                                     best_a)
                best_p = torch.where(better, p_t, best_p)
            # Select, don't scale: a rejected (alpha = 0) step must not leak
            # 0 * NaN from a blown-up dx into the state.
            al = best_a[:, None]
            x_fin = torch.where(al[:, :, None] > 0,
                                x_fin + al[:, :, None] * dx, x_fin)
            y_fin = torch.where(al > 0, y_fin + al * gdx, y_fin)

    # ---- Status / certificates. -------------------------------------------
    ninf = torch.full((), float("-inf"), dtype=f32, device=dev)
    c_fin = _c_lanes(y_fin, rb_pad, nb_p, n_ball)
    mu_fin = (cw * s_fin * lam_fin).sum(dim=-1) / mc
    prim_res = torch.where(act > 0, torch.clamp(c_fin, min=0.0),
                           ninf).amax(dim=-1)
    obj_scale = 1.0 + q_flat[:, :, 0].abs().amax(dim=-1)
    converged = ((prim_res < config.eps_feas)
                 & (best_merit < config.eps_merit * obj_scale))
    c_last = _c_lanes(y_last, rb_pad, nb_p, n_ball)
    lam_cw = cw * lam_fin
    farkas = ((lam_cw * c_last).sum(dim=-1)
              / torch.clamp(lam_cw.sum(dim=-1), min=1e-30))
    dyn_infeasible = ((prim_res > 10.0 * config.eps_feas)
                      & (lam_growth > config.infeas_growth)
                      & (farkas > config.eps_feas))
    static_infeasible = _static_certificate(structure, times, d_fixed,
                                            waypoints, radii, config)
    infeasible = static_infeasible | dyn_infeasible

    # ---- Outputs. -----------------------------------------------------------
    d_free = x_fin.reshape(bsz, n_free, dim) * d_scale[:, :, None]
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)

    # True-space violation from the scaled y at the best iterate.
    yb = torch.stack([y_fin[:, c * nb_p:c * nb_p + n_ball] for c in range(3)],
                     dim=-1)                               # (B, n_ball, 3)
    nb_norm = torch.linalg.vector_norm(yb, dim=-1)
    viol_ball = ((nb_norm - rb) / sb).amax(dim=-1)
    yh = y_fin[:, half_lane]
    viol = torch.maximum(viol_ball, (yh / sh).amax(dim=-1))

    dual_ball = 2.0 * sb[:, :, None] * lam_fin[:, :n_ball, None] * yb
    dual_half = 2.0 * sh * lam_fin[:, half_lane]

    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=mu_fin,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half,
        infeasible=infeasible)


def solve_qcqp_polished_batch(structure: ProblemStructure, d_fixed, times,
                              waypoints, radii,
                              admm_config: Optional[ADMMConfig] = None,
                              ipm_config: Optional[IPMConfig] = None,
                              warmstart_values=None,
                              device: DeviceLike = None) -> QCQPSolution:
    """Batched strict-feasibility path: ADMM throughput solve, then the
    plane-layout IPM polish warm-started from its iterate and duals, on the
    ADMM's assembled system (``pre=`` reuse)."""
    if admm_config is None:
        admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                 rho_tube_factor=0.125, rho_half_factor=0.125)
    if ipm_config is None:
        # 10 single-direction Newton steps at fixed centering 0.3 plus the
        # 2-sweep snap match the Mehrotra variant's quality at one factored
        # solve and one G dx per step.
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)
    a, pre = solve_qcqp_batch(
        structure, d_fixed, times, waypoints, radii, config=admm_config,
        warmstart_values=warmstart_values, device=device, _return_pre=True)
    return solve_qcqp_ipm_lanes(
        structure, a.d_fixed, a.times, waypoints, radii, config=ipm_config,
        x0=a.d_free, lam0_ball=a.dual_ball, lam0_half=a.dual_half, pre=pre,
        pre_penalty=(admm_config.rho_sphere_factor,
                     admm_config.rho_tube_factor,
                     admm_config.rho_half_factor), device=device)
