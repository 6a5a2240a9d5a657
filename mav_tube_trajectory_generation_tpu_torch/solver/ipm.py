"""Primal-dual interior-point solver for the tube-constrained QCQP.

Counterpart of the JAX package's ``solver/ipm.py``: the QCQP backend of the
reference is an interior-point solve (Mosek, qcqp_impl.h:709-788), and the
first-order ADMM of ``solver.qcqp`` trades terminal accuracy for throughput.
This module is the high-accuracy back end on the reference-layout system of
``qcqp.build_constraints``: for

    min 0.5 x^T P x + q^T x   s.t.  c_i(x) <= 0

with ball constraints c_i = 0.5 (||G_i x + b_i||^2 - r_i^2) and half-spaces
c_j = g_j^T x + b_j, a Mehrotra predictor-corrector step solves the Newton
system reduced to x (slacks and multipliers eliminated),

    (P + sum_i lam_i G_i^T G_i + J^T diag(lam / s) J) dx = rhs,

whose block-tridiagonal band is factored per step.  Any float dtype; float64
is what the last tier of the verdict router (``solver.auto``) runs, on the
card.  No kernel: the per-scenario dense products stay batched matrix
products, as the JAX package leaves them outside its kernels.  The public
functions take one scenario, as the JAX ones do; they wrap the batched row
functions the router calls.

``IPMConfig`` carries every field of the JAX package's, with the same
defaults, so that a configuration converts one to one
(``convert.ipm_config_from_fields``); the plane-layout float32 solver that
also reads it is ``solver.ipm_lanes``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._tensors import DeviceLike, resolve_device, tensor_dtype
from ..ops import ipm_kernel, linalg
from . import banded, linear
from . import qcqp as qcqp_mod
from .qcqp import (ADMMConfig, QCQPSolution, _constraint_geometry,
                   build_constraints)
from .structure import ProblemStructure


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Static IPM knobs."""
    n_iters: int = 25           # Newton iterations
    sigma: float = 0.1          # centering parameter
    tau: float = 0.995          # fraction-to-boundary
    reg: float = 1e-9           # Hessian regularization
    s_init: float = 1.0         # initial slack floor
    lam_init: float = 1.0       # initial multiplier
    eps_feas: float = 1e-6      # convergence thresholds for status output
    eps_mu: float = 1e-8
    # Relative merit threshold for `converged`: best_merit is compared
    # against eps_merit * (1 + ||q_eq||_inf) -- the merit's complementarity
    # term scales linearly with the (equilibrated) objective's gradient
    # scale, so an absolute threshold would mislabel large-cost problems.
    eps_merit: float = 1e-4
    # Primal-infeasibility certificate (QCQPSolution.infeasible): the max
    # multiplier growing by more than this factor over the second half of
    # the iterations while the lam-weighted average violation stays
    # positive.  On a feasible problem the multipliers converge (growth ->
    # 1); on an infeasible one they diverge along a Farkas direction.
    infeas_growth: float = 10.0
    # Dual warm start (lam0_ball/lam0_half given).  warm_s_min inflates the
    # start into the interior: hugging the boundary stalls the
    # fraction-to-boundary steps, while an interior start that keeps only the
    # duals' scale converges.
    warm_s_min: float = 1.0
    warm_lam_min: float = 1e-5
    # Central-path re-centering of the warm duals: products s_i lam_i are
    # clipped into [mu0/beta, beta*mu0] with mu0 = warm_mu_boost * mean(s lam).
    warm_beta: float = 10.0
    warm_mu_boost: float = 1.0
    # float32-endgame safeguards (plane-layout path): centering floor,
    # fraction-to-boundary step cap, and complementarity-weight cap.
    # Unrestricted Mehrotra steps drive mu below what float32 can resolve and
    # the Newton directions blow up; these bound the per-step mu decrease and
    # the Newton system's condition number.
    sigma_min: float = 0.1
    alpha_max: float = 1.0
    w_cap: float = 1e6
    # Post-IPM feasibility snap (lanes path): Gauss-Newton sweeps on the
    # violated rows only, repairing the float32 endgame's violation tail.
    snap_iters: int = 2
    snap_rho: float = 1e4
    # Mehrotra predictor-corrector toggle (lanes path).  False = single
    # direction per step with fixed centering sigma = sigma_min: drops one
    # factored solve and one G dx matvec per step.
    corrector: bool = True
    # Weighted-Gram product precision.  The kernels of this package compute
    # in full float32; anything but "highest" is refused.
    gram_precision: str = "highest"
    # Lanes path: the whole polish (Newton steps with the band factored
    # inside the kernel, then the snap sweeps) as one kernel launch
    # (ops.ipm_kernel.ipm_solve_fused).  Requires corrector=False.
    fused: bool = False
    # Lanes path: pipelined kernel schedule (ops.ipm_kernel.ipm_pipe_step) --
    # one kernel launch per Newton/snap step that finishes the previous step
    # and evaluates the next point, with only the batched band factor left
    # outside.  Requires corrector=False.  Mutually exclusive with `fused`.
    pipelined: bool = False
    # Pipelined path: re-factorize the Newton Hessian only every k-th step
    # (modified Newton).  1 = factor every step.  Snap sweeps always get a
    # fresh factor.
    refactor_every: int = 1

    def __post_init__(self):
        if self.gram_precision != "highest":
            raise ValueError(
                f"gram_precision must be 'highest' (full float32), got "
                f"{self.gram_precision!r}")


def _static_certificate(structure, times, d_fixed, waypoints, radii,
                        config: IPMConfig):
    """Closed-form infeasibility certificate for violated constant rows
    (constraints whose Jacobian is zero): (B,) bool.

    A constraint row with (numerically) zero Jacobian is a constant -- e.g.
    tube constraints on the first segment's leading control points, which
    depend only on the fixed start state.  A violated constant row proves
    infeasibility in closed form, and no iterative certificate can: its
    unsatisfiable slack collapses the fraction-to-boundary step, freezing the
    multipliers instead of letting them diverge along a Farkas direction.
    Judged on raw, unequilibrated tensors: the row-scale clip would hide
    exactly these rows.

    Same test as on the reference-layout system of ``qcqp.build_constraints``
    -- a row with |Jacobian| < 1e-9 (1 + |offset|) whose offset alone
    violates it -- but the Jacobian norms come from the rows' factored form
    (each row is an outer product of a control-point map and a direction, so
    its norm is the product of the two norms) and no per-row Jacobian is
    materialized.
    """
    k = structure.n_segments
    n = structure.n_coefficients
    geo = _constraint_geometry(structure, times, d_fixed, waypoints, radii)
    bsz = times.shape[0]
    e_norm = torch.linalg.vector_norm(geo.ecp, dim=-1)     # (B, K, N)
    e_mid = e_norm[:, :, 1:n - 1]                          # (B, K, M)
    proj_f = torch.linalg.matrix_norm(geo.proj)            # (B, K)
    dir_n = torch.linalg.vector_norm(geo.dirs, dim=-1)     # (B, K, 2)
    ball_jac = torch.cat([
        e_norm[:, :k - 1, n - 1] * float(np.sqrt(3.0)),
        (proj_f[:, :, None] * e_mid).reshape(bsz, -1)], dim=1)
    half_jac = (e_mid[:, :, :, None] * dir_n[:, :, None, :]).reshape(bsz, -1)
    ball_const = torch.linalg.vector_norm(geo.b_ball, dim=-1)
    return (((ball_jac < 1e-9 * (1.0 + ball_const))
             & (ball_const - geo.r_ball > config.eps_feas)).any(dim=1)
            | ((half_jac < 1e-9 * (1.0 + geo.b_half.abs()))
               & (geo.b_half > config.eps_feas)).any(dim=1))


def _solve_qcqp_ipm_rows(structure: ProblemStructure, d_fixed, times,
                         waypoints, radii, config: IPMConfig = IPMConfig(),
                         x0=None, lam0_ball=None,
                         lam0_half=None) -> QCQPSolution:
    """``solve_qcqp_ipm`` for a batch of scenarios: tensors of one float
    dtype on one device, each with the batch axis in front."""
    if (lam0_ball is None) != (lam0_half is None):
        raise ValueError("pass lam0_ball and lam0_half together")
    dt, dev = times.dtype, times.device
    bsz = times.shape[0]
    nf = structure.n_fixed
    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim

    r = linear.assemble_r(structure, times)
    r_pf = r[:, nf:, :nf]
    r_pp = r[:, nf:, nf:]
    q_lin = r_pf @ d_fixed

    cons = build_constraints(structure, times, d_fixed, waypoints, radii)

    # ---- Equilibration (same scheme as the ADMM back end). ----------------
    d_scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))
    p_eq = r_pp * d_scale[:, :, None] * d_scale[:, None, :]
    q_eq = (q_lin * d_scale[:, :, None]).reshape(bsz, nfd)
    gb = cons.g_ball * d_scale[:, None, None, :, None]   # (B,n_ball,3,nf,D)
    gh = cons.g_half * d_scale[:, None, :, None]         # (B,n_half,nf,D)
    # Row scales clamped to [1e-2, 1e2]: constraints whose Jacobian block is
    # (near-)zero are constants; unbounded up-scaling of those rows poisons
    # the solvers.
    sb = 1.0 / torch.clamp(
        torch.sqrt((gb ** 2).sum(dim=(2, 3, 4)) / 3.0), 1e-2, 1e2)
    sh = 1.0 / torch.clamp(torch.sqrt((gh ** 2).sum(dim=(2, 3))), 1e-2, 1e2)
    gb = gb * sb[:, :, None, None, None]
    bb = cons.b_ball * sb[:, :, None]
    rb = cons.r_ball * sb
    gh = gh * sh[:, :, None, None]
    bh = cons.b_half * sh

    n_ball = gb.shape[1]
    n_half = gh.shape[1]
    mc = n_ball + n_half
    gb_rows = gb.reshape(bsz, n_ball, 3, nfd)
    gb_flat = gb_rows.reshape(bsz, n_ball * 3, nfd)
    gh_flat = gh.reshape(bsz, n_half, nfd)

    # The Newton Hessian p_big + a_w^T a_w + reg I shares the stage KKT's
    # exact block-tridiagonal structure (banded.kkt_tridiag_block): every
    # constraint row's support is one segment's two endpoint vertices.  Per
    # Newton step only the band is assembled (diagonal / super-diagonal
    # block slices of the dense weighted Gram plus the krons of p_eq's vertex
    # blocks) and the direction comes from a block-Thomas factor and
    # single-column solves.  Structures without that band get a dense
    # inverse.
    blk = banded.kkt_tridiag_block(structure)
    eye_d = torch.eye(dim, dtype=dt, device=dev)
    if blk is not None:
        m_blk = nfd // blk
        bp = blk // dim
        eye_b = torch.eye(blk, dtype=dt, device=dev)
        pe5 = p_eq.reshape(bsz, m_blk, bp, m_blk, bp)

        def kron_e(a):
            return torch.einsum('smab,cd->smacbd', a, eye_d).reshape(
                bsz, a.shape[1], blk, blk)

        pe_d = kron_e(torch.stack([pe5[:, i, :, i, :]
                                   for i in range(m_blk)], dim=1))
        pe_u = kron_e(torch.stack([pe5[:, i, :, i + 1, :]
                                   for i in range(m_blk - 1)], dim=1))
    else:
        p_big = qcqp_mod._kron_eye(p_eq, dim)
        eye_n = torch.eye(nfd, dtype=dt, device=dev)

    def mv(mat, vec):
        return (mat @ vec[:, :, None])[:, :, 0]

    def p_big_matvec(x):
        # kron(p_eq, I_dim) @ x without the dense kron.
        return (p_eq @ x.reshape(bsz, n_free, dim)).reshape(bsz, nfd)

    if x0 is None:
        eye_f = torch.eye(n_free, dtype=dt, device=dev)
        x_init = -(linalg.spd_inverse(p_eq + config.reg * eye_f)
                   @ q_eq.reshape(bsz, n_free, dim))
    else:
        x_init = x0.to(dt) / d_scale[:, :, None]
    x_flat0 = x_init.reshape(bsz, nfd)

    def constraint_values(x):
        yb = mv(gb_flat, x).reshape(bsz, n_ball, 3) + bb     # (B, n_ball, 3)
        yh = mv(gh_flat, x) + bh                             # (B, n_half)
        cb = 0.5 * ((yb * yb).sum(dim=2) - rb * rb)
        return torch.cat([cb, yh], dim=1), yb

    def max_step(v, dv):
        # Fraction-to-boundary: largest alpha in (0, 1] with v + a dv > 0.
        return ipm_kernel._max_step_k(v, dv, config.tau)     # (B, 1)

    def merit_of(x, s, lam):
        c, _ = constraint_values(x)
        return (torch.clamp(c, min=0.0).amax(dim=1)
                + (c + s).abs().amax(dim=1)
                + (s * lam).sum(dim=1) / mc)

    def newton_step(x, s, lam, best_x, best_merit):
        s = torch.clamp(s, min=1e-14)
        c, yb = constraint_values(x)
        # Jacobian rows: ball gradient G_i^T y_i; half gradient g_j.
        j_ball = torch.einsum('bicn,bic->bin', gb_rows, yb)  # (B,n_ball,nfd)
        jmat = torch.cat([j_ball, gh_flat], dim=1)           # (B, mc, nfd)
        jmat_t = jmat.transpose(1, 2)

        mu = (s * lam).sum(dim=1, keepdim=True) / mc         # (B, 1)
        # Cap the complementarity weights: as mu -> 0 active slacks vanish
        # and lam / s would make the Newton system numerically singular; the
        # cap bounds the condition number, and best-iterate tracking below
        # keeps the pre-breakdown solution.
        w = torch.clamp(lam / s, max=1e10)                   # (B, mc)
        # Stacked weighted Gram: ball curvature rows (sqrt(lam_b) G rows)
        # plus (sqrt(lam / s) * jac) rows, one batched product.
        lam_b3 = lam[:, :n_ball].repeat_interleave(3, dim=1)
        a_w = torch.cat([gb_flat * torch.sqrt(lam_b3)[:, :, None],
                         jmat * torch.sqrt(w)[:, :, None]], dim=1)
        gram = a_w.transpose(1, 2) @ a_w                     # (B, nfd, nfd)
        if blk is not None:
            g5 = gram.reshape(bsz, m_blk, blk, m_blk, blk)
            hd = pe_d + config.reg * eye_b + torch.stack(
                [g5[:, i, :, i, :] for i in range(m_blk)], dim=1)
            hu = pe_u + torch.stack(
                [g5[:, i, :, i + 1, :] for i in range(m_blk - 1)], dim=1)
            s_inv_f, t_f = banded.spd_block_tridiag_factor(hd, hu)

            def solve_h(rhs):
                return banded.spd_block_tridiag_solve_factored(
                    s_inv_f, t_f, rhs[:, :, None])[:, :, 0]
        else:
            h_inv = linalg.spd_inverse(p_big + gram + config.reg * eye_n)

            def solve_h(rhs):
                return mv(h_inv, rhs)

        grad_f = p_big_matvec(x) + q_eq
        r1 = grad_f + mv(jmat_t, lam)
        r2 = c + s

        def direction(sigma_mu):
            # Reduced rhs: -(r1 + J^T (w r2 - lam + sigma_mu / s)).
            rhs = -(r1 + mv(jmat_t, w * r2 - lam + sigma_mu / s))
            dx = solve_h(rhs)
            ds = -r2 - mv(jmat, dx)
            dlam = (sigma_mu - lam * s) / s - w * ds
            return dx, ds, dlam

        # Mehrotra predictor-corrector: the affine direction reuses the same
        # factor, so the second solve is just matvecs.
        _, ds_a, dlam_a = direction(torch.zeros_like(mu))
        alpha_a = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = ((s + alpha_a * ds_a) * (lam + alpha_a * dlam_a)).sum(
            dim=1, keepdim=True) / mc
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            1e-4, 0.9)
        dx, ds, dlam = direction(sigma * mu)
        alpha = torch.minimum(max_step(s, ds), max_step(lam, dlam))

        # Select, don't scale: freeze the scenario on a blown-up (non-finite)
        # Newton direction instead of poisoning the running state through
        # alpha * NaN.  A NaN direction yields a finite alpha (NaN < 0 is
        # False in max_step, the ratios are all inf), so the gate checks the
        # direction itself (ds and dlam contain J dx: dx finiteness is
        # implied).
        upd = ((alpha > 0)
               & torch.isfinite(ds).all(dim=1, keepdim=True)
               & torch.isfinite(dlam).all(dim=1, keepdim=True))
        x_new = torch.where(upd, x + alpha * dx, x)
        s_new = torch.where(upd, s + alpha * ds, s)
        lam_new = torch.where(upd, torch.clamp(lam + alpha * dlam,
                                               min=1e-16), lam)

        # Best-iterate tracking: keep the lowest-merit x seen; the fixed
        # number of steps may go on after the numerical endgame.
        merit = merit_of(x_new, s_new, lam_new)
        better = merit < best_merit
        best_x = torch.where(better[:, None], x_new, best_x)
        best_merit = torch.where(better, merit, best_merit)
        return x_new, s_new, lam_new, best_x, best_merit

    c0, yb0 = constraint_values(x_flat0)
    if lam0_ball is not None:
        # Invert the QCQPSolution dual convention (dual_ball = 2 sb lam y
        # with y the scaled residual; dual_half = 2 sh lam): the row scales
        # here may differ from the producer's (per-family penalty factors),
        # but the originals cancel in the original-space stationarity both
        # solvers share.
        nrm_y0 = torch.linalg.vector_norm(yb0, dim=2)
        lam_b = (torch.linalg.vector_norm(lam0_ball.to(dt), dim=-1)
                 / torch.clamp(2.0 * sb * nrm_y0, min=1e-12))
        lam_h = lam0_half.to(dt) / (2.0 * sh)
        lam_est = torch.clamp(torch.cat([lam_b, lam_h], dim=1),
                              config.warm_lam_min, 1e8)
        s0 = torch.clamp(-c0, min=config.warm_s_min)
        # Re-centre onto the central path: raw first-order duals leave
        # s_i lam_i spread over ~10 decades, and rows with near-zero
        # complementarity stall the fraction-to-boundary steps.  Every
        # product is clipped into [mu0 / beta, beta mu0] around the point's
        # average complementarity.
        beta = config.warm_beta
        mu0 = torch.clamp(config.warm_mu_boost
                          * (s0 * lam_est).sum(dim=1, keepdim=True) / mc,
                          min=1e-10)
        lam0 = torch.clamp(lam_est, min=mu0 / (beta * s0),
                           max=beta * mu0 / s0)
    else:
        s0 = torch.clamp(-c0, min=config.s_init)
        lam0 = torch.full((bsz, mc), config.lam_init, dtype=dt, device=dev)

    x, s, lam = x_flat0, s0, lam0
    x_fin = x_flat0
    best_merit = torch.full((bsz,), float("inf"), dtype=dt, device=dev)
    lam_hist = []
    for _ in range(config.n_iters):
        x, s, lam, x_fin, best_merit = newton_step(x, s, lam, x_fin,
                                                   best_merit)
        lam_hist.append(lam.amax(dim=1))
    x_last, s_fin, lam_fin = x, s, lam

    c_fin, yb_fin = constraint_values(x_fin)
    mu_fin = (s_fin * lam_fin).sum(dim=1) / mc
    prim_res = torch.clamp(c_fin, min=0.0).amax(dim=1)
    # Scale-invariant convergence: the merit's complementarity term scales
    # with the objective gradient (q_eq after equilibration), so normalize.
    obj_scale = 1.0 + q_eq.abs().amax(dim=1)
    converged = ((prim_res < config.eps_feas)
                 & (best_merit < config.eps_merit * obj_scale))
    # Primal-infeasibility certificate: diverging multipliers with a
    # persistently positive lam-weighted average violation.  ``farkas`` is
    # the complementarity-weighted mean of c_i at the last iterate -- for a
    # feasible problem it is <= 0 at any KKT-trending point; staying positive
    # while max(lam) keeps growing (ratio over the second half of the steps,
    # scale-invariant) evidences an unsatisfiable constraint combination.
    if lam_hist:
        growth = lam_hist[-1] / torch.clamp(lam_hist[config.n_iters // 2],
                                            min=1e-30)
    else:
        growth = torch.ones((bsz,), dtype=dt, device=dev)
    c_last, _ = constraint_values(x_last)   # certificate at the last iterate
    farkas = ((lam_fin * c_last).sum(dim=1)
              / torch.clamp(lam_fin.sum(dim=1), min=1e-30))
    dyn_infeasible = ((prim_res > 10.0 * config.eps_feas)
                      & (growth > config.infeas_growth)
                      & (farkas > config.eps_feas))
    infeasible = dyn_infeasible | _static_certificate(
        structure, times, d_fixed, waypoints, radii, config)

    d_free = x_fin.reshape(bsz, n_free, dim) * d_scale[:, :, None]
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)
    viol = qcqp_mod._true_violation(cons, d_free)

    # Dual certificates in the reference J_d convention (factor 2), mapped
    # back to original scaling: for ball constraints the multiplier of the
    # conic form ||y|| <= r relates to the quadratic form's lambda via
    # nu_i = lambda_i y_i, scaled by the row equilibration.
    dual_ball = 2.0 * sb[:, :, None] * lam_fin[:, :n_ball, None] * yb_fin
    dual_half = 2.0 * sh * lam_fin[:, n_ball:]
    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=mu_fin,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half,
        infeasible=infeasible)


def _default_admm_config() -> ADMMConfig:
    # The tuned throughput configuration of the benchmark.
    return ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                      rho_tube_factor=0.125, rho_half_factor=0.125)


def _solve_qcqp_polished_rows(structure: ProblemStructure, d_fixed, times,
                              waypoints, radii,
                              admm_config: Optional[ADMMConfig] = None,
                              ipm_config: Optional[IPMConfig] = None,
                              x0=None) -> QCQPSolution:
    """``solve_qcqp_polished`` for a batch of scenarios (batch axis in
    front)."""
    if admm_config is None:
        admm_config = _default_admm_config()
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=10)
    admm_sol = qcqp_mod._solve_qcqp_rows(structure, d_fixed, times, waypoints,
                                         radii, admm_config, x0=x0)
    return _solve_qcqp_ipm_rows(structure, d_fixed, times, waypoints, radii,
                                config=ipm_config, x0=admm_sol.d_free,
                                lam0_ball=admm_sol.dual_ball,
                                lam0_half=admm_sol.dual_half)


def _single_args(d_fixed, times, waypoints, radii, device, *optional):
    dev = resolve_device(device)
    dtype = torch.promote_types(tensor_dtype(d_fixed), tensor_dtype(times))
    one = lambda a: None if a is None else qcqp_mod._single(a, dtype, dev)
    return [one(a) for a in (d_fixed, times, waypoints, radii) + optional]


def solve_qcqp_ipm(structure: ProblemStructure, d_fixed, times, waypoints,
                   radii, config: IPMConfig = IPMConfig(), x0=None,
                   lam0_ball=None, lam0_half=None,
                   device: DeviceLike = None) -> QCQPSolution:
    """Interior-point solve of one tube-QCQP scenario.

    Same inputs and outputs as ``solver.qcqp.solve_qcqp``; ``converged``
    reflects primal feasibility < eps_feas and a small best merit;
    ``infeasible`` carries the static and the multiplier-growth certificate.

    ``lam0_ball`` (n_ball, 3) / ``lam0_half`` (n_half,): dual warm start in
    the QCQPSolution.dual_ball / dual_half convention (e.g. straight from an
    ADMM solve).  With both x0 and duals given the solve starts next to the
    central path and typically needs about half the Newton steps of a cold
    start.  The working dtype is the promotion of ``d_fixed`` and ``times``.
    ``device``: ``None`` means the CUDA card.
    """
    d_fixed, times, waypoints, radii, x0, lam0_ball, lam0_half = _single_args(
        d_fixed, times, waypoints, radii, device, x0, lam0_ball, lam0_half)
    return qcqp_mod._unbatch(_solve_qcqp_ipm_rows(
        structure, d_fixed, times, waypoints, radii, config=config, x0=x0,
        lam0_ball=lam0_ball, lam0_half=lam0_half))


def solve_qcqp_polished(structure: ProblemStructure, d_fixed, times,
                        waypoints, radii,
                        admm_config: Optional[ADMMConfig] = None,
                        ipm_config: Optional[IPMConfig] = None, x0=None,
                        device: DeviceLike = None) -> QCQPSolution:
    """Throughput + accuracy hybrid for one scenario: ADMM
    (``solver.qcqp.solve_qcqp``) to the 1e-3 neighbourhood, then a short
    interior-point polish to ~1e-9 violations and the exact optimum.

    The ADMM iterate warm-starts the polish's primal and duals (the scaled
    ADMM multipliers, re-centred onto the central path from an
    interior-inflated slack point -- see ``IPMConfig.warm_s_min``): 10 Newton
    steps reach the optimum where a cold start needs about 25.
    """
    d_fixed, times, waypoints, radii, x0 = _single_args(
        d_fixed, times, waypoints, radii, device, x0)
    return qcqp_mod._unbatch(_solve_qcqp_polished_rows(
        structure, d_fixed, times, waypoints, radii, admm_config=admm_config,
        ipm_config=ipm_config, x0=x0))
