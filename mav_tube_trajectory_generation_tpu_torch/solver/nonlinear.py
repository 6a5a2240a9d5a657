"""Nonlinear trajectory refinement: batched, differentiable outer loop.

Counterpart of the JAX package's ``solver/nonlinear.py`` (the reference's
``PolynomialOptimizationNonLinear``, polynomial_optimization_nonlinear.h
:239-674 and impl): cost terms as plain functions of
``(d_free, segment_times)`` on tensors, and two optimizers over a batch of
scenarios --

  * L-BFGS (``solver.lbfgs``: the JAX package's optax chain, zoom or
    backtracking line search, per scenario) for the smooth objectives,
    with gradients by autograd, through the inner linear solve too;
  * a fixed-shape Nelder-Mead simplex for the gradient-free time-only
    objective (the reference's LN_SBPLX default, nonlinear.h:61,125): the
    four trial points of an iteration are one batched inner solve.

Cost terms (weights per cost_weights, nonlinear.h:161-169):
  J_d  derivative energy          (getCostAndGradientDerivative convention)
  J_t  (total time)^2 * penalty   (objectiveFunctionTime, :894-896)
  J_c  collision line integral    sum c(x(t)) ||v(t)|| dt (:1608-1780), on a
       fixed midpoint grid per segment against a dense ESDF (models.esdf)
  J_sc soft max-magnitude costs   min(max_cost, exp(rel_violation * w)) over
       analytic extrema (:2735-2766), candidate times held constant under
       differentiation.

``optimize``, ``optimize_time_gradient`` and ``nelder_mead`` take leading
batch dimensions (one scenario needs none); every scenario keeps its own
step sizes, memory, simplex and multipliers, so a scenario's result in a
batch is its result alone.  Positivity of segment times comes from the log
reparameterization ``times = t_init * exp(theta)``; the time-only path also
clips to the reference's [0.1, 2 t_init] box (optimizeTime, :342-378).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._tensors import DeviceLike, as_tensor, resolve_device, tensor_dtype
from ..models import esdf as esdf_mod
from ..ops import basis, qmatrix, roots
from . import linear, qcqp
from .lbfgs import lbfgs_minimize
from .structure import ProblemStructure


class Objective(enum.Enum):
    """Mirrors NonlinearOptimizationParameters::OptimizationObjective
    (nonlinear.h:151-158)."""
    FREE_CONSTRAINTS = "free_constraints"
    FREE_CONSTRAINTS_AND_TIME = "free_constraints_and_time"
    TIME = "time"
    FREE_CONSTRAINTS_AND_COLLISION = "free_constraints_and_collision"
    FREE_CONSTRAINTS_AND_COLLISION_AND_TIME = (
        "free_constraints_and_collision_and_time")


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """cost_weights (nonlinear.h:161-169), reference defaults."""
    w_d: float = 0.1
    w_c: float = 10.0
    w_t: float = 1.0
    w_sc: float = 1.0


@dataclasses.dataclass(frozen=True)
class MagnitudeConstraint:
    """addMaximumMagnitudeConstraint input (nonlinear.h:270-271)."""
    derivative: int
    value: float


@dataclasses.dataclass(frozen=True)
class NonlinearParameters:
    """Static optimizer configuration (NonlinearOptimizationParameters,
    nonlinear.h:46-210), the JAX package's fields and defaults.  NLOPT
    tolerances and numeric-gradient switches have no counterpart: autograd
    and fixed iteration counts take their place."""
    objective: Objective = Objective.FREE_CONSTRAINTS_AND_TIME
    max_iterations: int = 50
    time_penalty: float = 500.0
    use_soft_constraints: bool = True
    soft_constraint_weight: float = 100.0
    soft_constraint_max_cost: float = 1.0e12
    weights: CostWeights = CostWeights()
    epsilon: float = 0.5
    robot_radius: float = 0.5
    coll_pot_multiplier: float = 1.0
    collision_samples_per_segment: int = 32
    # Time-only path box (optimizeTime, nonlinear_impl.h:342-378).
    time_lower_bound: float = 0.1
    time_upper_factor: float = 2.0
    nelder_mead_scale: float = 0.15
    extrema_grid: int = 64
    # Hard max-magnitude constraints (use_soft_constraints=False with
    # constraints): augmented-Lagrangian rounds around L-BFGS, the analogue
    # of NLOPT's add_inequality_constraint path (nonlinear_impl.h:848-875;
    # inequality_constraint_tolerance defaults to 0.1, nonlinear.h:57).
    inequality_constraint_tolerance: float = 0.1
    al_rounds: int = 4
    al_penalty: float = 10.0
    al_penalty_growth: float = 4.0
    # Relative cost-decrease tolerance (NLOPT ftol_rel, nonlinear.h:51): the
    # loops run a fixed length; f_rel defines the effective convergence
    # iteration and stopping reason reported in NonlinearResult.
    f_rel: float = 0.05
    # Hard box bounds on the free endpoint derivatives
    # (setFreeEndpointDerivativeHardConstraints, nonlinear_impl.h:2858-2905):
    # each magnitude constraint boxes its derivative's free columns to
    # +-|value|; free positions stay in [min_bound, max_bound] (the ESDF's
    # extent when a field is given and no box is).  Projected L-BFGS: clip
    # after every update.
    use_hard_bounds: bool = True
    min_bound: Optional[Tuple[float, ...]] = None
    max_bound: Optional[Tuple[float, ...]] = None
    # L-BFGS line search of optimize_time_gradient: "zoom", "backtracking"
    # (one gradient a step, value-only probes) or "hybrid" (backtracking,
    # then a zoom endgame of hybrid_zoom_iters steps with fresh memory).
    lbfgs_linesearch: str = "zoom"
    hybrid_zoom_iters: int = 4


class CostBreakdown(NamedTuple):
    total: torch.Tensor
    trajectory: torch.Tensor
    collision: torch.Tensor
    time: torch.Tensor
    soft_constraints: torch.Tensor


# Stopping-reason codes (per scenario; the NLOPT return-code analogue,
# nonlinear_impl.h:3009-3036).
STOP_MAX_ITERATIONS = 0   # ran the full fixed-length loop, still improving
STOP_FTOL_REACHED = 1     # relative cost decrease fell below f_rel

STOPPING_REASON_STRINGS = {
    STOP_MAX_ITERATIONS: "MAXEVAL_REACHED",
    STOP_FTOL_REACHED: "FTOL_REACHED",
}


def effective_iterations(cost_history: torch.Tensor, f_rel: float,
                         round_length: int = 0):
    """(n_iterations, stopping_reason) from a per-iteration cost trace
    (..., T): the first step i with |c_i - c_{i-1}| <= f_rel * |c_i|, else
    T (OptimizationInfo::n_iterations, nonlinear.h:212-231).  Both int32.

    ``round_length``: for augmented-Lagrangian traces, one fixed-length
    history per penalty round; the step across each round boundary is not
    counted (the objective jumps there).  0 = one continuous trace.
    """
    c = cost_history
    t = c.shape[-1]
    if t < 2:
        n_it = torch.full(c.shape[:-1], t, dtype=torch.int32,
                          device=c.device)
        return n_it, torch.full_like(n_it, STOP_MAX_ITERATIONS)
    prev, cur = c[..., :-1], c[..., 1:]
    floor = torch.tensor(1e-30, dtype=c.dtype, device=c.device)
    small = torch.abs(prev - cur) <= f_rel * torch.maximum(
        torch.abs(cur), floor)
    if round_length:
        j1 = torch.arange(1, t, device=c.device)
        small = small & ((j1 % round_length) != 0)
    any_small = small.any(dim=-1)
    first = torch.argmax(small.to(torch.int32), dim=-1).to(torch.int32) + 1
    n_it = torch.where(any_small, first, torch.full_like(first, t))
    reason = torch.where(any_small,
                         torch.full_like(first, STOP_FTOL_REACHED),
                         torch.full_like(first, STOP_MAX_ITERATIONS))
    return n_it, reason


class NonlinearResult(NamedTuple):
    """OptimizationInfo analogue (nonlinear.h:212-231) and the solution.

    ``maxima`` maps constraint derivative order -> final max magnitude
    (OptimizationInfo::maxima, nonlinear.h:230).  ``cost_history`` is the
    objective at the start of each outer iteration (..., T).
    ``n_iterations`` is the effective convergence iteration
    (``effective_iterations``), ``stopping_reason`` its code
    (STOPPING_REASON_STRINGS)."""
    coefficients: torch.Tensor
    times: torch.Tensor
    d_fixed: torch.Tensor
    d_free: torch.Tensor
    cost: CostBreakdown
    initial_cost: CostBreakdown
    n_iterations: torch.Tensor
    maxima: dict
    cost_history: Optional[torch.Tensor] = None
    stopping_reason: Optional[torch.Tensor] = None


def format_result(res: NonlinearResult) -> str:
    """Printable report of one scenario (OptimizationInfo::print,
    nonlinear_impl.h:29-47)."""
    c, c0 = res.cost, res.initial_cost
    reason = ""
    if res.stopping_reason is not None:
        reason = " (" + STOPPING_REASON_STRINGS.get(
            int(res.stopping_reason), "?") + ")"
    lines = ["Optimization info:",
             f"  iterations: {int(res.n_iterations)}{reason}",
             f"  total cost:            {float(c0.total):.6g} -> "
             f"{float(c.total):.6g}",
             f"  cost trajectory (J_d): {float(c.trajectory):.6g}",
             f"  cost collision (J_c):  {float(c.collision):.6g}",
             f"  cost time (J_t):       {float(c.time):.6g}",
             f"  cost soft constraints: {float(c.soft_constraints):.6g}",
             f"  total time:            {float(torch.sum(res.times)):.6g}"]
    for deriv, value in sorted(res.maxima.items()):
        lines.append(f"  max magnitude (deriv {deriv}): {float(value):.6g}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cost terms.  Batch dimensions of d_fixed broadcast to those of d_free.
# ---------------------------------------------------------------------------

def _coefficients(structure: ProblemStructure, d_fixed, d_free, times):
    """(..., K, N, D) coefficients of [d_fixed; d_free] at ``times``."""
    batch = torch.broadcast_shapes(d_fixed.shape[:-2], d_free.shape[:-2])
    d_seg = linear.segment_derivatives(
        structure, d_fixed.expand(batch + d_fixed.shape[-2:]),
        d_free.expand(batch + d_free.shape[-2:]))
    return qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)


def derivative_cost(structure: ProblemStructure, d_fixed, d_free, times):
    """J_d = d^T R d (reference convention: 2x the 0.5 c^T Q c energy;
    the cost of ``linear.derivative_cost_and_grad``)."""
    nf = structure.n_fixed
    r = linear.assemble_r(structure, times)
    r_ff = r[..., :nf, :nf]
    r_fp = r[..., :nf, nf:]
    r_pp = r[..., nf:, nf:]
    jf = torch.einsum('...fd,...fg,...gd->...', d_fixed, r_ff, d_fixed)
    jc = 2.0 * torch.einsum('...fd,...fp,...pd->...', d_fixed, r_fp, d_free)
    jp = torch.einsum('...pd,...pq,...qd->...', d_free, r_pp, d_free)
    return jf + jc + jp


def time_cost(times, time_penalty: float):
    """J_t = (sum T)^2 * penalty (objectiveFunctionTime, impl:894-896)."""
    total = torch.sum(times, dim=-1)
    return total * total * time_penalty


def _sample_segments(structure: ProblemStructure, d_fixed, d_free, times,
                     n_samples: int):
    """Positions and velocities on a fixed midpoint grid per segment:
    (pos (..., K, S, D), vel (..., K, S, D), dt (..., K))."""
    coeffs = _coefficients(structure, d_fixed, d_free, times)
    tau = (torch.arange(n_samples, dtype=times.dtype, device=times.device)
           + 0.5) / n_samples
    t_local = times[..., None] * tau                         # (..., K, S)
    per_dim = torch.movedim(coeffs, -1, -3)                  # (..., D, K, N)
    pos = basis.polyval(per_dim[..., None, :], t_local[..., None, :, :], 0)
    vel = basis.polyval(per_dim[..., None, :], t_local[..., None, :, :], 1)
    return (torch.movedim(pos, -3, -1), torch.movedim(vel, -3, -1),
            times / n_samples)


def collision_cost(structure: ProblemStructure, d_fixed, d_free, times,
                   field: esdf_mod.Esdf, params: NonlinearParameters):
    """J_c = sum_i sum_t c(x(t)) ||v(t)|| dt  (getCostAndGradientCollision,
    impl:1608-1780), on a fixed midpoint rule."""
    pos, vel, dt = _sample_segments(structure, d_fixed, d_free, times,
                                    params.collision_samples_per_segment)
    dist = esdf_mod.distance_at(field, pos)
    c = esdf_mod.collision_potential(dist, params.epsilon,
                                     params.robot_radius,
                                     params.coll_pot_multiplier)
    # Safe speed: the sqrt's gradient at ||v|| = 0 would be NaN (the
    # reference drops those samples' gradients, impl:1737-1745).
    sq = torch.sum(vel ** 2, dim=-1)
    moving = sq > 0
    speed = torch.sqrt(torch.where(moving, sq, torch.ones_like(sq)))
    speed = torch.where(moving, speed, torch.zeros_like(speed))
    return torch.sum(c * speed * dt[..., None], dim=(-2, -1))


def max_magnitude_from_d(structure: ProblemStructure, d_fixed, d_free, times,
                         derivative: int, n_grid: int = 64):
    """Differentiable global max of ||x^(der)||: analytic candidate times,
    held constant under differentiation, then evaluation
    (computeMaximumOfMagnitude, linear_impl.h:455-487)."""
    coeffs = _coefficients(structure, d_fixed, d_free, times)
    c0 = coeffs.detach()
    cand_t, valid = roots.magnitude_minmax_candidates(
        c0, derivative, torch.zeros_like(times.detach()), times.detach(),
        n_grid=n_grid, n_bisections=40)
    per_dim = torch.movedim(coeffs, -1, -3)                  # (..., D, K, N)
    vals = basis.polyval(per_dim[..., None, :], cand_t[..., None, :, :],
                         derivative)                         # (..., D, K, C)
    sq = torch.sum(torch.movedim(vals, -3, -1) ** 2, dim=-1)  # (..., K, C)
    # Double where: masked or zero candidates cannot poison the sqrt's
    # gradient.
    use = valid & (sq > 0)
    sq_safe = torch.where(use, sq, torch.ones_like(sq))
    mag = torch.where(use, torch.sqrt(sq_safe), torch.zeros_like(sq))
    return torch.amax(mag, dim=(-2, -1))


def soft_constraint_cost(structure: ProblemStructure, d_fixed, d_free, times,
                         constraints: Sequence[MagnitudeConstraint],
                         params: NonlinearParameters):
    """J_sc = sum min(max_cost, exp(rel_violation * weight))
    (evaluateMaximumMagnitudeAsSoftConstraint, impl:2735-2766), the clamp in
    log space so that the exp cannot overflow first."""
    batch = torch.broadcast_shapes(times.shape[:-1], d_free.shape[:-2])
    cost = torch.zeros(batch, dtype=times.dtype, device=times.device)
    log_cap = torch.log(torch.tensor(params.soft_constraint_max_cost,
                                     dtype=times.dtype, device=times.device))
    for c in constraints:
        mx = max_magnitude_from_d(structure, d_fixed, d_free, times,
                                  c.derivative, params.extrema_grid)
        rel = (mx - c.value) / c.value
        cost = cost + torch.exp(torch.minimum(
            rel * params.soft_constraint_weight, log_cap))
    return cost


def total_cost(structure: ProblemStructure, d_fixed, d_free, times,
               params: NonlinearParameters,
               constraints: Sequence[MagnitudeConstraint] = (),
               field: Optional[esdf_mod.Esdf] = None,
               include_derivative_weight: bool = True) -> CostBreakdown:
    """Weighted objective of the FREE_CONSTRAINTS* objectives."""
    w = params.weights
    j_d = derivative_cost(structure, d_fixed, d_free, times)
    j_t = time_cost(times, params.time_penalty)
    zero = torch.zeros_like(j_d)
    j_c = (collision_cost(structure, d_fixed, d_free, times, field, params)
           if field is not None else zero)
    j_sc = (soft_constraint_cost(structure, d_fixed, d_free, times,
                                 constraints, params)
            if params.use_soft_constraints and constraints else zero)
    w_d = w.w_d if include_derivative_weight else 1.0
    obj = params.objective
    use_time = obj in (Objective.FREE_CONSTRAINTS_AND_TIME, Objective.TIME,
                       Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME)
    use_coll = field is not None and obj in (
        Objective.TIME, Objective.FREE_CONSTRAINTS_AND_COLLISION,
        Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME)
    total = (w_d * j_d
             + (w.w_t * j_t if use_time else zero)
             + (w.w_c * j_c if use_coll else zero)
             + (w.w_sc * j_sc))
    return CostBreakdown(total=total, trajectory=j_d, collision=j_c,
                         time=j_t, soft_constraints=j_sc)


# ---------------------------------------------------------------------------
# Bounds.
# ---------------------------------------------------------------------------

def map_bounds(field: esdf_mod.Esdf) -> Tuple[np.ndarray, np.ndarray]:
    """(min_bound, max_bound) spanned by an ESDF's voxel centers: the map
    box when NonlinearParameters pins none."""
    shape = np.asarray(field.distance.shape, np.float64)
    origin = np.asarray(field.origin.detach().cpu().numpy(), np.float64)
    res = float(field.resolution)
    return origin, origin + (shape - 1.0) * res


def free_derivative_bounds(structure: ProblemStructure,
                           constraints: Sequence[MagnitudeConstraint] = (),
                           min_bound=None, max_bound=None,
                           dtype: torch.dtype = torch.float32,
                           device: DeviceLike = None):
    """Per-free-column box bounds (lo, hi), each (n_free, D), on ``device``
    (None means the CUDA card).

    Reference semantics (setFreeEndpointDerivativeHardConstraints,
    nonlinear_impl.h:2858-2905): every bound starts at +-inf; each magnitude
    constraint boxes its derivative order's free columns to +-|value|; free
    position columns are pinned to the map box [min_bound, max_bound].
    """
    dev = resolve_device(device)
    n_free, dim = structure.n_free, structure.dimension
    lo = np.full((n_free, dim), -np.inf)
    hi = np.full((n_free, dim), np.inf)
    derivs = structure.free_cols[:, 1]
    for c in constraints:
        rows = derivs == c.derivative
        lo[rows] = -abs(c.value)
        hi[rows] = abs(c.value)
    if min_bound is not None or max_bound is not None:
        rows = derivs == 0
        if min_bound is not None:
            lo[rows] = np.broadcast_to(np.asarray(min_bound, np.float64),
                                       (dim,))
        if max_bound is not None:
            hi[rows] = np.broadcast_to(np.asarray(max_bound, np.float64),
                                       (dim,))
    return (torch.as_tensor(lo, dtype=dtype, device=dev),
            torch.as_tensor(hi, dtype=dtype, device=dev))


def _resolve_bounds(structure: ProblemStructure,
                    params: NonlinearParameters,
                    constraints: Sequence[MagnitudeConstraint],
                    field: Optional[esdf_mod.Esdf], dtype: torch.dtype,
                    device: DeviceLike = None):
    """The (lo, hi) box of this optimize() call, or None when every bound
    would be infinite (no constraints, no map)."""
    if not params.use_hard_bounds:
        return None
    mn, mx = params.min_bound, params.max_bound
    if mn is None and mx is None and field is not None:
        mn, mx = map_bounds(field)
    if not constraints and mn is None and mx is None:
        return None
    return free_derivative_bounds(structure, constraints, mn, mx, dtype,
                                  device)


def _clip(x, lo, hi):
    """jnp.clip's arithmetic and gradient (half at a tie)."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# Nelder-Mead.
# ---------------------------------------------------------------------------

def nelder_mead(fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                n_iters: int, scale: float):
    """Fixed-shape Nelder-Mead over x (..., n), each scenario its own
    simplex: the gradient-free path of the TIME objective (the reference
    CHECKs that no gradient is requested, impl:881-882).

    ``fn`` maps (P, ..., n) to (P, ...) and (..., n) to (...).  Five
    evaluations an iteration: the four trial points as one call, and the
    shrink point.  Returns (x_best (..., n), f_best (...), history
    (..., n_iters): the simplex's best value after each iteration).
    """
    n = x0.shape[-1]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    eye = eye.reshape((n,) + (1,) * (x0.dim() - 1) + (n,))
    pts = torch.cat([x0[None], x0[None] + scale * eye], dim=0)
    with torch.no_grad():
        fvals = fn(pts)
        history = []
        for _ in range(n_iters):
            order = torch.argsort(fvals, dim=0, stable=True)
            pts = torch.take_along_dim(pts, order[..., None], dim=0)
            fvals = torch.take_along_dim(fvals, order, dim=0)
            best, worst = pts[0], pts[-1]
            centroid = torch.mean(pts[:-1], dim=0)
            xr = centroid + 1.0 * (centroid - worst)
            xe = centroid + 2.0 * (centroid - worst)
            xoc = centroid + 0.5 * (centroid - worst)
            xic = centroid - 0.5 * (centroid - worst)
            fr, fe, foc, fic = fn(torch.stack([xr, xe, xoc, xic]))
            f_best, f_second, f_worst = fvals[0], fvals[-2], fvals[-1]
            # standard acceptance, as selects
            use_expand = (fr < f_best) & (fe < fr)
            use_reflect = (fr < f_second) & ~use_expand
            use_oc = (fr >= f_second) & (fr < f_worst) & (foc <= fr)
            use_ic = (fr >= f_worst) & (fic < f_worst)
            accepted = use_expand | use_reflect | use_oc | use_ic
            m = lambda c: c[..., None]
            new_pt = torch.where(m(use_expand), xe, torch.where(
                m(use_reflect), xr, torch.where(
                    m(use_oc), xoc, torch.where(m(use_ic), xic, worst))))
            new_f = torch.where(use_expand, fe, torch.where(
                use_reflect, fr, torch.where(
                    use_oc, foc, torch.where(use_ic, fic, f_worst))))
            # none accepted: pull the worst point toward the best
            # (single-point shrink; the evaluation count stays fixed)
            shrink_pt = best + 0.5 * (worst - best)
            f_shrink = fn(shrink_pt)
            new_pt = torch.where(m(accepted), new_pt, shrink_pt)
            new_f = torch.where(accepted, new_f, f_shrink)
            pts = torch.cat([pts[:-1], new_pt[None]], dim=0)
            fvals = torch.cat([fvals[:-1], new_f[None]], dim=0)
            history.append(torch.amin(fvals, dim=0))
    ibest = torch.argmin(fvals, dim=0)
    x_best = torch.take_along_dim(pts, ibest[None, ..., None], dim=0)[0]
    f_best = torch.take_along_dim(fvals, ibest[None], dim=0)[0]
    hist = (torch.stack(history, dim=-1) if history else
            torch.zeros(fvals.shape[1:] + (0,), dtype=fvals.dtype,
                        device=fvals.device))
    return x_best, f_best, hist


# ---------------------------------------------------------------------------
# optimize().
# ---------------------------------------------------------------------------

class _Inner(NamedTuple):
    d_free: torch.Tensor
    cost: torch.Tensor


def _field_on(field: Optional[esdf_mod.Esdf], dev: torch.device):
    if field is None:
        return None
    return esdf_mod.Esdf(field.distance.to(dev), field.origin.to(dev),
                         field.resolution.to(dev), field.method)


def _rows(a: Optional[torch.Tensor], batch, tail: int):
    """``a`` broadcast to ``batch`` and flattened to one row axis."""
    if a is None:
        return None
    shape = a.shape[a.dim() - tail:]
    return a.expand(batch + shape).reshape((-1,) + shape)


def _guarded(cost: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """+inf where the cost is not finite or the derivative energy negative
    (the float32 solve overflowing near the 0.1 s box edge, where T^(1-2d)
    spans ~17 decades): the searches back off from it."""
    ok = torch.isfinite(cost) & (energy >= 0.0)
    return torch.where(ok, cost, torch.full_like(cost, float("inf")))


def optimize(structure: ProblemStructure, d_fixed, times_init,
             params: NonlinearParameters,
             constraints: Sequence[MagnitudeConstraint] = (),
             field: Optional[esdf_mod.Esdf] = None,
             waypoints=None, radii=None,
             admm_config: qcqp.ADMMConfig = qcqp.ADMMConfig(),
             d_free_init=None, device: DeviceLike = None) -> NonlinearResult:
    """Run the configured nonlinear objective (reference optimize(),
    nonlinear_impl.h:275-331) over a batch of scenarios.

    d_fixed (..., n_fixed, D) and times_init (..., K) broadcast to the batch;
    waypoints (..., V, D) and radii (..., K, 2) select the QCQP inner solve
    of the TIME objective (else the linear solve); d_free_init (...,
    n_free, D).  ``field`` is one ESDF for the whole batch.  The working
    dtype is the promotion of d_fixed and times_init; ``device``: None means
    the CUDA card.  Results carry the batch dimensions in front.
    """
    dev = resolve_device(device)
    dtype = torch.promote_types(tensor_dtype(d_fixed),
                                tensor_dtype(times_init))
    d_fixed = as_tensor(d_fixed, dtype, dev)
    times_init = as_tensor(times_init, dtype, dev)
    batch = torch.broadcast_shapes(d_fixed.shape[:-2], times_init.shape[:-1])
    opt = lambda a: None if a is None else as_tensor(a, dtype, dev)
    waypoints, radii, d_free_init = (opt(waypoints), opt(radii),
                                     opt(d_free_init))
    for a, tail in ((waypoints, 2), (radii, 2), (d_free_init, 2)):
        if a is not None:
            batch = torch.broadcast_shapes(batch, a.shape[:-tail])
    field = _field_on(field, dev)
    with torch.no_grad():
        res = _optimize_rows(
            structure, _rows(d_fixed, batch, 2), _rows(times_init, batch, 1),
            params, tuple(constraints), field, _rows(waypoints, batch, 2),
            _rows(radii, batch, 2), admm_config,
            _rows(d_free_init, batch, 2))
    return _unflatten(res, batch)


def _unflatten(res: NonlinearResult, batch) -> NonlinearResult:
    def shape(a):
        return a.reshape(batch + a.shape[1:])
    return NonlinearResult(
        coefficients=shape(res.coefficients), times=shape(res.times),
        d_fixed=shape(res.d_fixed), d_free=shape(res.d_free),
        cost=CostBreakdown(*(shape(a) for a in res.cost)),
        initial_cost=CostBreakdown(*(shape(a) for a in res.initial_cost)),
        n_iterations=shape(res.n_iterations),
        maxima={k: shape(v) for k, v in res.maxima.items()},
        cost_history=shape(res.cost_history),
        stopping_reason=shape(res.stopping_reason))


def _optimize_rows(structure, d_fixed, times_init, params, constraints,
                   field, waypoints, radii, admm_config, d_free_init):
    """``optimize`` on one row axis: (B, ...) tensors of one dtype."""
    dtype, dev = times_init.dtype, times_init.device
    bsz = times_init.shape[0]
    n_free, dim = structure.n_free, structure.dimension

    def inner_solve(times):
        """The inner solve at times (..., B, K): d_free and cost."""
        if radii is None:
            sol = linear.solve_linear(structure, d_fixed, times)
            return _Inner(sol.d_free, sol.cost)
        lead = times.shape[:-2]
        full = lead + (bsz,)
        sol = qcqp._solve_qcqp_rows(
            structure, _rows(d_fixed, full, 2),
            times.reshape((-1,) + times.shape[-1:]),
            _rows(waypoints, full, 2), _rows(radii, full, 2), admm_config)
        return _Inner(sol.d_free.reshape(full + sol.d_free.shape[1:]),
                      sol.cost.reshape(full))

    if d_free_init is None:
        d_free_init = inner_solve(times_init).d_free
    breakdown0 = total_cost(structure, d_fixed, d_free_init, times_init,
                            params, constraints, field)

    # Hard box bounds on d_free (nonlinear_impl.h:2858-2905, consumed by
    # every FREE_CONSTRAINTS* objective at :461,552,781): projected L-BFGS.
    bounds = _resolve_bounds(structure, params, constraints, field, dtype,
                             dev)
    nfd = n_free * dim
    if bounds is None:
        project_d = None
    else:
        lo, hi = (b.reshape(nfd) for b in bounds)
        project_d = lambda x: _clip(x, lo, hi)

    def as_d(x):
        return x.reshape(x.shape[:-1] + (n_free, dim))

    obj = params.objective
    ftol_round_length = 0
    if obj == Objective.TIME:
        t_lo = torch.tensor(params.time_lower_bound, dtype=dtype, device=dev)
        t_hi = params.time_upper_factor * times_init

        def clip_times(theta):
            return _clip(times_init * torch.exp(theta), t_lo, t_hi)

        def fn(theta):
            times = clip_times(theta)
            sol = inner_solve(times)
            # objectiveFunctionTime (impl:894-944): the 0.5 c^T Q c cost
            # plus the time, collision and soft terms
            cost = sol.cost + time_cost(times, params.time_penalty)
            if field is not None:
                cost = cost + params.weights.w_c * collision_cost(
                    structure, d_fixed, sol.d_free, times, field, params)
            if params.use_soft_constraints and constraints:
                cost = cost + soft_constraint_cost(
                    structure, d_fixed, sol.d_free, times, constraints,
                    params)
            return _guarded(cost, sol.cost)

        theta, _, history = nelder_mead(fn, torch.zeros_like(times_init),
                                        params.max_iterations,
                                        params.nelder_mead_scale)
        times_fin = clip_times(theta)
        d_free_fin = inner_solve(times_fin).d_free
    elif obj in (Objective.FREE_CONSTRAINTS,
                 Objective.FREE_CONSTRAINTS_AND_COLLISION):
        hard = bool(constraints) and not params.use_soft_constraints
        x = d_free_init.reshape(bsz, nfd)
        if hard:
            # Augmented Lagrangian over g_c = max||x^(der)|| - value <= 0
            # (NLOPT's add_inequality_constraint path, impl:848-875,
            # 2686-2733): minimize f + sum_c [lam_c g_c
            # + 0.5 mu relu(g_c + lam_c/mu)^2], lam <- relu(lam + mu g).
            inner_iters = max(params.max_iterations // params.al_rounds, 1)
            ftol_round_length = inner_iters

            def g_of(d_free):
                return torch.stack([
                    max_magnitude_from_d(structure, d_fixed, d_free,
                                         times_init, c.derivative,
                                         params.extrema_grid) - c.value
                    for c in constraints], dim=-1)

            def al_cost(x, lam, mu):
                d_free = as_d(x)
                base = total_cost(structure, d_fixed, d_free, times_init,
                                  params, (), field).total
                shifted = torch.clamp(g_of(d_free) + lam / mu, min=0.0)
                return base + torch.sum(0.5 * mu * shifted * shifted
                                        - 0.5 * lam * lam / mu, dim=-1)

            histories = []
            lam = torch.zeros((bsz, len(constraints)), dtype=dtype,
                              device=dev)
            mu = float(params.al_penalty)
            for _ in range(params.al_rounds):
                x, vals = lbfgs_minimize(
                    lambda x, lam=lam, mu=mu: al_cost(x, lam, mu), x,
                    inner_iters, project=project_d)
                histories.append(vals)
                lam = torch.clamp(lam + mu * g_of(as_d(x)), min=0.0)
                mu = mu * params.al_penalty_growth
            history = torch.cat(histories, dim=-1)
        else:
            def fn(x):
                return total_cost(structure, d_fixed, as_d(x), times_init,
                                  params, constraints, field).total
            x, history = lbfgs_minimize(fn, x, params.max_iterations,
                                        project=project_d)
        d_free_fin = as_d(x)
        times_fin = times_init
    else:   # the joint (d_free, theta) objectives
        # log-time scaling bounded to the reference's [0.1, 2 t_init] box
        # spirit (optimizeTime, impl:342-378): an unbounded step in theta
        # would overflow the T^(2N-1) powers
        cap = torch.tensor(math.log(params.time_upper_factor), dtype=dtype,
                           device=dev)

        def scale_times(theta):
            return times_init * torch.exp(_clip(theta, -cap, cap))

        def fn(x):
            return total_cost(structure, d_fixed, as_d(x[:, :nfd]),
                              scale_times(x[:, nfd:]), params, constraints,
                              field).total

        project = (None if project_d is None else lambda x: torch.cat(
            [project_d(x[:, :nfd]), x[:, nfd:]], dim=-1))
        x0 = torch.cat([d_free_init.reshape(bsz, nfd),
                        torch.zeros_like(times_init)], dim=-1)
        x, history = lbfgs_minimize(fn, x0, params.max_iterations,
                                    project=project)
        d_free_fin = as_d(x[:, :nfd])
        times_fin = scale_times(x[:, nfd:])

    sol = linear.solve_linear_with_free(structure, d_fixed, d_free_fin,
                                        times_fin)
    breakdown = total_cost(structure, d_fixed, d_free_fin, times_fin, params,
                           constraints, field)
    maxima = {c.derivative: max_magnitude_from_d(
        structure, d_fixed, d_free_fin, times_fin, c.derivative,
        params.extrema_grid) for c in constraints}
    n_eff, stop_reason = effective_iterations(
        history, params.f_rel, round_length=ftol_round_length)
    return NonlinearResult(
        coefficients=sol.coefficients, times=times_fin, d_fixed=d_fixed,
        d_free=d_free_fin, cost=breakdown, initial_cost=breakdown0,
        n_iterations=n_eff, maxima=maxima, cost_history=history,
        stopping_reason=stop_reason)


def optimize_time_gradient(structure: ProblemStructure, d_fixed, times_init,
                           params: NonlinearParameters,
                           n_iters: Optional[int] = None,
                           device: DeviceLike = None):
    """Segment-time optimization by L-BFGS through the inner linear solve
    (the reference falls back to 2K-per-iteration finite differences,
    getCostAndGradientTime, impl:2495-2584); ``params.lbfgs_linesearch``
    picks the line search.  Batched like ``optimize``.

    Returns (times (..., K), cost_history (..., n_iters)).
    """
    dev = resolve_device(device)
    dtype = torch.promote_types(tensor_dtype(d_fixed),
                                tensor_dtype(times_init))
    d_fixed = as_tensor(d_fixed, dtype, dev)
    times_init = as_tensor(times_init, dtype, dev)
    batch = torch.broadcast_shapes(d_fixed.shape[:-2], times_init.shape[:-1])
    d_fixed = _rows(d_fixed, batch, 2)
    times_init = _rows(times_init, batch, 1)

    # the log scaling bounded to the time box [t_lo, f_up * t_init]
    # (optimizeTime, impl:342-378): an unbounded step overflows T^(2N-1)
    theta_lo = torch.log(torch.tensor(params.time_lower_bound, dtype=dtype,
                                      device=dev) / times_init)
    theta_hi = torch.tensor(math.log(params.time_upper_factor), dtype=dtype,
                            device=dev)

    def fn(theta):
        times = times_init * torch.exp(_clip(theta, theta_lo, theta_hi))
        sol = linear.solve_linear(structure, d_fixed, times)
        return _guarded(sol.cost + time_cost(times, params.time_penalty),
                        sol.cost)

    with torch.no_grad():
        # normalized by the initial cost, so that the first (steepest
        # descent) direction is O(1) whatever the objective's scale
        zero = torch.zeros_like(times_init)
        c0 = fn(zero)
        c0 = torch.where(torch.isfinite(c0) & (c0 > 0), c0,
                         torch.ones_like(c0))
        theta, values = lbfgs_minimize(
            lambda th: fn(th) / c0, zero,
            params.max_iterations if n_iters is None else n_iters,
            project=lambda th: _clip(th, theta_lo, theta_hi),
            linesearch=params.lbfgs_linesearch,
            hybrid_zoom_iters=params.hybrid_zoom_iters)
        theta = _clip(theta, theta_lo, theta_hi)
        times = times_init * torch.exp(theta)
        history = values * c0[:, None]
    return (times.reshape(batch + times.shape[-1:]),
            history.reshape(batch + history.shape[-1:]))
