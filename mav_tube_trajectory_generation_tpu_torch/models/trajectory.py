"""Trajectory model: stacked piecewise-polynomial segments.

Counterpart of the JAX package's ``models/trajectory.py`` (the reference's
``Segment``/``Trajectory``, segment.h:43-125, trajectory.h:32-130): one
NamedTuple of tensors,

    coefficients: (..., K, N, D) increasing-power monomial coefficients,
    times:        (..., K) per-segment durations,

so a batch of trajectories is one object and every operation (evaluation,
sampling, extrema) runs on the whole batch on the tensors' device.  A global
time is mapped to its segment by counting the boundaries at or below it (the
reference's accumulate-and-compare loop, trajectory.cpp:41-72): a time
exactly on a boundary belongs to the later segment.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops import basis, roots
from ..utils import timing


class Trajectory(NamedTuple):
    coefficients: torch.Tensor    # (..., K, N, D)
    times: torch.Tensor           # (..., K)

    @property
    def n_segments(self) -> int:
        return self.coefficients.shape[-3]

    @property
    def n_coefficients(self) -> int:
        return self.coefficients.shape[-2]

    @property
    def dimension(self) -> int:
        return self.coefficients.shape[-1]

    @property
    def max_time(self) -> torch.Tensor:
        """Total duration (trajectory.h getMaxTime)."""
        return self.times.sum(dim=-1)


class Extremum(NamedTuple):
    """(time within the segment, value, segment index): extremum.h:30-44."""
    time: torch.Tensor
    value: torch.Tensor
    segment_index: torch.Tensor


def _take_last(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx, axis=-1)`` with the leading dimensions of
    ``a`` (..., K) and ``idx`` (..., T) broadcast against each other."""
    batch = torch.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
    return torch.gather(a.expand(batch + a.shape[-1:]), -1,
                        idx.expand(batch + idx.shape[-1:]))


def _segment_lookup(times: torch.Tensor, t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global time -> (segment index, local time), by a boundary count."""
    cum = torch.cumsum(times, dim=-1)                     # (..., K)
    boundaries = cum[..., :-1]                            # (..., K-1)
    seg = (t[..., None] >= boundaries[..., None, :]).sum(dim=-1)
    start = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                      dim=-1)
    return seg, t - _take_last(start, seg)


def _time_tensor(traj: Trajectory, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=traj.coefficients.dtype,
                           device=traj.coefficients.device)


def evaluate(traj: Trajectory, t, derivative: int = 0) -> torch.Tensor:
    """The trajectory at global times t: (..., T) -> (..., T, D) (a scalar
    t counts as T = 1).

    Reference: Trajectory::evaluate (trajectory.cpp:41-72) and
    Segment::evaluate (segment.cpp:51-58), batched.
    """
    t = torch.atleast_1d(_time_tensor(traj, t))
    seg, local = _segment_lookup(traj.times, t)           # (..., T)
    seg = seg.clamp(0, traj.n_segments - 1)
    coeffs = traj.coefficients
    batch = torch.broadcast_shapes(coeffs.shape[:-3], seg.shape[:-1])
    idx = seg[..., None, None].expand(batch + seg.shape[-1:]
                                      + coeffs.shape[-2:])
    coeffs = torch.gather(coeffs.expand(batch + coeffs.shape[-3:]), -3, idx)
    # Horner over the coefficient axis, per dimension: (..., T, D, N)
    return basis.polyval(coeffs.transpose(-1, -2), local[..., None],
                         derivative)


def evaluate_segment(traj: Trajectory, segment_index, local_t,
                     derivative: int = 0) -> torch.Tensor:
    """One segment at local time(s): (..., T, D)."""
    seg = torch.as_tensor(segment_index, device=traj.coefficients.device)
    coeffs = traj.coefficients
    batch = torch.broadcast_shapes(coeffs.shape[:-3], seg.shape)
    idx = seg[..., None, None, None].expand(batch + (1,) + coeffs.shape[-2:])
    coeffs = torch.gather(coeffs.expand(batch + coeffs.shape[-3:]), -3,
                          idx)[..., 0, :, :]              # (..., N, D)
    local_t = torch.atleast_1d(_time_tensor(traj, local_t))
    return basis.polyval(coeffs.transpose(-1, -2)[..., None, :, :],
                         local_t[..., None], derivative)


def sample_times(traj_times: np.ndarray, dt: float) -> np.ndarray:
    """Sampling instants [0, total] at spacing dt, on the host
    (Trajectory::evaluateRange's stepping, trajectory.cpp:74-134)."""
    total = float(np.sum(traj_times))
    n = int(np.floor(total / dt)) + 1
    return np.arange(n) * dt


def evaluate_range(traj: Trajectory, ts, derivative: int = 0
                   ) -> torch.Tensor:
    """The trajectory on a given grid of global times."""
    return evaluate(traj, ts, derivative)


def min_max_magnitude(traj: Trajectory, derivative: int,
                      n_grid: int = roots.DEFAULT_GRID
                      ) -> Tuple[Extremum, Extremum]:
    """Global min and max of ||x^(d)(t)|| over the whole trajectory.

    Candidates per segment: the magnitude derivative's roots and the
    segment's endpoints (Trajectory::computeMinMaxMagnitude,
    trajectory.cpp:184-220; Segment::computeMinMaxMagnitudeCandidates,
    segment.cpp:135-158), for all segments and batch rows at once.  Ties
    (adjacent segments share an endpoint) go to the first candidate.

    While spans are on (``utils.timing``) the call is the span ``extrema``,
    on the coefficients' device, with ``extrema/candidates`` (the candidate
    polynomial and the grid bracket) and ``extrema/select`` (evaluation,
    magnitudes, arg-min and arg-max) inside; the counter ``extrema.roots``
    adds the valid interior candidates (read from the device with the log).
    """
    coeffs = traj.coefficients                             # (..., K, N, D)
    times = traj.times
    with timing.span("extrema", coeffs.device):
        with timing.span("candidates"):
            cand_t, valid = roots.magnitude_minmax_candidates(
                coeffs, derivative, torch.zeros_like(times), times,
                n_grid=n_grid)                             # (..., K, C)
        # the first two candidates of a segment are its endpoints
        timing.count("extrema.roots", valid[..., 2:])
        with timing.span("select"):
            vals = basis.polyval(coeffs.transpose(-1, -2)[..., None, :, :],
                                 cand_t[..., None], derivative)  # (..., K, C, D)
            mag = torch.sqrt((vals * vals).sum(dim=-1))    # (..., K, C)

            big = torch.finfo(mag.dtype).max
            k, c = mag.shape[-2], mag.shape[-1]
            flat = mag.shape[:-2] + (k * c,)
            flat_min = torch.where(valid, mag, big).reshape(flat)
            flat_max = torch.where(valid, mag, -big).reshape(flat)
            flat_t = cand_t.reshape(flat)
            imin = torch.argmin(flat_min, dim=-1, keepdim=True)
            imax = torch.argmax(flat_max, dim=-1, keepdim=True)

            def take(a, i):
                return torch.gather(a, -1, i)[..., 0]
            mins = Extremum(time=take(flat_t, imin),
                            value=take(flat_min, imin),
                            segment_index=imin[..., 0] // c)
            maxs = Extremum(time=take(flat_t, imax),
                            value=take(flat_max, imax),
                            segment_index=imax[..., 0] // c)
    return mins, maxs


def max_magnitude(traj: Trajectory, derivative: int,
                  n_grid: int = roots.DEFAULT_GRID) -> Extremum:
    """Global maximum of ||x^(d)||: the feasibility primitive
    (computeMaximumOfMagnitude, linear_impl.h:455-487)."""
    return min_max_magnitude(traj, derivative, n_grid)[1]


def get_segment_dimension(traj: Trajectory, dims: Sequence[int]
                          ) -> Trajectory:
    """The trajectory on a subset of its spatial dimensions
    (Trajectory::getTrajectoryWithSingleDimension, trajectory.cpp:136-182)."""
    idx = torch.as_tensor(list(dims), device=traj.coefficients.device)
    return Trajectory(
        coefficients=torch.index_select(traj.coefficients, -1, idx),
        times=traj.times)


def append(a: Trajectory, b: Trajectory) -> Trajectory:
    """Two trajectories one after the other (trajectory.cpp:230-249)."""
    return Trajectory(
        coefficients=torch.cat([a.coefficients, b.coefficients], dim=-3),
        times=torch.cat([a.times, b.times], dim=-1))


def add_trajectories(trajectories: Sequence[Trajectory],
                     check_continuity: bool = True,
                     max_derivative: int = 0,
                     tolerance: float = 1e-6) -> Trajectory:
    """N-way concatenation in time (Trajectory::addTrajectories,
    trajectory.h:93-94, trajectory.cpp:230-249).

    The D/N check is the reference's; ``check_continuity`` also requires
    each piece to start where the previous one ends, in derivatives
    0..max_derivative, and raises ValueError on a gap.  That check reads the
    values back to the host (it waits for the device): an API for setting
    up, not for a timed loop.
    """
    if not trajectories:
        raise ValueError("Need at least one trajectory.")
    n = trajectories[0].n_coefficients
    d = trajectories[0].dimension
    for i, t in enumerate(trajectories[1:], start=1):
        if t.n_coefficients != n or t.dimension != d:
            raise ValueError(
                f"Trajectory {i} has (N={t.n_coefficients}, D={t.dimension})"
                f" != (N={n}, D={d}) of trajectory 0 (reference "
                "addTrajectories D/N check, trajectory.cpp:239-241).")
    if check_continuity:
        for i in range(len(trajectories) - 1):
            goal = get_vertex_at_time(trajectories[i],
                                      trajectories[i].max_time,
                                      max_derivative)
            start = get_vertex_at_time(trajectories[i + 1], 0.0,
                                       max_derivative)
            gap = float((goal - start).abs().max().cpu())
            if not np.isfinite(gap) or gap > tolerance:
                raise ValueError(
                    f"Trajectory {i}'s goal vertex != trajectory {i + 1}'s "
                    f"start vertex (max gap {gap:.3e} > tol {tolerance:.1e} "
                    f"over derivatives 0..{max_derivative}).")
    merged = trajectories[0]
    for t in trajectories[1:]:
        merged = append(merged, t)
    return merged


def scale_trajectory_time(traj: Trajectory, factor) -> Trajectory:
    """Stretch the trajectory in time by ``factor`` (> 1 slows), exactly:
    with s = 1/factor coefficient i scales by s^i, so x'(t) = x(s t) and
    derivative d scales by s^d.  ``factor`` is a scalar or one per batch
    row (..., ).  (The upstream project's scaleSegmentTimes intent.)"""
    factor = torch.as_tensor(factor, dtype=traj.coefficients.dtype,
                             device=traj.coefficients.device)
    i = torch.arange(traj.n_coefficients, dtype=factor.dtype,
                     device=factor.device)
    scale = (1.0 / factor[..., None]) ** i                 # (..., N)
    return Trajectory(
        coefficients=traj.coefficients * scale[..., None, :, None],
        times=traj.times * factor[..., None])


def scale_times_to_limits(traj: Trajectory, v_max: float, a_max: float,
                          n_grid: int = roots.DEFAULT_GRID) -> Trajectory:
    """The smallest uniform time stretch that meets the velocity and
    acceleration limits (scaleSegmentTimesWithViolation intent,
    test_polynomial_optimization.cpp:661): velocity scales by 1/factor and
    acceleration by 1/factor^2, so factor = max(1, vmax/v_max,
    sqrt(amax/a_max)) repairs both in closed form."""
    vmax = min_max_magnitude(traj, 1, n_grid)[1].value
    amax = min_max_magnitude(traj, 2, n_grid)[1].value
    factor = torch.clamp(torch.maximum(
        vmax / v_max, torch.sqrt(torch.clamp(amax / a_max, min=0.0))),
        min=1.0)
    return scale_trajectory_time(traj, factor)


def append_dimension(a: Trajectory, b: Trajectory) -> Trajectory:
    """Two trajectories' spatial dimensions side by side (same K and
    times): Trajectory::getTrajectoryWithAppendedDimension
    (trajectory.cpp:156-182)."""
    return Trajectory(
        coefficients=torch.cat([a.coefficients, b.coefficients], dim=-1),
        times=a.times)


def get_vertex_at_time(traj: Trajectory, t, max_derivative: int
                       ) -> torch.Tensor:
    """Derivatives 0..max_derivative at global time t as a
    (..., max_derivative + 1, D) tensor (Trajectory::getVertexAtTime,
    trajectory.h:97): row d is the d-th derivative of position.  A tensor t
    of shape (..., T) gives (..., max_derivative + 1, T, D)."""
    t = _time_tensor(traj, t)
    out = torch.stack([evaluate(traj, t, d)
                       for d in range(max_derivative + 1)], dim=-3)
    if t.ndim == 0:
        out = out[..., 0, :]       # drop the promoted time axis
    return out


def start_position(traj: Trajectory, derivative: int = 0) -> torch.Tensor:
    """The trajectory's start state (Trajectory::getStartVertex)."""
    per_dim = traj.coefficients[..., 0, :, :].transpose(-1, -2)
    return basis.polyval(per_dim, 0.0, derivative)


def goal_position(traj: Trajectory, derivative: int = 0) -> torch.Tensor:
    """The trajectory's goal state (Trajectory::getGoalVertex)."""
    per_dim = traj.coefficients[..., -1, :, :].transpose(-1, -2)
    return basis.polyval(per_dim, traj.times[..., -1, None], derivative)
