"""Per-segment API (the reference's ``Segment``, segment.h:43-125): thin
wrappers over the batched functions of ``ops`` and ``models.trajectory``.

Counterpart of the JAX package's ``models/segment.py``.  A segment is one
row of the stacked representation: coefficients (N, D) and a scalar time.
Every function also takes leading batch dimensions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops import basis, roots
from .trajectory import Extremum, Trajectory, min_max_magnitude


def evaluate(coefficients: torch.Tensor, t, derivative: int = 0
             ) -> torch.Tensor:
    """A segment's D polynomials at local time(s) t.

    Args:
      coefficients: (..., N, D).
      t: scalar or (..., T).

    Returns:
      (..., T, D), or (..., D) for a scalar t (Segment::evaluate,
      segment.cpp:51-58).
    """
    t = torch.as_tensor(t, dtype=coefficients.dtype,
                        device=coefficients.device)
    scalar = t.ndim == 0
    out = basis.polyval(coefficients.transpose(-1, -2)[..., None, :, :],
                        torch.atleast_1d(t)[..., None], derivative)
    return out[..., 0, :] if scalar else out


def min_max_magnitude_candidate_times(coefficients: torch.Tensor,
                                      derivative: int, t_start, t_end
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(candidate times, valid mask) for the extrema of ||x^(d)|| on
    [t_start, t_end]: the endpoints and the roots of d/dt ||x^(d)||^2
    (Segment::computeMinMaxMagnitudeCandidateTimes, segment.cpp:82-133)."""
    return roots.magnitude_minmax_candidates(coefficients, derivative,
                                             t_start, t_end)


def min_max_magnitude_single(coefficients: torch.Tensor, time,
                             derivative: int) -> Tuple[Extremum, Extremum]:
    """(min, max) of ||x^(d)|| over one segment
    (Segment::computeMinMaxMagnitude, segment.cpp:160-184)."""
    times = torch.as_tensor(time, dtype=coefficients.dtype,
                            device=coefficients.device)
    traj = Trajectory(coefficients=coefficients[..., None, :, :],
                      times=times[..., None])
    return min_max_magnitude(traj, derivative)


def get_segment_dimension(coefficients: torch.Tensor,
                          dims: Sequence[int]) -> torch.Tensor:
    """The segment on a subset of its spatial dimensions
    (segment.cpp:186-211)."""
    idx = torch.as_tensor(list(dims), device=coefficients.device)
    return torch.index_select(coefficients, -1, idx)


def append_dimensions(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two segments' dimensions side by side (segment.cpp:213-248)."""
    return torch.cat([a, b], dim=-1)
