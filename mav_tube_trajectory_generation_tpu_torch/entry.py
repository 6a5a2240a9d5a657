"""A forward step on the flagship configuration, for a first check that the
package runs on a device: the counterpart of the JAX package's
``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)``: ``fn(d_fixed, times)`` solves a
batch of 10-segment, 3-D, N=10 min-snap problems (``solve_linear``) and
rolls each trajectory out at 32 points of its duration (positions and
velocities); ``example_args`` is a batch of 16 such problems on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._tensors import DeviceLike, resolve_device
from .models import trajectory as tj
from .models.vertex import segment_times_nfabian
from .solver import linear
from .solver import structure as sm


def _flagship_structure():
    return sm.make_structure(sm.standard_mask(11, 10), dimension=3,
                             n_coefficients=10)


def _example_inputs(structure, batch: int, dtype: torch.dtype,
                    device: torch.device):
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, 11, 3)), axis=1)
    values = np.zeros((batch, 11, 5, 3))
    values[:, :, 0, :] = waypoints
    times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0))
    d_fixed = linear.extract_fixed_values(structure,
                                          torch.as_tensor(values))
    return (d_fixed.to(device=device, dtype=dtype),
            torch.as_tensor(times, dtype=dtype, device=device))


def entry(device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """(fn, example_args): the batched solve and rollout, and a batch of 16
    problems in ``dtype`` on ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    structure = _flagship_structure()

    def forward(d_fixed, times):
        sol = linear.solve_linear(structure, d_fixed, times)
        traj = tj.Trajectory(sol.coefficients, sol.times)
        total = torch.sum(times, dim=-1, keepdim=True)
        ts = total * torch.linspace(0.0, 0.999, 32, dtype=times.dtype,
                                    device=times.device)
        return sol.cost, tj.evaluate(traj, ts, 0), tj.evaluate(traj, ts, 1)

    return forward, _example_inputs(structure, 16, dtype, dev)
