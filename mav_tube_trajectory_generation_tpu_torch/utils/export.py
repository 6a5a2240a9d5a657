"""Trajectory export: sampled text dump (Matlab-readable) and npz archives.

Counterpart of the JAX package's ``utils/export.py``:
printMatlabSampledTrajectory (nonlinear_impl.h:2907-3003) writes sampled
[t, pos, vel, acc, jerk, snap] rows to a whitespace-separated text file, in
the same format; batches of trajectories go to npz under the same keys.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._tensors import DeviceLike, resolve_device
from ..models import trajectory as traj_mod
from ..models.trajectory import Trajectory


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sample_trajectory(traj: Trajectory, dt: float,
                      derivatives: Sequence[int] = (0, 1, 2, 3, 4)
                      ) -> np.ndarray:
    """Sampled state matrix: columns [t, x^(d) for d in derivatives...].

    Shape (T, 1 + len(derivatives) * D), on the host.
    """
    times = _numpy(traj.times)
    ts = traj_mod.sample_times(times, dt)
    ts_clamped = torch.as_tensor(np.minimum(ts, times.sum() - 1e-9))
    cols = [ts[:, None]]
    for d in derivatives:
        cols.append(_numpy(traj_mod.evaluate(traj, ts_clamped, d)))
    return np.concatenate(cols, axis=1)


def write_matlab_sampled_trajectory(traj: Trajectory, path: str,
                                    dt: float = 0.05) -> None:
    """Text dump in the reference's format: one row per sample,
    [t, x y z, vx vy vz, ax ay az, jx jy jz, sx sy sz]
    (printMatlabSampledTrajectory, nonlinear_impl.h:2907-3003)."""
    np.savetxt(path, sample_trajectory(traj, dt), fmt="%.12g")


def save_trajectories(path: str, traj: Trajectory, **extra) -> None:
    """npz archive of a (possibly batched) trajectory plus extra arrays."""
    np.savez_compressed(
        path, coefficients=_numpy(traj.coefficients),
        times=_numpy(traj.times),
        **{k: _numpy(v) for k, v in extra.items()})


def load_trajectories(path: str, device: DeviceLike = None) -> Trajectory:
    """The trajectory of ``save_trajectories``'s archive, on ``device``
    (None means the CUDA card)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return Trajectory(
            coefficients=torch.as_tensor(data["coefficients"], device=dev),
            times=torch.as_tensor(data["times"], device=dev))
