"""Seeded scenario batches for the headline QP+QCQP configuration.

``make_inputs`` is this package's own copy of the JAX package's benchmark
input generator: the same NumPy ``RandomState(seed)`` draws, the same float32
arrays, so both packages can be run on identical scenarios.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._tensors import DeviceLike, resolve_device
from .models.vertex import segment_times_nfabian
from .solver import linear
from .solver import structure as sm
from .solver.structure import ProblemStructure


class ScenarioBatch(NamedTuple):
    std: ProblemStructure          # interior positions fixed (warm start)
    free: ProblemStructure         # interior vertices free (QCQP)
    d_fixed_std: torch.Tensor      # (B, n_fixed_std, 3)
    d_fixed_free: torch.Tensor     # (B, n_fixed_free, 3)
    times: torch.Tensor            # (B, K)
    waypoints: torch.Tensor        # (B, K+1, 3)
    radii: torch.Tensor            # (B, K, 2)
    values: torch.Tensor           # (B, K+1, 5, 3) vertex values


def make_inputs(k: int, batch: int, seed: int = 0,
                device: DeviceLike = None) -> ScenarioBatch:
    """``batch`` random K-segment, N=10, 3-D scenarios in float32: waypoints
    are cumulative sums of uniform(0.5, 2.0) steps, segment times the Nfabian
    heuristic at v_max 3, a_max 5, corridor radii 0.8, endpoints at rest.

    The random draws and the segment times are made on the host (so a seed
    gives the same scenarios everywhere) and moved to ``device``; ``None``
    means the CUDA card.
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, k + 1, 3)),
                          axis=1).astype(np.float32)
    std = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)
    free = sm.make_structure(sm.free_interior_mask(k + 1, 10), 3, 10)
    values = np.zeros((batch, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    wp_t = torch.from_numpy(waypoints)
    values_t = torch.from_numpy(values)
    times = segment_times_nfabian(wp_t, 3.0, 5.0)
    radii = torch.full((batch, k, 2), 0.8, dtype=torch.float32)
    return ScenarioBatch(
        std, free,
        linear.extract_fixed_values(std, values_t).to(dev),
        linear.extract_fixed_values(free, values_t).to(dev),
        times.to(dev), wp_t.to(dev), radii.to(dev), values_t.to(dev))
