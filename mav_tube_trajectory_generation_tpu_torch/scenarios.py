"""Seeded scenario batches for the headline QP+QCQP configuration and the
tight-corridor strict configuration.

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


def tight_radii(k: int, batch: int, rmin: float = 0.05, rmax: float = 0.3,
                seed: int = 7, device: DeviceLike = None) -> torch.Tensor:
    """(batch, k, 2) corridor radii for the tight-corridor strict
    configuration: one radius per scenario, log-uniform in [rmin, rmax], for
    its tubes and spheres alike (this package's copy of the recipe of the JAX
    package's tight-radius strict benchmark: the same NumPy
    ``RandomState(seed)`` draw).  On such corridors most of a batch fails the
    tier-0 gate, so the escalation tiers and the certificates do the work."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    scale = np.exp(rng.uniform(np.log(rmin), np.log(rmax),
                               size=(batch, 1, 1)))
    radii = np.broadcast_to(scale, (batch, k, 2)).astype(np.float32).copy()
    return torch.from_numpy(radii).to(dev)
