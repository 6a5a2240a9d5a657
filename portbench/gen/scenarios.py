"""The benchmark's scenario generator, frozen.

A copy of the program's ``scenarios.make_inputs`` recipe (which is itself
the JAX package's benchmark generator): NumPy ``RandomState`` draws, float32
arrays.  Waypoints are cumulative sums of uniform(step_lo, step_hi) steps
per axis, the start and goal at rest, segment times by the Nfabian heuristic
t = 2 d / v (1 + 6.5 v / a e^(-2 d / v)), corridor radii from the traffic
file.  ``make_batch(k, batch, seed)`` with the defaults gives the bits of
``make_inputs(k, batch, seed)`` (held so by a test).

The sizes and the segment times' heuristic are the configuration's
(``portbench/configs/<config>.json``: ``n_segments``, ``n_coefficients``,
``segment_times`` {``v_max``, ``a_max``, ``magic``}); the mix is the traffic
file's (``portbench/traffic/<traffic>.json``: ``batch``, ``pool``,
``step_lo``, ``step_hi`` and ``radii``, either
``{"kind": "constant", "value": r}`` or
``{"kind": "log_uniform", "lo": a, "hi": b}`` (one radius a scenario, for
its tubes and spheres alike, as the program's ``tight_radii``)).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def nfabian_times(waypoints: np.ndarray, v_max: float, a_max: float,
                  magic: float = 6.5) -> torch.Tensor:
    """(B, K) float32 segment times, in the program's order of operations."""
    wp = torch.from_numpy(waypoints)
    d = torch.linalg.vector_norm(torch.diff(wp, dim=-2), dim=-1)
    return d / v_max * 2.0 * (1.0 + magic * v_max / a_max
                              * torch.exp(-d / v_max * 2.0))


def make_batch(k: int, batch: int, seed: int, n_coefficients: int = 10,
               step_lo: float = 0.5, step_hi: float = 2.0,
               v_max: float = 3.0, a_max: float = 5.0, magic: float = 6.5,
               radii=None, radii_seed: int = 7) -> Dict[str, torch.Tensor]:
    """One batch on the host: waypoints (B, K+1, 3), times (B, K), radii
    (B, K, 2), values (B, K+1, N/2, 3) (positions at the waypoints, every
    other derivative 0) and d_fixed (B, N, 3) (the start's derivatives
    0..N/2-1, then the goal's), all float32."""
    h = n_coefficients // 2
    rng = np.random.RandomState(seed)
    waypoints = np.cumsum(rng.uniform(step_lo, step_hi, size=(batch, k + 1, 3)),
                          axis=1).astype(np.float32)
    values = np.zeros((batch, k + 1, h, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    radii = radii or {"kind": "constant", "value": 0.8}
    if radii["kind"] == "constant":
        r = torch.full((batch, k, 2), float(radii["value"]),
                       dtype=torch.float32)
    elif radii["kind"] == "log_uniform":
        rr = np.random.RandomState(radii_seed)
        scale = np.exp(rr.uniform(np.log(radii["lo"]), np.log(radii["hi"]),
                                  size=(batch, 1, 1)))
        r = torch.from_numpy(np.broadcast_to(scale, (batch, k, 2))
                             .astype(np.float32).copy())
    else:
        raise ValueError(f"unknown radii kind {radii['kind']!r}")
    values_t = torch.from_numpy(values)
    d_fixed = torch.cat([values_t[:, 0], values_t[:, -1]], dim=1)
    return dict(waypoints=torch.from_numpy(waypoints),
                times=nfabian_times(waypoints, v_max, a_max, magic), radii=r,
                values=values_t, d_fixed=d_fixed)


def batch_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 32-bit RandomState seed for batch ``index`` of a run's pool, from
    the run's seed (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), index, stream])
               .generate_state(1)[0])


def make_pool(config: Dict, traffic: Dict, seed: int
              ) -> List[Dict[str, torch.Tensor]]:
    """The run's ``traffic["pool"]`` distinct batches, each of
    ``traffic["batch"]`` scenarios of the configuration's sizes, on the
    host."""
    st = config["segment_times"]
    return [make_batch(int(config["n_segments"]), int(traffic["batch"]),
                       batch_seed(seed, i),
                       n_coefficients=int(config["n_coefficients"]),
                       step_lo=float(traffic["step_lo"]),
                       step_hi=float(traffic["step_hi"]),
                       v_max=float(st["v_max"]), a_max=float(st["a_max"]),
                       magic=float(st["magic"]), radii=traffic["radii"],
                       radii_seed=batch_seed(seed, i, 1))
            for i in range(int(traffic["pool"]))]
