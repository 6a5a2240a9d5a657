"""Dense Euclidean signed-distance field for collision costs.

Counterpart of the JAX package's ``models/esdf.py``.  The reference queries
a supereight octree (findOccupiedVoxels / getDistanceOctree,
nonlinear_impl.h:1920-2043); here an occupancy grid becomes, once, an exact
Euclidean distance transform, and queries are batched trilinear
interpolation (eight gathers and lerps), differentiable for the collision
gradient (the reference's central differences,
getCostAndGradientPotentialOctree, nonlinear_impl.h:1782-1917).

Two exact transforms: "xla" (the JAX package's name, kept so that callers
port unchanged) is the separable min-plus reduction D[i] = min_j (A[j] +
(i-j)^2) per axis on the tensors' device, O(n^2) per axis through an
(..., n, n) broadcast; "native" is the host C++ Felzenszwalb transform of
``csrc/edt.cpp`` (``native.py``), O(n) per axis, for big maps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native
from .._tensors import DeviceLike, as_tensor, resolve_device

METHODS = ("auto", "xla", "native")
#: "auto" sends a 3-D grid of more voxels than this to the host transform.
NATIVE_ABOVE = 64 ** 3


class Esdf(NamedTuple):
    """Distance field: distance[i,j,k] = distance (meters) from the center of
    voxel (i,j,k) to the nearest occupied voxel; ``method`` names the
    transform that made it ("xla" or "native"; None when built some other
    way)."""
    distance: torch.Tensor       # (X, Y, Z) float
    origin: torch.Tensor         # (3,) world position of voxel (0,0,0) center
    resolution: torch.Tensor     # () voxel edge length
    method: Optional[str] = None


def _minplus_1d(sq: torch.Tensor, axis: int) -> torch.Tensor:
    """D[i] = min_j (sq[j] + (i - j)^2) along ``axis`` (voxel units)."""
    n = sq.shape[axis]
    sq = torch.movedim(sq, axis, -1)
    i = torch.arange(n, device=sq.device)
    pairwise = (i[:, None] - i[None, :]).to(sq.dtype) ** 2        # (n, n)
    out = torch.amin(sq[..., None, :] + pairwise, dim=-1)
    return torch.movedim(out, -1, axis)


def _occupancy_numpy(occupancy) -> np.ndarray:
    if isinstance(occupancy, torch.Tensor):
        return occupancy.detach().cpu().numpy().astype(bool)
    return np.asarray(occupancy, bool)


def esdf_from_occupancy(occupancy, origin, resolution: float,
                        dtype: torch.dtype = torch.float32,
                        signed: bool = True, method: str = "auto",
                        device: DeviceLike = None) -> Esdf:
    """Exact (signed) EDT of an occupancy grid (True/1 = occupied).

    For free voxels: the distance to the nearest occupied voxel center (the
    reference's getDistanceOctree semantics, nonlinear_impl.h:2031-2043).
    With ``signed=True``, occupied voxels get minus the distance to the
    nearest free voxel, so the collision potential keeps a gradient inside
    an obstacle.  An all-free map gets a large finite distance everywhere.

    ``method``: "xla" the min-plus reduction on ``device``; "native" the
    host C++ transform (raises when it cannot be built), its float32 field
    then moved to ``device``; "auto" takes "native" for a 3-D grid of more
    than 64^3 voxels when the library builds, else "xla".  The result's
    ``method`` says which one ran.  ``device``: None means the CUDA card.
    """
    if method not in METHODS:
        raise ValueError(f"method must be 'auto', 'xla' or 'native', "
                         f"got {method!r}")
    dev = resolve_device(device)
    if method == "auto":
        shape = tuple(occupancy.shape)
        big_grid = len(shape) == 3 and int(np.prod(shape)) > NATIVE_ABOVE
        method = ("native" if big_grid and native.edt_available()
                  else "xla")
    origin_t = as_tensor(origin, dtype, dev)
    res_t = torch.as_tensor(resolution, dtype=dtype, device=dev)

    if method == "native":
        occ_np = _occupancy_numpy(occupancy)
        big = float(sum(s ** 2 for s in occ_np.shape) + 1)
        sq = np.nan_to_num(native.edt_squared_cpp(occ_np), posinf=big)
        dist = np.sqrt(sq, dtype=np.float32)
        if signed:
            sq_in = np.nan_to_num(native.edt_squared_cpp(~occ_np),
                                  posinf=big)
            dist = dist - np.sqrt(sq_in, dtype=np.float32)
        dist = torch.as_tensor(dist * np.float32(resolution)).to(
            device=dev, dtype=dtype)
        return Esdf(dist, origin_t, res_t, "native")

    occ = as_tensor(occupancy, torch.bool, dev)
    big = torch.tensor(float(sum(s ** 2 for s in occ.shape) + 1),
                       dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def edt_sq(mask):
        sq = torch.where(mask, zero, big)
        for axis in range(occ.ndim):
            sq = _minplus_1d(sq, axis)
        return sq

    dist = torch.sqrt(edt_sq(occ))
    if signed:
        dist = dist - torch.sqrt(edt_sq(~occ))
    return Esdf(dist * res_t, origin_t, res_t, "xla")


def distance_at(esdf: Esdf, positions: torch.Tensor) -> torch.Tensor:
    """Trilinear-interpolated distance at world positions (..., 3).

    Out-of-map queries clamp to the border (at s - 1 - 1e-6 voxels; the
    reference instead treats out-of-map as collision,
    nonlinear_impl.h:1810-1840).  The gradient flows through the fractional
    offsets, not the floored voxel index, as in the JAX package."""
    dist = esdf.distance
    grid = (positions - esdf.origin) / esdf.resolution
    shape = dist.shape
    hi = torch.tensor([s - 1 - 1e-6 for s in shape], dtype=grid.dtype,
                      device=grid.device)
    grid = torch.minimum(torch.maximum(grid, torch.zeros_like(hi)), hi)
    lo = torch.floor(grid).detach()
    frac = grid - lo
    lo = lo.long()
    flat = dist.reshape(-1)
    last = [s - 1 for s in shape]

    def gather(ox, oy, oz):
        ix = torch.clamp(lo[..., 0] + ox, max=last[0])
        iy = torch.clamp(lo[..., 1] + oy, max=last[1])
        iz = torch.clamp(lo[..., 2] + oz, max=last[2])
        return flat[(ix * shape[1] + iy) * shape[2] + iz]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c000 = gather(0, 0, 0); c100 = gather(1, 0, 0)
    c010 = gather(0, 1, 0); c110 = gather(1, 1, 0)
    c001 = gather(0, 0, 1); c101 = gather(1, 0, 1)
    c011 = gather(0, 1, 1); c111 = gather(1, 1, 1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def collision_potential(distance: torch.Tensor, epsilon: float,
                        robot_radius: float,
                        multiplier: float = 1.0) -> torch.Tensor:
    """Hinge/quadratic potential c(d) (getCostPotential, impl:2659-2684):

        d' = d - robot_radius
        c  = multiplier * (-d') + eps/2          if d' <= 0   (in collision)
        c  = (d' - eps)^2 / (2 eps)              if 0 < d' <= eps
        c  = 0                                   otherwise
    """
    d = distance - robot_radius
    in_collision = d <= 0.0
    near = d <= epsilon
    c_coll = multiplier * (-d) + 0.5 * epsilon
    c_near = 0.5 / epsilon * (d - epsilon) ** 2
    return torch.where(in_collision, c_coll,
                       torch.where(near, c_near, torch.zeros_like(c_near)))


def is_in_collision(distance: torch.Tensor, robot_radius: float
                    ) -> torch.Tensor:
    return distance - robot_radius <= 0.0


def make_obstacle_grid(shape, origin, resolution, boxes=(), spheres=(),
                       dtype=np.float32) -> np.ndarray:
    """Host helper: rasterize axis-aligned boxes ((min_xyz, max_xyz)) and
    spheres ((center, radius)) into a boolean occupancy grid."""
    shape = tuple(shape)
    origin = np.asarray(origin, dtype=np.float64)
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                               indexing="ij"), axis=-1)
    centers = origin + idx * resolution
    occ = np.zeros(shape, dtype=bool)
    for (mn, mx) in boxes:
        mn = np.asarray(mn); mx = np.asarray(mx)
        occ |= np.all((centers >= mn) & (centers <= mx), axis=-1)
    for (c, r) in spheres:
        occ |= np.linalg.norm(centers - np.asarray(c), axis=-1) <= r
    return occ
