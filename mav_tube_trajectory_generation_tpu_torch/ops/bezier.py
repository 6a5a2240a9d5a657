"""Bezier control-point mapping for corridor (tube) constraints.

Counterpart of the JAX package's ``ops/bezier.py``.  A degree-(N-1) segment
on [0, T] is a Bezier curve with N control points; confining the control
points to a convex region confines the curve.  The map from endpoint
derivatives to control points factors as

    B^{-1}(T) = Bhat^{-1} @ diag(T^(0..H-1, 0..H-1)),

with ``Bhat^{-1}`` a NumPy float64 constant (qcqp_impl.h:268-319 at T = 1).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._tensors import const
from .qmatrix import row_derivative_orders


@functools.lru_cache(maxsize=None)
def bezier_derivative_matrix_unit(n: int) -> np.ndarray:
    """Bhat_ul: (N/2, N/2) map from first N/2 control points to derivatives
    0..N/2-1 at t=0, at unit time.  Bhat_ul[l, j] = n!/(n-l)! (-1)^(l+j) C(l,j)
    for j <= l (qcqp_impl.h:284-297 at T=1)."""
    h = n // 2
    deg = n - 1
    b = np.zeros((h, h), dtype=np.float64)
    b[0, 0] = 1.0
    for l in range(1, h):
        for j in range(l + 1):
            b[l, j] = (math.factorial(deg) / math.factorial(deg - l)
                       * (-1.0) ** (l + j) * math.comb(l, j))
    b.setflags(write=False)
    return b


@functools.lru_cache(maxsize=None)
def inv_control_point_mapping_unit(n: int) -> np.ndarray:
    """Bhat^{-1}: (N, N) block-diagonal map [start derivs; end derivs] ->
    [first N/2 control points; last N/2 control points] at unit time.

    Lower-right block = row-reversed upper-left inverse with alternating
    column signs (qcqp_impl.h:309-318).
    """
    h = n // 2
    b_ul_inv = np.linalg.inv(bezier_derivative_matrix_unit(n))
    alt = np.diag([(-1.0) ** i for i in range(h)])
    b_lr_inv = b_ul_inv[::-1, :] @ alt
    out = np.zeros((n, n), dtype=np.float64)
    out[:h, :h] = b_ul_inv
    out[h:, h:] = b_lr_inv
    out.setflags(write=False)
    return out


def control_points_from_endpoint_derivatives(d_seg: torch.Tensor,
                                             times: torch.Tensor
                                             ) -> torch.Tensor:
    """Control points cp = B^{-1}(T) d per segment.

    Args:
      d_seg: (..., K, N, D) endpoint derivatives (start 0..N/2-1, end
        0..N/2-1) in real time.
      times: (..., K).

    Returns (..., K, N, D) control points (cp[0] = start position,
    cp[N-1] = end position).
    """
    n = d_seg.shape[-2]
    binv = const(("inv_cp_unit", n),
                 lambda: inv_control_point_mapping_unit(n),
                 d_seg.dtype, d_seg.device)
    iord = const(("row_orders", n), lambda: row_derivative_orders(n),
                 times.dtype, times.device)
    ipow = times[..., None] ** iord                      # (..., K, N)
    scaled = d_seg * ipow[..., :, None]
    return torch.einsum('ij,...jd->...id', binv, scaled)


def bernstein_basis(n_points: int, tau: np.ndarray) -> np.ndarray:
    """Bernstein basis values (len(tau), n_points) at normalised times tau
    (NumPy, the host; a test oracle): x(T tau) = sum_j cp_j B_j(tau)."""
    deg = n_points - 1
    tau = np.asarray(tau, dtype=np.float64)[:, None]
    j = np.arange(n_points)[None, :]
    comb = np.array([math.comb(deg, jj) for jj in range(n_points)])[None, :]
    return comb * tau ** j * (1.0 - tau) ** (deg - j)
