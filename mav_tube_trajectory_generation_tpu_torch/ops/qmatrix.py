"""Cost (Q), mapping (A) and unconstrained-Hessian (H) matrices.

Counterpart of the JAX package's ``ops/qmatrix.py``.  Every per-segment
matrix factors exactly into a *constant unit-time matrix* and *diagonal
powers of the segment time T*:

    A(T)   = diag(T^-i_r) @ Ahat   @ diag(T^j)         (rows r sample deriv i_r)
    Q(T)   = T^(1-2d) diag(T^j) @ Qhat_d @ diag(T^j)
    H(T)   = T^(1-2d) diag(T^i_r) @ Hhat_d @ diag(T^i_r)

with ``i_r = (0..N/2-1, 0..N/2-1)`` the derivative order sampled by row r and
``Hhat_d = Ahat^{-T} Qhat_d Ahat^{-1}`` a constant.  The constants are NumPy
float64, computed once; the batched functions cast them to the working dtype
of ``times`` (never the other way round) and scale them elementwise.

Reference: linear_impl.h:101-169 (A and its Schur inverse), :557-573 (Q),
:306-335 (H inside constructR).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tensors import const
from .basis import base_coefficients, base_coeffs_with_time


@functools.lru_cache(maxsize=None)
def row_derivative_orders(n: int) -> np.ndarray:
    """Derivative order sampled by each row of A: (0..N/2-1, 0..N/2-1)."""
    h = n // 2
    out = np.concatenate([np.arange(h), np.arange(h)]).astype(np.float64)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def mapping_matrix_unit(n: int) -> np.ndarray:
    """Ahat = A(T=1): rows = derivs 0..N/2-1 at t=0, then at t=1."""
    h = n // 2
    a = np.zeros((n, n), dtype=np.float64)
    for i in range(h):
        a[i] = base_coeffs_with_time(n, i, 0.0)
        a[i + h] = base_coeffs_with_time(n, i, 1.0)
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def inv_mapping_matrix_unit(n: int) -> np.ndarray:
    """Ahat^{-1} via the reference's Schur-complement structure.

    A(1) = [diag(d)  0; C  D]  =>  A^{-1} = [diag(1/d) 0; -D^{-1} C diag(1/d), D^{-1}]
    (invertMappingMatrix, linear_impl.h:132-169).
    """
    h = n // 2
    a = mapping_matrix_unit(n)
    a_diag_inv = np.diag(1.0 / np.diag(a[:h, :h]))
    c = a[h:, :h]
    d_inv = np.linalg.inv(a[h:, h:])
    inv = np.zeros((n, n), dtype=np.float64)
    inv[:h, :h] = a_diag_inv
    inv[h:, :h] = -d_inv @ c @ a_diag_inv
    inv[h:, h:] = d_inv
    inv.setflags(write=False)
    return inv


@functools.lru_cache(maxsize=None)
def quadratic_cost_unit(n: int, derivative: int) -> np.ndarray:
    """Qhat_d = Q(derivative, T=1): integral Jacobian of squared derivative.

    Qhat[r, c] = bc[d, r] bc[d, c] * 2 / (r + c + 1 - 2d) for r, c >= d
    (computeQuadraticCostJacobian, linear_impl.h:557-573, at T = 1).
    """
    bc = base_coefficients(n)
    q = np.zeros((n, n), dtype=np.float64)
    for r in range(derivative, n):
        for c in range(derivative, n):
            e = r + c + 1 - 2 * derivative
            q[r, c] = bc[derivative, r] * bc[derivative, c] * 2.0 / e
    q.setflags(write=False)
    return q


def quadratic_cost(n: int, derivative: int, t) -> torch.Tensor:
    """Q(derivative, T) for (batched) segment times ``t``: (..., N, N),
    ``T^(1-2d) diag(T^j) Qhat_d diag(T^j)``."""
    t = torch.as_tensor(t)
    qhat = const(("qhat", n, derivative),
                 lambda: quadratic_cost_unit(n, derivative), t.dtype,
                 t.device)
    jpow = t[..., None] ** _jord(n, t)                    # (..., N)
    scale = t ** (1 - 2 * derivative)
    return (scale[..., None, None] * jpow[..., :, None] * jpow[..., None, :]
            * qhat)


@functools.lru_cache(maxsize=None)
def hessian_unit(n: int, derivative: int) -> np.ndarray:
    """Hhat_d = Ahat^{-T} Qhat_d Ahat^{-1} (constant, float64)."""
    ainv = inv_mapping_matrix_unit(n)
    h = ainv.T @ quadratic_cost_unit(n, derivative) @ ainv
    # Symmetrize: exact math is symmetric; float64 roundoff is not.
    h = 0.5 * (h + h.T)
    h.setflags(write=False)
    return h


def _iord(n: int, like: torch.Tensor) -> torch.Tensor:
    return const(("row_orders", n), lambda: row_derivative_orders(n),
                 like.dtype, like.device)


def _jord(n: int, like: torch.Tensor) -> torch.Tensor:
    return const(("col_orders", n), lambda: np.arange(n, dtype=np.float64),
                 like.dtype, like.device)


def hessian_blocks(times: torch.Tensor, n: int, derivative: int
                   ) -> torch.Tensor:
    """H(T_k) = A^{-T} Q A^{-1} for every segment, shape (..., K, N, N):
    H[r, c] = Hhat[r, c] * T^(1 - 2d + i_r + i_c), no matrix product."""
    hhat = const(("hessian_unit", n, derivative),
                 lambda: hessian_unit(n, derivative),
                 times.dtype, times.device)
    tpow = times[..., None] ** _iord(n, times)                    # (..., K, N)
    scale = times ** (1 - 2 * derivative)
    return (scale[..., None, None] * tpow[..., :, None] * tpow[..., None, :]
            * hhat)


def mapping_matrix(times: torch.Tensor, n: int) -> torch.Tensor:
    """A(T_k) for (batched) times: (..., N, N).  For tests/diagnostics."""
    ahat = const(("mapping_unit", n), lambda: mapping_matrix_unit(n),
                 times.dtype, times.device)
    jpow = times[..., None] ** _jord(n, times)
    ipow = times[..., None] ** _iord(n, times)
    return ahat * jpow[..., None, :] / ipow[..., :, None]


def inv_mapping_matrix(times: torch.Tensor, n: int) -> torch.Tensor:
    """A(T_k)^{-1} for (batched) times: (..., N, N).  For tests/diagnostics."""
    ainv_hat = const(("inv_mapping_unit", n),
                     lambda: inv_mapping_matrix_unit(n),
                     times.dtype, times.device)
    jpow = times[..., None] ** _jord(n, times)
    ipow = times[..., None] ** _iord(n, times)
    return ainv_hat * ipow[..., None, :] / jpow[..., :, None]


def coefficients_from_endpoint_derivatives(d_seg: torch.Tensor,
                                           times: torch.Tensor
                                           ) -> torch.Tensor:
    """p = A(T)^{-1} d per segment, without materializing A^{-1}.

    Args:
      d_seg: (..., K, N, D) endpoint derivatives per segment (start derivs
        0..N/2-1, then end derivs 0..N/2-1).
      times: (..., K) segment times.

    Returns (..., K, N, D) monomial coefficients in real time, using
    A^{-1}(T) = diag(T^-j) Ahat^{-1} diag(T^i_r).
    """
    n = d_seg.shape[-2]
    ainv_hat = const(("inv_mapping_unit", n),
                     lambda: inv_mapping_matrix_unit(n),
                     d_seg.dtype, d_seg.device)
    ipow = times[..., None] ** _iord(n, times)                    # (..., K, N)
    jpow = times[..., None] ** _jord(n, times)                    # (..., K, N)
    scaled = d_seg * ipow[..., :, None]
    coeffs = torch.einsum('ij,...jd->...id', ainv_hat, scaled)
    return coeffs / jpow[..., :, None]


def endpoint_derivatives_from_coefficients(coeffs: torch.Tensor,
                                           times: torch.Tensor
                                           ) -> torch.Tensor:
    """d = A(T) p per segment: inverse of the above."""
    n = coeffs.shape[-2]
    ahat = const(("mapping_unit", n), lambda: mapping_matrix_unit(n),
                 coeffs.dtype, coeffs.device)
    ipow = times[..., None] ** _iord(n, times)
    jpow = times[..., None] ** _jord(n, times)
    scaled = coeffs * jpow[..., :, None]
    d = torch.einsum('ij,...jd->...id', ahat, scaled)
    return d / ipow[..., :, None]
