"""Monomial-basis polynomial numerics.

Counterpart of the JAX package's ``ops/basis.py`` for what the QP+QCQP path
needs: the falling-factorial table, one row of the derivative-sampling
matrix (both NumPy, float64, computed once), and Horner evaluation / power
stacks on tensors.

Coefficients are stored with increasing powers: c0 + c1 t + ... + c_{N-1}
t^{N-1}, the reference convention (polynomial.h:38-242).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def base_coefficients(n: int) -> np.ndarray:
    """Falling-factorial derivative table, shape (n, n), float64.

    ``bc[d, j] = j! / (j - d)!`` for ``j >= d`` and 0 otherwise; row 0 is all
    ones (computeBaseCoefficients, polynomial.cpp:145-161).
    """
    bc = np.zeros((n, n), dtype=np.float64)
    bc[0] = 1.0
    for d in range(1, n):
        for j in range(d, n):
            bc[d, j] = (j - d + 1) * bc[d - 1, j]
    bc.setflags(write=False)
    return bc


def base_coeffs_with_time(n: int, derivative: int, t: float) -> np.ndarray:
    """Row of the mapping matrix A: d-th derivative sampled at time t
    (NumPy; polynomial.h:201-228)."""
    bc = base_coefficients(n)
    out = np.zeros(n, dtype=np.float64)
    out[derivative] = bc[derivative, derivative]
    if abs(t) < np.finfo(np.float64).eps:
        return out
    t_power = t
    for j in range(derivative + 1, n):
        out[j] = bc[derivative, j] * t_power
        t_power *= t
    return out


def polyval(coeffs: torch.Tensor, t, derivative: int) -> torch.Tensor:
    """Evaluate the ``derivative``-th derivative of polynomial(s) at ``t``.

    Args:
      coeffs: (..., N) increasing-power coefficients.
      t: scalar or tensor broadcastable against ``coeffs[..., 0]``.
      derivative: non-negative derivative order.

    Horner scheme as in Polynomial::evaluate (polynomial.h:136-149).
    """
    n = coeffs.shape[-1]
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    if derivative >= n:
        shape = torch.broadcast_shapes(coeffs.shape[:-1], t.shape)
        return torch.zeros(shape, dtype=coeffs.dtype, device=coeffs.device)
    bc = base_coefficients(n)[derivative]
    acc = coeffs[..., n - 1] * float(bc[n - 1])
    for j in range(n - 2, derivative - 1, -1):
        acc = acc * t + coeffs[..., j] * float(bc[j])
    return acc


def powers(t: torch.Tensor, n: int) -> torch.Tensor:
    """[1, t, t^2, ..., t^(n-1)] stacked on a trailing axis."""
    pows = [torch.ones_like(t)]
    for _ in range(n - 1):
        pows.append(pows[-1] * t)
    return torch.stack(pows, dim=-1)
