"""Monomial-basis polynomial numerics.

Counterpart of the JAX package's ``ops/basis.py``: the falling-factorial
table, one row of the derivative-sampling matrix (both NumPy, float64,
computed once), and on tensors Horner evaluation, derivative coefficients,
the polynomial product (coefficient convolution), zero padding and power
stacks.

Coefficients are stored with increasing powers: c0 + c1 t + ... + c_{N-1}
t^{N-1}, the reference convention (polynomial.h:38-242).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tensors import const


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


def polyval_all(coeffs: torch.Tensor, t, max_derivative: int
                ) -> torch.Tensor:
    """Derivatives 0..max_derivative, stacked on a new leading axis:
    (max_derivative + 1, ...) with ``polyval``'s broadcasting (the vector
    variant of Polynomial::evaluate, polynomial.h:118-132)."""
    return torch.stack([polyval(coeffs, t, d)
                        for d in range(max_derivative + 1)])


def derivative_coefficients(coeffs: torch.Tensor, derivative: int
                            ) -> torch.Tensor:
    """Coefficients of the d-th derivative, zero-padded to length N:
    ``out[j] = coeffs[j + d] * (j + d)!/j!`` for ``j < N - d``
    (Polynomial::getCoefficients, polynomial.h:99-113, in a fixed length)."""
    n = coeffs.shape[-1]
    if derivative == 0:
        return coeffs
    if derivative >= n:
        return torch.zeros_like(coeffs)
    bc = const(("derivative_bc", n, derivative),
               lambda: base_coefficients(n)[derivative, derivative:],
               coeffs.dtype, coeffs.device)
    scaled = coeffs[..., derivative:] * bc
    return torch.nn.functional.pad(scaled, (0, derivative))


def convolve_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full convolution of the trailing axes, length la + lb - 1: the
    batched polynomial product (Polynomial::convolve,
    polynomial.cpp:163-181), summed shift by shift in the order of b."""
    la = a.shape[-1]
    lb = b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(batch + (la + lb - 1,),
                      dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    for k in range(lb):
        out[..., k:k + la] += a * b[..., k:k + 1]
    return out


def pad_coefficients(coeffs: torch.Tensor, new_n: int) -> torch.Tensor:
    """The same polynomial with ``new_n`` coefficients, zero-padded
    (Polynomial::getPolynomialWithAppendedCoefficients,
    polynomial.cpp:183-198); unchanged if it already has >= new_n."""
    n = coeffs.shape[-1]
    if new_n <= n:
        return coeffs
    return torch.nn.functional.pad(coeffs, (0, new_n - n))


def powers(t: torch.Tensor, n: int) -> torch.Tensor:
    """[1, t, t^2, ..., t^(n-1)] stacked on a trailing axis."""
    pows = [torch.ones_like(t)]
    for _ in range(n - 1):
        pows.append(pows[-1] * t)
    return torch.stack(pows, dim=-1)
