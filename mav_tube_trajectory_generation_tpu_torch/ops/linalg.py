"""Small-block SPD inverse.

The JAX package builds its SPD inverses out of matmuls only
(``spd_inverse_schur``: recursive block-Schur) because a factorization call
was the most expensive operation on the accelerator it was written for.  On
CUDA the plain choice is the library's batched Cholesky, and a library call
is allowed here: none of these inverses sits inside a kernel of the JAX
package.  What is kept from the reference is the conditioning discipline:
Jacobi equilibration before the factorization and a symmetric result.
"""

from __future__ import annotations

import torch


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a (batched) small SPD matrix ``a`` (..., n, n).

    Jacobi-equilibrated Cholesky: with s = diag(a)^-1/2 the scaled matrix
    s a s has unit diagonal, is factored as L L^T, inverted by two triangular
    solves against the identity, and scaled back.  The result is symmetrized
    (exact math is symmetric; roundoff is not, and callers feed the inverse
    into further Schur complements).
    """
    n = a.shape[-1]
    s = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))          # (..., n)
    a_eq = a * s[..., :, None] * s[..., None, :]
    chol = torch.linalg.cholesky(a_eq)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    inv_eq = torch.cholesky_solve(eye, chol)
    inv = inv_eq * s[..., :, None] * s[..., None, :]
    return 0.5 * (inv + inv.transpose(-1, -2))
