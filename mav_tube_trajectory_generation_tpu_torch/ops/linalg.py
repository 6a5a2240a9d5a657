"""Small-block SPD inverse.

The JAX package builds its SPD inverses out of matmuls only
(``spd_inverse_schur``: recursive block-Schur) because a factorization call
was the most expensive operation on the accelerator it was written for.  On
CUDA the plain choice is the library's batched Cholesky, and a library call
is allowed here: none of these inverses sits inside a kernel of the JAX
package.  What is kept from the reference is the conditioning discipline --
Jacobi equilibration before the factorization and a symmetric result -- and
its behaviour on a bad block: the matmul-only inverse never fails, it
returns the inverse of whatever it was given, and the interior-point solvers
lean on that (their float32 endgame Hessians are not positive definite to
working precision on a good share of scenarios; a usable direction still
comes out, and a line search or a step gate judges it).  So the factorization
status is never checked on the host (``cholesky_ex`` / ``inv_ex`` with
``check_errors=False``: no raise, no wait for the device), and a block the
Cholesky factor refuses gets the pivoted-LU inverse of the same equilibrated
block instead.  Only a block with non-finite entries yields a non-finite
inverse, and only for its own scenario.
"""

from __future__ import annotations

import torch

from ..utils import timing


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a (batched) small SPD matrix ``a`` (..., n, n).

    Jacobi-equilibrated Cholesky: with s = diag(a)^-1/2 the scaled matrix
    s a s has unit diagonal, is factored as L L^T, inverted by two triangular
    solves against the identity, and scaled back.  The result is symmetrized
    (exact math is symmetric; roundoff is not, and callers feed the inverse
    into further Schur complements).

    Never raises and never reads the factorization status on the host.  A
    matrix the Cholesky factor refuses (not positive definite to working
    precision) gets its inverse by pivoted LU instead; a matrix with
    non-finite entries gets a non-finite inverse; every other matrix of the
    batch is untouched either way.

    While spans are on (``utils.timing``) it is the span ``spd_inverse``,
    and the counter ``spd_inverse.lu_blocks`` adds the matrices the
    Cholesky factor refused.
    """
    with timing.span("spd_inverse", a.device):
        n = a.shape[-1]
        s = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))      # (..., n)
        a_eq = a * s[..., :, None] * s[..., None, :]
        chol, info = torch.linalg.cholesky_ex(a_eq, check_errors=False)
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
        inv_eq = torch.cholesky_solve(eye, chol)
        inv = inv_eq * s[..., :, None] * s[..., None, :]
        inv = 0.5 * (inv + inv.transpose(-1, -2))
        # fallback for blocks the Cholesky factor refused: LU with pivoting
        inv_lu, _ = torch.linalg.inv_ex(a_eq, check_errors=False)
        inv_lu = inv_lu * s[..., :, None] * s[..., None, :]
        inv_lu = 0.5 * (inv_lu + inv_lu.transpose(-1, -2))
        refused = info != 0
        timing.count("spd_inverse.lu_blocks", refused)
        return torch.where(refused[..., None, None], inv_lu, inv)


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``a x = b`` for a vector (..., n) or matrix (..., n, R)
    right-hand side, through ``spd_inverse`` and a product (the JAX
    package's explicit-inverse solve; its accuracy is that of the inverse
    times b, ample for the equilibrated systems of the solvers)."""
    inv = spd_inverse(a)
    if b.ndim == a.ndim - 1:
        return (inv @ b[..., None])[..., 0]
    return inv @ b
