"""Small-block SPD inverse.

The JAX package builds its SPD inverses out of matmuls only
(``spd_inverse_schur``: recursive block-Schur) because a factorization call
was the most expensive operation on the accelerator it was written for.  What
the port keeps from it is the conditioning discipline -- Jacobi equilibration
before the factorization and a symmetric result -- and its behaviour on a bad
block: the matmul-only inverse never fails, it returns the inverse of whatever
it was given, and the interior-point solvers lean on that (their float32
endgame Hessians are not positive definite to working precision on a good
share of scenarios; a usable direction still comes out, and a line search or
a step gate judges it).  So a block the Cholesky factor refuses gets the
pivoted inverse of the same equilibrated block instead, nothing raises, and
only a block with non-finite entries yields a non-finite inverse, for its own
scenario only.

The route is chosen by shape.  A CUDA tensor of n <= ``KERNEL_MAX_N`` goes
through one launch of ``csrc/spd_inverse.cu`` (``spd_inverse_cuda``): one
warp a matrix, the Cholesky inverse and, for the matrices it refuses, the
partially pivoted Gauss-Jordan inverse in the same launch, a refusal flag a
matrix written on the device; nothing waits for the device.  It computes
in float64 for either type and rounds once (the source's note says why:
the block-LDL^T sweep's callers feel each inverse's rounding).  Every other
tensor -- the CPU's, and larger CUDA blocks such as the dense n = 135
inverses -- takes the plain library version (``_spd_inverse_library``):
``cholesky_ex``, ``cholesky_solve`` against the identity, and the pivoted-LU
``inv_ex`` of every block, kept where the Cholesky factor refused.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..utils import timing

#: The largest n the kernel takes (``kSpdMaxN`` in its source).
KERNEL_MAX_N = 64

#: Launches of the kernel in this process.
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _lib
    lib = _build.load("spd_inverse")
    if lib is not _lib:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.spd_inverse_launch.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.spd_inverse_launch.restype = i32
        _lib = lib
    return lib


def _scaled_symmetric(inv_eq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    inv = inv_eq * s[..., :, None] * s[..., None, :]
    return 0.5 * (inv + inv.transpose(-1, -2))


def _spd_inverse_library(a: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, by library calls: (inverse, refused), refused a
    bool (...) of the matrices the Cholesky factor refused, which take the
    pivoted-LU inverse of the same equilibrated matrix."""
    n = a.shape[-1]
    s = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))      # (..., n)
    a_eq = a * s[..., :, None] * s[..., None, :]
    chol, info = torch.linalg.cholesky_ex(a_eq, check_errors=False)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    inv = _scaled_symmetric(torch.cholesky_solve(eye, chol), s)
    inv_lu, _ = torch.linalg.inv_ex(a_eq, check_errors=False)
    inv_lu = _scaled_symmetric(inv_lu, s)
    refused = info != 0
    return torch.where(refused[..., None, None], inv_lu, inv), refused


def spd_inverse_cuda(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``spd_inverse``'s function in one launch of ``csrc/spd_inverse.cu``:
    (inverse, refused), refused an int32 (...) tensor, 1 where the Cholesky
    factor failed and the pivoted Gauss-Jordan inverse was taken.

    a: (..., n, n) on a CUDA device, float32 or float64, contiguous,
    1 <= n <= ``KERNEL_MAX_N``; anything else raises.  Launches on the
    current stream and does not synchronise.
    """
    if a.device.type != "cuda":
        raise ValueError(f"spd_inverse_cuda: on {a.device}, expected a CUDA "
                         f"device")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spd_inverse_cuda: the CUDA kernel takes float32 "
                        f"or float64, got {a.dtype}")
    n = a.shape[-1] if a.dim() >= 2 else 0
    if a.dim() < 2 or a.shape[-2] != n or not 1 <= n <= KERNEL_MAX_N:
        raise ValueError(f"spd_inverse_cuda: expected (..., n, n) with "
                         f"1 <= n <= {KERNEL_MAX_N}, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("spd_inverse_cuda: a must be contiguous")
    out = torch.empty_like(a)
    refused = torch.empty(a.shape[:-2], dtype=torch.int32, device=a.device)
    batch = refused.numel()
    if batch == 0:
        return out, refused
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.spd_inverse_launch(
            a.data_ptr(), out.data_ptr(), refused.data_ptr(), batch, n,
            a.element_size(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spd_inverse kernel launch failed with CUDA "
                           f"error {err} (batch={batch}, n={n}, "
                           f"dtype={a.dtype})")
    global launches
    launches += 1
    return out, refused


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a (batched) small SPD matrix ``a`` (..., n, n).

    Jacobi-equilibrated Cholesky: with s = diag(a)^-1/2 the scaled matrix
    s a s has unit diagonal, is factored as L L^T and inverted, and the
    inverse is scaled back.  The result is symmetrized (exact math is
    symmetric; roundoff is not, and callers feed the inverse into further
    Schur complements).

    Never raises for a bad matrix and never reads a factorization status on
    the host.  A matrix the Cholesky factor refuses (not positive definite
    to working precision) gets the pivoted inverse of the same equilibrated
    matrix instead; a matrix with non-finite entries gets a non-finite
    inverse; every other matrix of the batch is untouched either way.  The
    route goes by shape (module docstring): CUDA tensors of n <=
    ``KERNEL_MAX_N`` take the kernel (float32 or float64, else TypeError),
    all else the library version.

    While spans are on (``utils.timing``) it is the span ``spd_inverse``;
    the counter ``spd_inverse.lu_blocks`` adds the matrices the Cholesky
    factor refused (from the flags on the device, read with the log) and
    ``spd_inverse.kernel_blocks`` the matrices the kernel inverted (0 on
    the library route).
    """
    with timing.span("spd_inverse", a.device):
        if a.device.type == "cuda" and a.shape[-1] <= KERNEL_MAX_N:
            inv, refused = spd_inverse_cuda(a.contiguous())
            kernel_blocks = refused.numel()
        else:
            inv, refused = _spd_inverse_library(a)
            kernel_blocks = 0
        timing.count("spd_inverse.lu_blocks", refused)
        timing.count("spd_inverse.kernel_blocks", kernel_blocks)
        return inv


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``a x = b`` for a vector (..., n) or matrix (..., n, R)
    right-hand side, through ``spd_inverse`` and a product (the JAX
    package's explicit-inverse solve; its accuracy is that of the inverse
    times b, ample for the equilibrated systems of the solvers)."""
    inv = spd_inverse(a)
    if b.ndim == a.ndim - 1:
        return (inv @ b[..., None])[..., 0]
    return inv @ b
