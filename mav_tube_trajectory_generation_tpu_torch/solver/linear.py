"""Batched closed-form min-derivative QP solver.

Counterpart of the JAX package's ``solver/linear.py`` (Richter/Bry/Roy closed
form, polynomial_optimization_linear.h + impl): the per-segment Hessians are
an elementwise power scaling of a constant (ops.qmatrix), R = M^T H M is a
static one-hot contraction over the gather map (solver.structure), and the
free derivatives come from one Jacobi-equilibrated Cholesky of the SPD R_pp.

Every function is a plain function of tensors: leading batch dimensions are
written out as ``...`` and broadcast between ``d_fixed`` and ``times``.
Matrix products run in full float32 (the package switches TF32 off on
import): the assembly spans ~T^(1-2d) of dynamic range and lower matmul
precision broke feasibility in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._tensors import const
from ..ops import qmatrix
from .structure import ProblemStructure


class LinearSolution(NamedTuple):
    """Result of one (or a batch of) linear solves.

    Attributes:
      coefficients: (..., K, N, D) real-time monomial coefficients.
      times: (..., K) segment times (passed through).
      d_fixed: (..., n_fixed, D) fixed endpoint derivatives.
      d_free: (..., n_free, D) optimized free endpoint derivatives.
      cost: (...,) 0.5 * sum_k sum_d c^T Q c  (computeCost, impl:113-130).
    """
    coefficients: torch.Tensor
    times: torch.Tensor
    d_fixed: torch.Tensor
    d_free: torch.Tensor
    cost: torch.Tensor


def assemble_r(structure: ProblemStructure, times: torch.Tensor
               ) -> torch.Tensor:
    """R = M^T blockdiag(H_k) M, dense (..., n_total, n_total).

    Replaces constructR (linear_impl.h:306-335): the one-hot M is a cached
    constant and the contraction is two small batched products.
    """
    n = structure.n_coefficients
    h_blocks = qmatrix.hessian_blocks(times, n,
                                      structure.derivative_to_optimize)
    m_hot = const((structure, "one_hot_m"), structure.one_hot_m,
                  h_blocks.dtype, h_blocks.device)
    # (K,N,nt),(...,K,N,N),(K,N,nt) -> (...,nt,nt)
    hm = torch.einsum('...krc,kcb->...krb', h_blocks, m_hot)
    return torch.einsum('kra,...krb->...ab', m_hot, hm)


def segment_derivatives(structure: ProblemStructure, d_fixed: torch.Tensor,
                        d_free: torch.Tensor) -> torch.Tensor:
    """Gather [d_f; d_p] into per-segment endpoint derivatives
    (..., K, N, D)."""
    d_all = torch.cat([d_fixed, d_free], dim=-2)
    idx = const((structure, "gather_idx"), lambda: structure.gather_idx,
                torch.long, d_all.device)                          # (K, N)
    out = torch.index_select(d_all, -2, idx.reshape(-1))
    return out.reshape(d_all.shape[:-2] + tuple(idx.shape)
                       + d_all.shape[-1:])


def cost_from_derivatives(structure: ProblemStructure, d_seg: torch.Tensor,
                          times: torch.Tensor) -> torch.Tensor:
    """0.5 sum_k sum_dim d_seg^T H_k d_seg  ( == 0.5 c^T Q c)."""
    n = structure.n_coefficients
    h_blocks = qmatrix.hessian_blocks(times, n,
                                      structure.derivative_to_optimize)
    return 0.5 * torch.einsum('...krd,...krc,...kcd->...', d_seg, h_blocks,
                              d_seg)


def _common(d_fixed: torch.Tensor, times: torch.Tensor):
    dtype = torch.promote_types(d_fixed.dtype, times.dtype)
    return d_fixed.to(dtype), times.to(dtype), dtype


def solve_free_derivatives(structure: ProblemStructure,
                           d_fixed: torch.Tensor,
                           times: torch.Tensor) -> torch.Tensor:
    """d_free = -R_pp^{-1} R_pf d_f only: the closed-form solve without
    coefficient recovery or cost evaluation."""
    nf = structure.n_fixed
    d_fixed, times, dtype = _common(d_fixed, times)
    if structure.n_free == 0:
        return torch.zeros(d_fixed.shape[:-2] + (0, structure.dimension),
                           dtype=dtype, device=d_fixed.device)
    r = assemble_r(structure, times)
    r_pf = r[..., nf:, :nf]
    r_pp = r[..., nf:, nf:]
    # Jacobi (symmetric diagonal) equilibration: essential in float32 -- R
    # entries span T^(1-2d-i_r-i_c) across derivative orders.
    scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))
    r_pp_eq = r_pp * scale[..., :, None] * scale[..., None, :]
    rhs = -(r_pf @ d_fixed) * scale[..., :, None]
    sol_eq = torch.cholesky_solve(rhs, torch.linalg.cholesky(r_pp_eq))
    return sol_eq * scale[..., :, None]


def solve_linear(structure: ProblemStructure, d_fixed: torch.Tensor,
                 times: torch.Tensor) -> LinearSolution:
    """Closed-form solve: d_p = -R_pp^{-1} R_pf d_f, then coefficient
    recovery.

    Args:
      structure: static problem family.
      d_fixed: (..., n_fixed, D) fixed endpoint-derivative values, ordered as
        ``structure.fixed_cols``.
      times: (..., K) positive segment times.

    Reference: solveLinear (linear_impl.h:337-379), with SparseQR replaced by
    Jacobi-equilibrated Cholesky on the SPD R_pp.
    """
    d_fixed, times, _ = _common(d_fixed, times)
    d_free = solve_free_derivatives(structure, d_fixed, times)
    return solve_linear_with_free(structure, d_fixed, d_free, times)


def solve_linear_with_free(structure: ProblemStructure,
                           d_fixed: torch.Tensor, d_free: torch.Tensor,
                           times: torch.Tensor) -> LinearSolution:
    """Recover coefficients/cost for externally chosen free derivatives
    (linear_impl.h:490-498, 254-275).  Batch dims of d_fixed broadcast to
    those of d_free."""
    batch = torch.broadcast_shapes(d_fixed.shape[:-2], d_free.shape[:-2])
    d_fixed_b = d_fixed.expand(batch + d_fixed.shape[-2:])
    d_free_b = d_free.expand(batch + d_free.shape[-2:])
    d_seg = segment_derivatives(structure, d_fixed_b, d_free_b)
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    cost = cost_from_derivatives(structure, d_seg, times)
    return LinearSolution(coeffs, times, d_fixed, d_free, cost)


def extract_fixed_values(structure: ProblemStructure,
                         vertex_values: torch.Tensor) -> torch.Tensor:
    """Build d_fixed (..., n_fixed, D) from a dense (..., V, N/2, D)
    vertex-value tensor.  Free entries of ``vertex_values`` are ignored."""
    v = structure.n_vertices
    h = structure.half_n
    flat = vertex_values.reshape(
        vertex_values.shape[:-3] + (v * h, vertex_values.shape[-1]))
    idx = const((structure, "fixed_value_gather"),
                structure.fixed_value_gather, torch.long, flat.device)
    return torch.index_select(flat, -2, idx)
