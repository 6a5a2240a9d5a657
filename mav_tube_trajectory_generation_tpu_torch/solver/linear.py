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

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._tensors import DeviceLike, const, resolve_device
from ..ops import linalg, qmatrix
from ..utils import timing
from .structure import ProblemStructure, make_structure, standard_mask

METHODS = ("cholesky", "schur")


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
    """0.5 sum_k sum_dim d_seg^T H_k d_seg  ( == 0.5 c^T Q c).

    Formed and summed in float64, then rounded once to the inputs' dtype:
    the terms cancel, their magnitudes summing to 6e4-5e6 times the cost
    at K=10, so a float32 sum is off by up to a few percent."""
    n = structure.n_coefficients
    wide = torch.promote_types(d_seg.dtype, torch.float64)
    h_blocks = qmatrix.hessian_blocks(times.to(wide), n,
                                      structure.derivative_to_optimize)
    d_wide = d_seg.to(wide)
    cost = 0.5 * torch.einsum('...krd,...krc,...kcd->...', d_wide, h_blocks,
                              d_wide)
    return cost.to(torch.promote_types(d_seg.dtype, times.dtype))


def _common(d_fixed: torch.Tensor, times: torch.Tensor):
    dtype = torch.promote_types(d_fixed.dtype, times.dtype)
    return d_fixed.to(dtype), times.to(dtype), dtype


def solve_free_derivatives(structure: ProblemStructure,
                           d_fixed: torch.Tensor,
                           times: torch.Tensor,
                           method: str = "cholesky") -> torch.Tensor:
    """d_free = -R_pp^{-1} R_pf d_f only: the closed-form solve without
    coefficient recovery or cost evaluation.

    ``method``: "cholesky" (a Cholesky solve of the equilibrated R_pp) or
    "schur" (the JAX package's name for its matmul-only inverse times the
    right-hand side: here ``ops.linalg.spd_inverse`` and a product).
    """
    return _free_derivatives(structure, d_fixed, times, method)[0]


def _free_derivatives(structure: ProblemStructure, d_fixed: torch.Tensor,
                      times: torch.Tensor, method: str):
    """(d_free, refused): ``solve_free_derivatives``'s answer, and the rows
    (...,) whose R_pp the Cholesky factor refused, as a bool tensor on the
    device (None where no factor ran: "schur", or no free derivative)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    nf = structure.n_fixed
    d_fixed, times, dtype = _common(d_fixed, times)
    if structure.n_free == 0:
        return torch.zeros(d_fixed.shape[:-2] + (0, structure.dimension),
                           dtype=dtype, device=d_fixed.device), None
    r = assemble_r(structure, times)
    r_pf = r[..., nf:, :nf]
    r_pp = r[..., nf:, nf:]
    # Jacobi (symmetric diagonal) equilibration: essential in float32 -- R
    # entries span T^(1-2d-i_r-i_c) across derivative orders.
    scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))
    r_pp_eq = r_pp * scale[..., :, None] * scale[..., None, :]
    rhs = -(r_pf @ d_fixed) * scale[..., :, None]
    refused = None
    if method == "schur":
        sol_eq = linalg.spd_inverse(r_pp_eq) @ rhs
    else:
        # A row whose R_pp will not factor comes back NaN and leaves the
        # other rows as they are (the JAX package's cho_factor semantics);
        # the batch neither raises nor waits on the host for the verdict.
        chol, info = torch.linalg.cholesky_ex(r_pp_eq, check_errors=False)
        if dtype == torch.float64:
            # float64 keeps cholesky_solve's rounding on the card: the
            # nonlinear optimizer starts from this solve, and which rows of
            # its collision box case clear turns on the last bits of the
            # start (chip_smoke.py's nonlinear_collision).
            sol_eq = torch.cholesky_solve(rhs, chol)
        else:
            # Two triangular solves, which is what cholesky_solve computes
            # (bit for bit on the host): on the card a batched
            # cholesky_solve is MAGMA's, whose launching thread stalls for
            # tens to hundreds of ms in some calls.
            sol_eq = torch.linalg.solve_triangular(
                chol.mT, torch.linalg.solve_triangular(chol, rhs,
                                                       upper=False),
                upper=True)
        refused = info != 0
        sol_eq = torch.where(refused[..., None, None],
                             torch.full_like(sol_eq, float("nan")), sol_eq)
    return sol_eq * scale[..., :, None], refused


def solve_linear(structure: ProblemStructure, d_fixed: torch.Tensor,
                 times: torch.Tensor, method: str = "cholesky"
                 ) -> LinearSolution:
    """Closed-form solve: d_p = -R_pp^{-1} R_pf d_f, then coefficient
    recovery.

    Args:
      structure: static problem family.
      d_fixed: (..., n_fixed, D) fixed endpoint-derivative values, ordered as
        ``structure.fixed_cols``.
      times: (..., K) positive segment times.
      method: "cholesky" or "schur", as in ``solve_free_derivatives``.

    Reference: solveLinear (linear_impl.h:337-379), with SparseQR replaced by
    Jacobi-equilibrated Cholesky on the SPD R_pp.

    While spans are on (``utils.timing``) the call is the span ``linear``,
    on the inputs' device; the counter ``linear.refused_rows`` adds the rows
    whose R_pp the Cholesky factor refused (read from the device with the
    log).  The helpers it calls, which the QCQP solvers call directly, open
    no span of their own.
    """
    d_fixed, times, _ = _common(d_fixed, times)
    with timing.span("linear", d_fixed.device):
        d_free, refused = _free_derivatives(structure, d_fixed, times, method)
        if refused is not None:
            timing.count("linear.refused_rows", refused)
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


def derivative_cost_and_grad(structure: ProblemStructure,
                             d_fixed: torch.Tensor, d_free: torch.Tensor,
                             times: torch.Tensor):
    """(J_d, dJ_d/dd_p) from the blocks of R, with
    J_d = d_f^T R_ff d_f + 2 d_f^T R_fp d_p + d_p^T R_pp d_p summed over the
    dimensions and grad = 2 R_fp^T d_f + 2 R_pp d_p
    (getCostAndGradientDerivative, nonlinear_impl.h:1537-1606).  As in the
    reference, J_d is twice the 0.5 c^T Q c cost of ``LinearSolution``."""
    nf = structure.n_fixed
    r = assemble_r(structure, times)
    r_ff = r[..., :nf, :nf]
    r_fp = r[..., :nf, nf:]
    r_pp = r[..., nf:, nf:]
    jf = torch.einsum('...fd,...fg,...gd->...', d_fixed, r_ff, d_fixed)
    jc = 2.0 * torch.einsum('...fd,...fp,...pd->...', d_fixed, r_fp, d_free)
    jp = torch.einsum('...pd,...pq,...qd->...', d_free, r_pp, d_free)
    grad = (2.0 * torch.einsum('...fp,...fd->...pd', r_fp, d_fixed)
            + 2.0 * torch.einsum('...pq,...qd->...pd', r_pp, d_free))
    return jf + jc + jp, grad


def compact_from_segment_derivatives(structure: ProblemStructure,
                                     d_seg: torch.Tensor) -> torch.Tensor:
    """M^+ d_seg: the compact [d_f; d_p] from per-segment endpoint
    derivatives (..., K, N, D), duplicated interior entries averaged.

    The reference's row-normalised pseudo-inverse getMpinv
    (linear_impl.h:547-555); the exact inverse of ``segment_derivatives``
    for any continuity-consistent d_seg.
    """
    k, n = structure.gather_idx.shape
    counts = const((structure, "gather_counts"), lambda: np.bincount(
        structure.gather_idx.ravel(), minlength=structure.n_total),
        d_seg.dtype, d_seg.device)
    idx = const((structure, "gather_idx"), lambda: structure.gather_idx,
                torch.long, d_seg.device)
    batch = d_seg.shape[:-3]
    summed = torch.zeros(batch + (structure.n_total, d_seg.shape[-1]),
                         dtype=d_seg.dtype, device=d_seg.device)
    summed.index_add_(-2, idx.reshape(-1),
                      d_seg.reshape(batch + (k * n, d_seg.shape[-1])))
    return summed / counts[:, None]


def solve_from_positions(positions, times, n_coefficients: int = 10,
                         derivative_to_optimize: Optional[int] = None,
                         device: DeviceLike = None):
    """One-call solve from a plain list of positions, in float64 (the
    reference's setupFromPositons, linear.h:79-80): the endpoints at rest up
    to derivative N/2-1, interior vertices position-only.

    Args:
      positions: (V, D) waypoint positions (host array).
      times: (V-1,) segment times (host array).
      device: where to solve; None means the CUDA card.

    Returns:
      (ProblemStructure, LinearSolution).
    """
    dev = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim == 1:
        positions = positions[:, None]
    v, dim = positions.shape
    n = n_coefficients
    structure = make_structure(standard_mask(v, n), dim, n,
                               derivative_to_optimize)
    values = np.zeros((v, n // 2, dim))
    values[:, 0, :] = positions
    d_fixed = extract_fixed_values(
        structure, torch.as_tensor(values, device=dev))
    t = torch.as_tensor(np.asarray(times, dtype=np.float64), device=dev)
    return structure, solve_linear(structure, d_fixed, t)


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
