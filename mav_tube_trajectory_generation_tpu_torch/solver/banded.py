"""Block-tridiagonal solvers: the giant-K linear solve and the tube-QCQP
KKT's LDL^T factors.

Counterpart of the JAX package's ``solver/banded.py``.  The chain structure
of a K-segment trajectory makes R block-tridiagonal in vertex space:
segment k's Hessian couples only vertices k and k+1.

* ``solve_linear_banded``: R assembled directly as its vertex blocks (each
  H_k's four N/2 x N/2 quadrants add into the (k, k), (k, k+1), (k+1, k+1)
  blocks; O(K N^2), no dense intermediate), and the free-free system solved
  by block cyclic reduction (``block_tridiag_solve``: ceil(log2(m+1))
  levels, each a batch of small products and inverses over the surviving
  blocks).  It applies where the endpoints are fully fixed and every
  interior vertex has the same free derivatives.
* The QCQP's KKT: kron(R_pp, I_D) + rho G^T G is block-tridiagonal in
  vertex blocks too (``kkt_tridiag_block``); its block LDL^T factors feed
  the xq solve and the m1 = W^-1 G^T sweeps inside the ADMM-stage kernel,
  the dense inverse from the band the stage kernel that takes one.

Every small inverse goes through the one ``ops.linalg.spd_inverse``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._tensors import const
from ..ops import linalg, qmatrix
from .linear import LinearSolution, solve_linear_with_free
from .structure import ProblemStructure

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def uniform_interior_pattern(structure: ProblemStructure
                             ) -> Optional[np.ndarray]:
    """The shared free-derivative index set of interior vertices, or None if
    the banded path does not apply."""
    mask = structure.fixed_mask
    if not mask[0].all() or not mask[-1].all():
        return None
    if structure.n_vertices < 3:
        return None
    interior = mask[1:-1]
    if not (interior == interior[0]).all():
        return None
    free_idx = np.flatnonzero(~interior[0])
    if free_idx.size == 0:
        return None
    return free_idx


def block_tridiag_solve(d_blocks: torch.Tensor, u_blocks: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Solve SPD block-tridiagonal systems by cyclic reduction.

    Args:
      d_blocks: (..., m, b, b) diagonal blocks.
      u_blocks: (..., m-1, b, b) super-diagonal blocks (block i couples
        unknowns i and i+1; the sub-diagonal is the transpose).
      rhs: (..., m, b, R) right-hand sides.

    Returns:
      (..., m, b, R), the batch dimensions broadcast.

    The system is padded to 2^L - 1 blocks with decoupled identity blocks
    (their unknowns stay 0); each of the L = ceil(log2(m+1)) levels
    eliminates the even-indexed blocks and keeps the odd ones, and the back
    substitution recovers the eliminated blocks level by level.
    """
    m, b = d_blocks.shape[-3], d_blocks.shape[-1]
    nrhs = rhs.shape[-1]
    batch = torch.broadcast_shapes(d_blocks.shape[:-3], u_blocks.shape[:-3],
                                   rhs.shape[:-3])
    dtype, dev = d_blocks.dtype, d_blocks.device

    def zeros(*shape):
        return torch.zeros(batch + shape, dtype=dtype, device=dev)

    levels = max(math.ceil(math.log2(m + 1)), 1)
    m_pad = 2 ** levels - 1
    eye = torch.eye(b, dtype=dtype, device=dev).expand(
        batch + (m_pad - m, b, b))
    d = torch.cat([d_blocks.expand(batch + (m, b, b)), eye], dim=-3)
    # u padded to m_pad blocks (the last is unused and zero)
    u = torch.cat([u_blocks.expand(batch + (m - 1, b, b)),
                   zeros(m_pad - m + 1, b, b)], dim=-3)
    f = torch.cat([rhs.expand(batch + (m, b, nrhs)),
                   zeros(m_pad - m, b, nrhs)], dim=-3)

    # Forward: eliminate the even-indexed blocks each level, keep the odd.
    stack = []
    while d.shape[-3] > 1:
        d_e, d_k = d[..., 0::2, :, :], d[..., 1::2, :, :]
        f_e, f_k = f[..., 0::2, :, :], f[..., 1::2, :, :]
        u_even = u[..., 0::2, :, :]       # U_2j:   even j  -> kept j
        u_odd = u[..., 1::2, :, :]        # U_2j+1: kept j  -> even j+1
        n_k = d_k.shape[-3]

        d_e_inv = linalg.spd_inverse(d_e)
        a = u_even[..., :n_k, :, :].transpose(-1, -2) @ d_e_inv[..., :n_k, :, :]
        bq = u_odd[..., :n_k, :, :] @ d_e_inv[..., 1:n_k + 1, :, :]
        d = (d_k - a @ u_even[..., :n_k, :, :]
             - bq @ u_odd[..., :n_k, :, :].transpose(-1, -2))
        f = (f_k - a @ f_e[..., :n_k, :, :]
             - bq @ f_e[..., 1:n_k + 1, :, :])
        u = torch.cat([-(bq[..., :n_k - 1, :, :] @ u_even[..., 1:n_k, :, :]),
                       zeros(1, b, b)], dim=-3)
        stack.append((d_e_inv, u_even, u_odd, f_e))

    x = linalg.spd_inverse(d) @ f                          # (..., 1, b, R)

    # Back substitution: x_e[j] = Dinv_j (f_e[j] - U_{2j-1}^T x_k[j-1]
    # - U_2j x_k[j]), then the two sets interleaved.
    for d_e_inv, u_even, u_odd, f_e in reversed(stack):
        n_e = d_e_inv.shape[-3]
        u_left = torch.cat([zeros(1, b, b), u_odd], dim=-3)[..., :n_e, :, :]
        x_left = torch.cat([zeros(1, b, nrhs), x], dim=-3)[..., :n_e, :, :]
        x_right = torch.cat([x, zeros(1, b, nrhs)], dim=-3)[..., :n_e, :, :]
        x_e = d_e_inv @ (f_e - u_left.transpose(-1, -2) @ x_left
                         - u_even[..., :n_e, :, :] @ x_right)
        out = zeros(n_e + x.shape[-3], b, nrhs)
        out[..., 0::2, :, :] = x_e
        out[..., 1::2, :, :] = x
        x = out
    return x[..., :m, :, :]


def solve_linear_banded(structure: ProblemStructure, d_fixed: torch.Tensor,
                        times: torch.Tensor) -> LinearSolution:
    """O(K log K) linear solve for the uniform-interior problem families.

    Same inputs and outputs as ``solver.linear.solve_linear``; raises
    ValueError where the banded path does not apply (check first with
    ``uniform_interior_pattern``).  There is no dense fallback.
    """
    free_idx = uniform_interior_pattern(structure)
    if free_idx is None:
        raise ValueError("Banded fast path requires fully fixed endpoints "
                         "and a uniform interior free pattern.")
    n = structure.n_coefficients
    h = structure.half_n
    v = structure.n_vertices
    dim = structure.dimension
    dtype = torch.promote_types(d_fixed.dtype, times.dtype)
    batch = torch.broadcast_shapes(d_fixed.shape[:-2], times.shape[:-1])
    d_fixed = d_fixed.to(dtype).expand(batch + d_fixed.shape[-2:])
    times = times.to(dtype).expand(batch + times.shape[-1:])
    dev = d_fixed.device

    hks = qmatrix.hessian_blocks(times, n, structure.derivative_to_optimize)
    h00 = hks[..., :h, :h]
    h01 = hks[..., :h, h:]
    h11 = hks[..., h:, h:]

    # Vertex-space band of R: D_v (..., V, h, h), U_v couples v to v+1
    # (..., K, h, h).
    zeros_h = torch.zeros_like(h00[..., :1, :, :])
    d_vtx = (torch.cat([h00, zeros_h], dim=-3)
             + torch.cat([zeros_h, h11], dim=-3))
    u_vtx = h01

    # d_f embedded in the dense vertex values (free entries zero).
    fix = const((structure, "fixed_value_gather"),
                structure.fixed_value_gather, torch.long, dev)
    d_embed = torch.zeros(batch + (v * h, dim), dtype=dtype, device=dev)
    d_embed[..., fix, :] = d_fixed
    d_embed = d_embed.reshape(batch + (v, h, dim))

    # rhs_free = -(R d_embed) on the interior free rows.
    zeros_d = zeros_h[..., :dim]
    rd = (d_vtx @ d_embed
          + torch.cat([u_vtx @ d_embed[..., 1:, :, :], zeros_d], dim=-3)
          + torch.cat([zeros_d,
                       u_vtx.transpose(-1, -2) @ d_embed[..., :-1, :, :]],
                      dim=-3))                             # (..., V, h, dim)
    fi = const((structure, "interior_free_idx"), lambda: free_idx,
               torch.long, dev)

    def free_rows(a):
        return torch.index_select(a, -2, fi)

    def free_block(a):
        return torch.index_select(free_rows(a), -1, fi)
    rhs = -free_rows(rd[..., 1:-1, :, :])                  # (..., V-2, f, dim)
    d_blocks = free_block(d_vtx[..., 1:-1, :, :])          # (..., V-2, f, f)
    # u_vtx[i] couples vertex i to i+1: interior pairs are i = 1 .. V-3
    u_blocks = free_block(u_vtx[..., 1:v - 2, :, :])

    # Jacobi equilibration (load-bearing in float32, as for the dense
    # solve): the unknowns scale as powers of T of their derivative order.
    scale = torch.rsqrt(torch.diagonal(d_blocks, dim1=-2, dim2=-1))
    d_blocks = d_blocks * scale[..., :, None] * scale[..., None, :]
    u_blocks = (u_blocks * scale[..., :-1, :, None]
                * scale[..., 1:, None, :])
    rhs = rhs * scale[..., None]

    d_free = block_tridiag_solve(d_blocks, u_blocks, rhs) * scale[..., None]
    d_free = d_free.reshape(batch + ((v - 2) * fi.numel(), dim))
    return solve_linear_with_free(structure, d_fixed, d_free, times)


def kkt_tridiag_block(structure: ProblemStructure) -> Optional[int]:
    """Block size of the tube-QCQP KKT/Hessian's block-tridiagonal structure
    (in vertex-major free-column order), or None if it does not apply.

    kron(R_pp, I_D) + (constraint Gram) is EXACTLY block-tridiagonal:
    min-snap R_pp couples only vertices sharing a segment, and every
    tube/sphere/end-cap constraint row's support is one segment's two
    endpoint vertices.  Requires interior vertices sharing one
    free-derivative pattern and vertex-major columns.
    """
    fi = uniform_interior_pattern(structure)
    if fi is None or structure.n_vertices < 4:
        return None
    expect = [(v, int(d)) for v in range(1, structure.n_vertices - 1)
              for d in fi]
    if [tuple(map(int, c)) for c in structure.free_cols] != expect:
        return None
    return len(fi) * structure.dimension


def _unstack(blocks: Blocks) -> List[torch.Tensor]:
    if isinstance(blocks, (list, tuple)):
        return list(blocks)
    return [blocks[..., i, :, :] for i in range(blocks.shape[-3])]


def spd_block_tridiag_factor(dblk: Blocks, ublk: Blocks
                             ) -> Tuple[List[torch.Tensor],
                                        List[Optional[torch.Tensor]]]:
    """Block LDL^T factorization A = (I+L) S (I+L)^T of an SPD
    block-tridiagonal matrix: returns (s_inv, t) with S_i^{-1} and the
    subdiagonal factors T_i = U_{i-1}^T S_{i-1}^{-1} (t[0] is None).

    dblk: m diagonal blocks, ublk: m-1 super-diagonal blocks, as lists of
    (..., b, b) or stacked (..., m, b, b) tensors.  Each Schur complement is
    symmetrized before it is inverted: the reference found that load-bearing
    in float32 (asymmetry drift amplifies through the sweep).
    """
    dblk = _unstack(dblk)
    ublk = _unstack(ublk)
    m = len(dblk)
    s_inv = [linalg.spd_inverse(dblk[0])]
    t: List[Optional[torch.Tensor]] = [None]
    for i in range(1, m):
        ti = ublk[i - 1].transpose(-1, -2) @ s_inv[i - 1]
        s = dblk[i] - ti @ ublk[i - 1]
        s = 0.5 * (s + s.transpose(-1, -2))
        t.append(ti)
        s_inv.append(linalg.spd_inverse(s))
    return s_inv, t


def spd_block_tridiag_solve_factored(s_inv: Sequence[torch.Tensor],
                                     t: Sequence[Optional[torch.Tensor]],
                                     rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs from ``spd_block_tridiag_factor``'s (s_inv, t).

    rhs: (..., n, R) with n = m * b.  Forward (I+L) y = rhs, diagonal
    z = S^{-1} y, backward (I+L)^T x = z; every step is one batched
    (b, b) @ (b, R) product.
    """
    bsz = s_inv[0].shape[-1]
    return spd_block_tridiag_solve_factored_rows(
        s_inv, t, [rhs[..., i * bsz:(i + 1) * bsz, :]
                   for i in range(len(s_inv))])


def spd_block_tridiag_inverse(a: torch.Tensor, block_size: int
                              ) -> torch.Tensor:
    """Dense inverse of (batched) SPD block-tridiagonal matrices given
    densely, (..., n, n) with blocks of ``block_size``; the entries off the
    band are not read (the caller guarantees they are zero)."""
    n = a.shape[-1]
    bsz = block_size
    m = n // bsz
    if m * bsz != n:
        raise ValueError(f"n={n} not a multiple of block_size={bsz}")
    dblk = [a[..., i * bsz:(i + 1) * bsz, i * bsz:(i + 1) * bsz]
            for i in range(m)]
    ublk = [a[..., i * bsz:(i + 1) * bsz, (i + 1) * bsz:(i + 2) * bsz]
            for i in range(m - 1)]
    return spd_block_tridiag_inverse_blocks(dblk, ublk)


def spd_block_tridiag_inverse_blocks(dblk: Blocks, ublk: Blocks
                                     ) -> torch.Tensor:
    """Dense inverse (..., n, n) of an SPD block-tridiagonal matrix given by
    its m diagonal blocks ``dblk`` and m-1 super-diagonal blocks ``ublk``
    (lists of (..., b, b) or stacked (..., m, b, b) tensors), n = m * b.

    Block-Thomas sweeps against the identity over the factors of
    ``spd_block_tridiag_factor`` (whose pivot blocks go through the one
    ``ops.linalg.spd_inverse``): forward (I+L) Y = I, diagonal Z = S^-1 Y,
    backward (I+L)^T X = Z, each step one batched (b, b) @ (b, n) product.
    """
    s_inv, t = spd_block_tridiag_factor(dblk, ublk)
    m = len(s_inv)
    bsz = s_inv[0].shape[-1]
    eye = torch.eye(m * bsz, dtype=s_inv[0].dtype, device=s_inv[0].device)
    shape = s_inv[0].shape[:-2] + (bsz, m * bsz)
    return spd_block_tridiag_solve_factored_rows(
        s_inv, t, [eye[i * bsz:(i + 1) * bsz].expand(shape)
                   for i in range(m)])


def spd_block_tridiag_solve_factored_rows(
        s_inv: Sequence[torch.Tensor], t: Sequence[Optional[torch.Tensor]],
        r: Sequence[torch.Tensor]) -> torch.Tensor:
    """``spd_block_tridiag_solve_factored`` with the right-hand side given
    as its m block rows r[i] (..., b, R).  Z is written into the result (each
    block row by its product, no copy) and X formed over it in place, so
    that besides the result only one block row of Y is held (a dense inverse
    is 448 MB at 6144 scenarios of n = 135)."""
    m = len(s_inv)
    bsz = s_inv[0].shape[-1]
    batch = torch.broadcast_shapes(s_inv[0].shape[:-2], r[0].shape[:-2])
    x = torch.empty(batch + (m * bsz, r[0].shape[-1]),
                    dtype=torch.promote_types(s_inv[0].dtype, r[0].dtype),
                    device=s_inv[0].device)
    y = r[0]
    for i in range(m):
        if i:
            y = r[i] - t[i] @ y
        torch.matmul(s_inv[i], y.expand(batch + y.shape[-2:]),
                     out=x[..., i * bsz:(i + 1) * bsz, :])
    for i in range(m - 2, -1, -1):
        x[..., i * bsz:(i + 1) * bsz, :] -= (
            t[i + 1].transpose(-1, -2)
            @ x[..., (i + 1) * bsz:(i + 2) * bsz, :])
    return x
