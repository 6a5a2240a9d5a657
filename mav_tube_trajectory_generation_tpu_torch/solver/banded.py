"""Block-tridiagonal structure of the tube-QCQP KKT and its LDL^T factors.

Counterpart of the parts of the JAX package's ``solver/banded.py`` that the
QP+QCQP path runs: the structure test (``kkt_tridiag_block``), the block
LDL^T factorization, the factored solve and the dense inverse from the band
(``spd_block_tridiag_inverse_blocks``).  The chain structure of a K-segment
trajectory makes kron(R_pp, I_D) + rho G^T G block-tridiagonal in vertex
blocks; the factors feed both the xq solve here and the m1 = W^-1 G^T sweeps
inside the ADMM-stage kernel, the dense inverse the stage kernel that takes
one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import linalg
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
