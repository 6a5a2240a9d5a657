"""Tube/corridor-constrained QCQP solver: batched first-order ADMM.

Counterpart of the JAX package's ``solver/qcqp.py``: ``solve_qcqp_batch``
on every KKT route of its stage kernels, and the generic ``solve_qcqp``.
Replaces the
reference's Mosek interior-point QCQP (polynomial_optimization_qcqp.h +
qcqp_impl.h): minimize the derivative energy subject to

  * sphere constraints   ||cp_last(k) - vertex_{k+1}|| <= r2_k at interior
    vertices (qcqp_impl.h:358-365),
  * tube constraints     ||(I - n n^T)(cp_j(k) - p_k)|| <= r1_k confining the
    mid control points 1..N-2 to a cylinder around the segment line
    (qcqp_impl.h:370-429),
  * tube end-caps        two half-space cuts per mid control point capping
    the cylinder (qcqp_impl.h:432-474),

where cp are Bezier control points of each segment (convex-hull property).
Every constraint is an affine image of the free endpoint derivatives landing
in a ball or half-line, so the problem is

    min 0.5 x^T P x + q^T x   s.t.  y = G x + g,  y in C (balls x halflines)

solved by over-relaxed ADMM in fixed-iteration stages with per-scenario
status outputs instead of aborts.  Jacobi cost equilibration and
per-constraint row equilibration keep it float32-robust.

All tensors carry the batch dimension B written out in front; nothing is
vmapped.  Per batch: objective blocks and warm start, the equilibrated
constraint system assembled directly in the stage kernel's padded lane
layout, then per stage the KKT matrix for the current penalty rho and one
call of a stage kernel of ``ops.admm_kernel`` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors), rho rebalanced between stages.
The KKT routes (``ADMMConfig.kkt_inverse`` / ``kkt_apply`` / ``band_gram``,
as in the JAX package):

  * banded + factored (the default where ``banded.kkt_tridiag_block``
    holds): the block-tridiagonal KKT band, its block-LDL^T factors and
    ``admm_stage_fused_factored``; the Gram band from the dense Gram
    (``band_gram="xla"``), from ``gram_band`` ("pallas", "pallas_block"),
    or the whole KKT band from ``gram_band_factors`` each stage
    ("pallas_db");
  * banded + factored with ``gt_assembly="kernel"``: G^T is never formed;
    the assembly stops at its rank-1 row factors e (B, n_free, m_p) and w
    (B, 3, m_p), and each stage runs ``gram_band_factors_ew`` (the whole
    KKT band, whatever ``band_gram`` says) and
    ``admm_stage_fused_factored_ew``, which expand G^T as they read it.  On
    the same inputs it gives the bits of the "pallas_db" route.  A structure
    without the block band (K = 2) and ``_return_pre`` are refused;
  * banded + inverse (``kkt_apply="inverse"``): the dense inverse from the
    band (``banded.spd_block_tridiag_inverse_blocks``) and
    ``admm_stage_fused``;
  * dense (``kkt_inverse="cholesky"``, or no block band, e.g. K = 2):
    kron(p_eq, I3) + rho G^T G + sigma I, its inverse by
    ``linalg.spd_inverse``, and ``admm_stage_fused``.

``build_constraints`` gives the same constraints in the reference layout
(per-constraint Jacobians).  ``solve_qcqp`` is the generic solve on that
layout: any float dtype, a dense KKT inverse per stage and the iterations as
plain batched products, no kernel.  It is what the float64 last tier of the
verdict router (``solver.auto``) starts from, and the ground truth the tests
hold the kernel path against.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._tensors import DeviceLike, as_tensor, const, resolve_device, \
    tensor_dtype
from ..ops import admm_kernel, bezier, linalg, qmatrix
from ..utils import timing
from . import banded, linear
from .structure import ProblemStructure, make_structure, standard_mask

# Device-memory bounds of the assembly: free derivatives of G^T formed at a
# time, and scenarios whose dense Gram the "xla" band forms at a time.
_ASSEMBLY_ROWS = 9
_GRAM_SCENARIOS = 1024


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """First-order solver knobs (static).

    Iterations are organized as ``n_stages`` stages of ``n_iters`` steps;
    between stages the penalty rho is rebalanced from the primal/dual
    residual ratio (OSQP-style) and the KKT band refactored.  rho adapts per
    scenario.
    """
    rho: float = 0.1            # initial ADMM penalty (after equilibration)
    sigma: float = 1e-8         # KKT regularization
    alpha: float = 1.6          # over-relaxation
    n_iters: int = 200          # iterations per stage
    n_stages: int = 5           # rho-rebalancing stages (refactorizations)
    rho_min: float = 1e-4
    rho_max: float = 1e4
    eps_primal: float = 1e-5    # convergence thresholds for status output
    eps_dual: float = 1e-5
    # Per-constraint-family penalty factors: scaling a row by sqrt(f) after
    # equilibration gives that constraint an effective penalty f * rho (the
    # feasible set is invariant).
    rho_sphere_factor: float = 1.0
    rho_tube_factor: float = 1.0
    rho_half_factor: float = 1.0
    # The KKT route of ``solve_qcqp_batch``, with the JAX package's names and
    # defaults.  kkt_inverse: "schur" keeps the block-tridiagonal band where
    # the structure has one, "cholesky" switches it off (the dense KKT).
    # Both invert with this package's one dense inverse, the equilibrated
    # Cholesky of ``ops.linalg.spd_inverse`` (the JAX package's "schur" is a
    # matmul-only inverse; the two differ by float32 rounding only).
    kkt_inverse: str = "schur"
    # On the band: "factored" applies W^-1 by block-Thomas sweeps over the
    # LDL^T factors in the stage kernel; "inverse" forms the dense inverse
    # from the band and runs the dense-inverse stage kernel.
    kkt_apply: str = "factored"
    # Where the Gram band comes from (read only where there is a band):
    # "xla" the dense Gram G^T G, one batched product, and its band;
    # "pallas" / "pallas_block" the band kernel ``gram_band`` (the two were
    # code-generation variants of the TPU kernel and are one kernel here);
    # "pallas_db" the whole KKT band from ``gram_band_factors`` each stage.
    band_gram: str = "xla"
    # Where G^T comes from on the banded factored route: "xla" assembles the
    # (B, nfd, m_p) tensor; "kernel" stops at its rank-1 row factors, and
    # the stage and band kernels expand it as they read it (the Gram band
    # then always comes from ``gram_band_factors_ew``).  "kernel" needs
    # kkt_apply="factored" and kkt_inverse="schur", and a structure with the
    # block band.
    gt_assembly: str = "xla"

    def __post_init__(self):
        if self.gt_assembly not in ("xla", "kernel"):
            raise ValueError(
                f"gt_assembly must be 'xla' or 'kernel', got "
                f"{self.gt_assembly!r}")
        if self.band_gram not in ("xla", "pallas", "pallas_block",
                                  "pallas_db"):
            raise ValueError(
                f"band_gram must be 'xla', 'pallas', 'pallas_block' or "
                f"'pallas_db', got {self.band_gram!r}")
        if self.kkt_apply not in ("factored", "inverse"):
            raise ValueError(
                f"kkt_apply must be 'factored' or 'inverse', got "
                f"{self.kkt_apply!r}")
        if self.kkt_inverse not in ("schur", "cholesky"):
            raise ValueError(
                f"kkt_inverse must be 'schur' or 'cholesky', got "
                f"{self.kkt_inverse!r}")
        if self.gt_assembly == "kernel" and (
                self.kkt_apply != "factored" or self.kkt_inverse != "schur"):
            raise ValueError(
                "gt_assembly='kernel' requires kkt_apply='factored' and "
                "kkt_inverse='schur' (the banded factored route is the only "
                "G^T consumer there)")


class QCQPSolution(NamedTuple):
    coefficients: torch.Tensor     # (B, K, N, D)
    times: torch.Tensor            # (B, K)
    d_fixed: torch.Tensor          # (B, n_fixed, D)
    d_free: torch.Tensor           # (B, n_free, D)
    cost: torch.Tensor             # (B,) 0.5 c^T Q c derivative energy
    converged: torch.Tensor        # (B,) bool
    primal_residual: torch.Tensor  # (B,)
    dual_residual: torch.Tensor    # (B,)
    max_violation: torch.Tensor    # (B,) max constraint violation of output
    dual_ball: torch.Tensor        # (B, n_ball, 3) scaled ADMM duals (rho*u)
    dual_half: torch.Tensor        # (B, n_half) scaled ADMM duals (rho*u)
    # Primal-infeasibility evidence: an interior-point back end fills it;
    # the ADMM leaves it None.
    infeasible: Optional[torch.Tensor] = None


class _PadLayout(NamedTuple):
    """Static description of the packed component-plane lane layout.

    Each of the 3 ball planes is nb_p lanes: [ball rows (n_ball) | packed
    half-space rows (tail)]; remaining half rows go to a final plane of
    nh_p lanes."""
    n_ball: int
    n_half: int
    nb_p: int
    nh_p: int

    @property
    def tail(self) -> int:
        return self.nb_p - self.n_ball

    @property
    def m_p(self) -> int:
        return 3 * self.nb_p + self.nh_p

    def half_chunks(self):
        """[(plane_index, lane_offset, half_offset, length)] covering all
        n_half rows: planes 0-2 tails first, then the final plane."""
        out = []
        for c in range(3):
            off = c * self.tail
            ln = max(0, min(self.tail, self.n_half - off))
            if ln:
                out.append((c, self.n_ball, off, ln))
        rest = min(3 * self.tail, self.n_half)
        if self.n_half - rest:
            out.append((3, 0, rest, self.n_half - rest))
        return out

    @staticmethod
    def make(n_ball: int, n_half: int) -> "_PadLayout":
        nb_p = admm_kernel.round_up(max(n_ball, 1), 128)
        rest = max(n_half - 3 * (nb_p - n_ball), 0)
        nh_p = admm_kernel.round_up(rest, 128) if rest else 0
        return _PadLayout(n_ball, n_half, nb_p, nh_p)


def _flagship_layout(structure: ProblemStructure) -> _PadLayout:
    k_seg = structure.n_segments
    n_co = structure.n_coefficients
    return _PadLayout.make((k_seg - 1) + k_seg * (n_co - 2),
                           k_seg * (n_co - 2) * 2)


def _control_point_maps(structure: ProblemStructure, times: torch.Tensor,
                        d_fixed: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cp0 (B, K, N, D), Ecp (B, K, N, n_free)): affine map
    cp = cp0 + Ecp x."""
    n = structure.n_coefficients
    nf = structure.n_fixed
    dt, dev = times.dtype, times.device
    m_hot = const((structure, "one_hot_m"), structure.one_hot_m, dt, dev)
    m_fix = m_hot[:, :, :nf]
    m_free = m_hot[:, :, nf:]
    binv = const(("inv_cp_unit", n),
                 lambda: bezier.inv_control_point_mapping_unit(n), dt, dev)
    iord = const(("row_orders", n), lambda: qmatrix.row_derivative_orders(n),
                 dt, dev)
    ipow = times[..., None] ** iord                       # (B, K, N)
    binv_t = binv[None, None, :, :] * ipow[:, :, None, :]  # (B, K, N, N)
    cp0 = torch.einsum('bkjr,krf,bfd->bkjd', binv_t, m_fix, d_fixed)
    ecp = torch.einsum('bkjr,krp->bkjp', binv_t, m_free)
    return cp0, ecp


def _row_scale_bounds(n_coefficients: int) -> Tuple[float, float]:
    """Constraint-row equilibration clamp, N-aware: [1e-2, 1e2] at N <= 10
    (the bounds every quality number was calibrated against); at N = 12 the
    control-point maps' T^l dynamic range pushes real rows' equilibrated
    norms below 1e-2, and [1e-4, 1e4] restores the N = 10 conditioning
    class."""
    return (1e-2, 1e2) if n_coefficients <= 10 else (1e-4, 1e4)


class _ConstraintSystem(NamedTuple):
    """Affine constraint maps of a batch, reference layout."""
    g_ball: torch.Tensor      # (B, n_ball, 3, n_free, D) jacobian
    b_ball: torch.Tensor      # (B, n_ball, 3) offset
    r_ball: torch.Tensor      # (B, n_ball) radius
    g_half: torch.Tensor      # (B, n_half, n_free, D) jacobian
    b_half: torch.Tensor      # (B, n_half) offset (constraint: y <= 0 with
                              #  the offset folded in)


class _ConstraintGeometry(NamedTuple):
    """The small tensors every constraint row is made of: row m of the
    Jacobian is the outer product of a control-point map ``ecp[k, j, :]`` and
    a direction (a row of eye3, of the projector P_k, or +-n_k)."""
    ecp: torch.Tensor         # (B, K, N, n_free)
    proj: torch.Tensor        # (B, K, 3, 3)
    dirs: torch.Tensor        # (B, K, 2, 3)
    b_ball: torch.Tensor      # (B, n_ball, 3)
    r_ball: torch.Tensor      # (B, n_ball)
    b_half: torch.Tensor      # (B, n_half)


def _constraint_geometry(structure: ProblemStructure, times, d_fixed,
                         waypoints, radii) -> _ConstraintGeometry:
    """Unscaled sphere / tube / end-cap forms of qcqp_impl.h:358-474 for a
    batch (see ``build_constraints`` for the arguments)."""
    k = structure.n_segments
    n = structure.n_coefficients
    if structure.dimension != 3:
        raise ValueError("Tube constraints require dimension == 3.")
    dt, dev = times.dtype, times.device
    bsz = times.shape[0]
    cp0, ecp = _control_point_maps(structure, times, d_fixed)
    p_start = waypoints[:, :-1]
    p_end = waypoints[:, 1:]
    seg_vec = p_end - p_start
    seg_norm = torch.linalg.vector_norm(seg_vec, dim=-1, keepdim=True)
    nvec = seg_vec / torch.clamp(seg_norm, min=1e-12)      # (B, K, 3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    proj = eye3 - nvec[..., :, None] * nvec[..., None, :]  # (B, K, 3, 3)
    mid = slice(1, n - 1)
    n_mid = n - 2

    # Spheres at interior vertices (segments 0..K-2):
    # y = cp[k, N-1, :] - waypoint_{k+1} in Ball(r2_k).
    b_sph = cp0[:, :k - 1, n - 1, :] - waypoints[:, 1:k]
    r_sph = radii[:, :k - 1, 1]
    # Tubes on mid control points 1..N-2 of every segment:
    # y = P_k (cp[k, j, :] - p_k) in Ball(r1_k).
    b_tube = torch.einsum('bkid,bkjd->bkji', proj,
                          cp0[:, :, mid] - p_start[:, :, None, :])
    r_tube = radii[:, :, :1].expand(bsz, k, n_mid)
    # End caps on the same control points: (-n_k)^T cp <= (-n_k)^T p_cap_start
    # with p_cap_start = p_k - n_k r_prev (r_prev = radii[k-1].second, or
    # radii[0].first for the first segment; qcqp_impl.h:451-456), and
    # n_k^T cp <= n_k^T p_cap_end with p_cap_end = p_{k+1} + n_k radii[k].second.
    r_prev = torch.cat([radii[:, :1, 0], radii[:, :-1, 1]], dim=1)
    p_cap_start = p_start - nvec * r_prev[..., None]
    p_cap_end = p_end + nvec * radii[:, :, 1][..., None]
    dirs = torch.stack([-nvec, nvec], dim=2)               # (B, K, 2, 3)
    caps = torch.stack([p_cap_start, p_cap_end], dim=2)    # (B, K, 2, 3)
    b_half = (torch.einsum('bksd,bkjd->bkjs', dirs, cp0[:, :, mid])
              - torch.einsum('bksd,bksd->bks', dirs, caps)[:, :, None, :])
    return _ConstraintGeometry(
        ecp=ecp, proj=proj, dirs=dirs,
        b_ball=torch.cat([b_sph, b_tube.reshape(bsz, k * n_mid, 3)], dim=1),
        r_ball=torch.cat([r_sph, r_tube.reshape(bsz, k * n_mid)], dim=1),
        b_half=b_half.reshape(bsz, k * n_mid * 2))


def build_constraints(structure: ProblemStructure, times, d_fixed, waypoints,
                      radii) -> _ConstraintSystem:
    """The ball / half-space constraint system of a batch in the reference
    layout, with per-constraint Jacobians (about 230 KB a scenario at K=10 in
    float32: meant for tests and small batches).

    Args (batched): times (B, K), d_fixed (B, n_fixed, 3), waypoints
    (B, V, 3) vertex positions (interior positions are geometry for the
    tubes, not equality constraints), radii (B, K, 2) per-segment (tube
    radius r1, sphere radius r2).
    """
    k = structure.n_segments
    n = structure.n_coefficients
    geo = _constraint_geometry(structure, times, d_fixed, waypoints, radii)
    ecp = geo.ecp
    bsz, n_free = ecp.shape[0], ecp.shape[-1]
    n_mid = n - 2
    mid = slice(1, n - 1)
    eye3 = torch.eye(3, dtype=ecp.dtype, device=ecp.device)
    g_sph = (ecp[:, :k - 1, n - 1][:, :, None, :, None]
             * eye3[None, None, :, None, :])
    # g_tube[k, j, i, p, dd] = proj[k, i, dd] * ecp[k, j, p]
    g_tube = torch.einsum('bkid,bkjp->bkjipd', geo.proj, ecp[:, :, mid])
    # g_half[k, j, s, p, d] = dirs[k, s, d] * ecp[k, j, p]
    g_half = torch.einsum('bksd,bkjp->bkjspd', geo.dirs, ecp[:, :, mid])
    return _ConstraintSystem(
        g_ball=torch.cat([g_sph, g_tube.reshape(bsz, k * n_mid, 3, n_free,
                                                3)], dim=1),
        b_ball=geo.b_ball, r_ball=geo.r_ball,
        g_half=g_half.reshape(bsz, k * n_mid * 2, n_free, 3),
        b_half=geo.b_half)


def _padded_gather_maps(k: int, n: int, layout: _PadLayout):
    """Static lane -> source-row index maps for the padded component-plane
    layout (NumPy): every constraint row of G^T is an outer product
    ``ecp_s[k_m, j_m, :] (x) w_m`` with ``w_m`` a direction vector times a
    row scale, so the whole (nfd, m_p) tensor is written once by a gather and
    a broadcast multiply.

    Lane order per ball plane c: [spheres (k-1) | tubes (k*(n-2)) | packed
    half rows | zero pad]; final plane: [remaining half rows | zero pad].

    Returns int32 arrays of length m_p: ecp_idx (into ecp_s.reshape(k*n,
    nf)), dir_idx (into the [eye3 | proj | dirs | 0] direction pool),
    scl_idx (into [sb_sph | sb_tube | sh | 0]), off_idx (into
    [b_sph | b_tube | b_half | 0]).
    """
    n_mid = n - 2
    n_ball = layout.n_ball
    m_p = layout.m_p
    ecp_idx = np.zeros(m_p, np.int32)
    dir_idx = np.full(m_p, 3 + 3 * k + 2 * k, np.int32)     # zero pool row
    scl_idx = np.full(m_p, n_ball + layout.n_half, np.int32)  # zero scale
    off_idx = np.full(m_p, 3 * n_ball + layout.n_half, np.int32)  # zero b

    def set_half(lane, h):
        ki, rem = divmod(h, n_mid * 2)
        j, s = divmod(rem, 2)
        ecp_idx[lane] = ki * n + 1 + j
        dir_idx[lane] = 3 + 3 * k + ki * 2 + s
        scl_idx[lane] = n_ball + h
        off_idx[lane] = 3 * n_ball + h

    for c in range(3):
        base = c * layout.nb_p
        for b in range(k - 1):                               # spheres
            lane = base + b
            ecp_idx[lane] = b * n + (n - 1)
            dir_idx[lane] = c
            scl_idx[lane] = b
            off_idx[lane] = b * 3 + c
        for r in range(k * n_mid):                           # tubes
            lane = base + (k - 1) + r
            ki, j = divmod(r, n_mid)
            ecp_idx[lane] = ki * n + 1 + j
            dir_idx[lane] = 3 + ki * 3 + c
            scl_idx[lane] = (k - 1) + r
            off_idx[lane] = 3 * (k - 1) + r * 3 + c
    for (c, lane0, off, ln) in layout.half_chunks():
        base = c * layout.nb_p if c < 3 else 3 * layout.nb_p
        for i in range(ln):
            set_half(base + lane0 + i, off + i)
    return ecp_idx, dir_idx, scl_idx, off_idx


def _unpad_index(layout: _PadLayout) -> np.ndarray:
    """Lane indices that turn a padded (m_p) vector into the flat
    [ball-x | ball-y | ball-z | half] order of length 3 n_ball + n_half."""
    nb_p, n_ball = layout.nb_p, layout.n_ball
    idx = [np.arange(c * nb_p, c * nb_p + n_ball) for c in range(3)]
    idx += [np.arange(c * nb_p + lane, c * nb_p + lane + ln)
            for (c, lane, _, ln) in layout.half_chunks()]
    return np.concatenate(idx).astype(np.int64)


def penalty_unscale_maps(structure: ProblemStructure, layout: _PadLayout,
                         f_sphere: float, f_tube: float, f_half: float):
    """Static multipliers that turn the ADMM's penalty-scaled padded system
    (``ADMMConfig.rho_*_factor`` baked into the row scales as sqrt(f)) back
    into the penalty-free (f = 1) system the plane-layout IPM works on, so
    that one assembly of G^T serves both solvers.

    Returns (lane_ratio (m_p,), ball_ratio (n_ball,), half_ratio (n_half,))
    as float32 NumPy arrays (pad lanes get ratio 1).
    """
    k = structure.n_segments
    n = structure.n_coefficients
    scl_idx = _padded_gather_maps(k, n, layout)[2]
    n_sph = k - 1
    n_ball = layout.n_ball
    n_half = layout.n_half
    inv = np.concatenate([
        np.full(n_sph, 1.0 / np.sqrt(f_sphere)),
        np.full(n_ball - n_sph, 1.0 / np.sqrt(f_tube)),
        np.full(n_half, 1.0 / np.sqrt(f_half)),
        np.ones(1)]).astype(np.float32)
    return inv[scl_idx], inv[:n_ball], inv[n_ball:n_ball + n_half]


def _padded_constraint_system(structure: ProblemStructure,
                              times: torch.Tensor, d_fixed: torch.Tensor,
                              waypoints: torch.Tensor, radii: torch.Tensor,
                              d_scale: torch.Tensor, layout: _PadLayout,
                              f_sphere: float = 1.0, f_tube: float = 1.0,
                              f_half: float = 1.0, with_factors: bool = False):
    """Equilibrated constraint system assembled directly in the stage
    kernel's padded component-plane layout.

    Sphere/tube/end-cap forms of qcqp_impl.h:358-474 with the row norms in
    closed form (sphere ``e``, tube ``|P|_F e / sqrt(3)``, half-space ``e``
    for ``e = |ecp_j * d_scale|_2``); the per-constraint Jacobians are never
    materialized and the scaled G^T lands in its final (nfd, m_p) layout in
    one write.  Pad lanes are exact zeros in gt and b.

    Args (batched): times (B, K), d_fixed (B, n_fixed, 3), waypoints
    (B, V, 3), radii (B, K, 2) per-segment (tube r1, sphere r2), d_scale
    (B, n_free).

    Returns (gt (B, nfd, m_p), b_pad (B, 1, m_p), rb (B, n_ball) scaled
    radii, sb (B, n_ball), sh (B, n_half)), all in the dtype of ``times``.
    With ``with_factors`` (``gt_assembly="kernel"``) gt is None and G^T's
    rank-1 row factors follow: (None, b_pad, rb, sb, sh, e_t (B, n_free,
    m_p), w_t (B, 3, m_p)), gt[:, p*3 + d] = e_t[:, p] * w_t[:, d].  The pad
    lanes stay exact zeros: the scale pool's zero entry lives in w_t.
    """
    k = structure.n_segments
    n = structure.n_coefficients
    if structure.dimension != 3:
        raise ValueError("Tube constraints require dimension == 3.")
    dt, dev = times.dtype, times.device
    bsz = times.shape[0]
    cp0, ecp = _control_point_maps(structure, times, d_fixed)
    n_free = ecp.shape[-1]
    n_mid = n - 2

    p_start = waypoints[:, :-1]
    p_end = waypoints[:, 1:]
    seg_vec = p_end - p_start
    seg_norm = torch.linalg.vector_norm(seg_vec, dim=-1, keepdim=True)
    nvec = seg_vec / torch.clamp(seg_norm, min=1e-12)      # (B, K, 3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    proj = eye3 - nvec[..., :, None] * nvec[..., None, :]  # (B, K, 3, 3)

    ecp_s = ecp * d_scale[:, None, None, :]                # (B, K, N, n_free)
    e_norm = torch.linalg.vector_norm(ecp_s, dim=-1)       # (B, K, N)
    proj_f = torch.linalg.matrix_norm(proj)                # (B, K) ~sqrt(2)
    mid = slice(1, n - 1)

    # Row equilibration scales times the per-family sqrt(penalty factor).
    # Python floats throughout: nothing here may promote float32 to float64.
    rs_lo, rs_hi = _row_scale_bounds(n)
    f_sphere, f_tube, f_half = (float(np.sqrt(f_sphere)),
                                float(np.sqrt(f_tube)),
                                float(np.sqrt(f_half)))
    sb_sph = f_sphere / torch.clamp(e_norm[:, :k - 1, n - 1], rs_lo, rs_hi)
    sb_tube = f_tube / torch.clamp(
        proj_f[:, :, None] * e_norm[:, :, mid] * float(1.0 / np.sqrt(3.0)),
        rs_lo, rs_hi)                                      # (B, K, M)
    sh_kj = f_half / torch.clamp(e_norm[:, :, mid], rs_lo, rs_hi)  # (B, K, M)

    # --- G^T in one write: gather + broadcast-multiply. --------------------
    # Every constraint row is ecp_s[k_m, j_m, :] (x) w_m, so
    # gt[(p, d), m] = E_sel[p, m] * W[d, m] with static lane -> source maps.
    ecp_idx, dir_idx, scl_idx, off_idx = const(
        ("gather_maps", k, n, layout),
        lambda: np.stack(_padded_gather_maps(k, n, layout)), torch.long, dev)
    dirs = torch.stack([-nvec, nvec], dim=2)               # (B, K, 2, 3)
    dir_pool = torch.cat([
        eye3.expand(bsz, 3, 3), proj.reshape(bsz, k * 3, 3),
        dirs.reshape(bsz, k * 2, 3),
        torch.zeros((bsz, 1, 3), dtype=dt, device=dev)], dim=1)
    sh = sh_kj[..., None].expand(bsz, k, n_mid, 2).reshape(bsz, -1)
    sb = torch.cat([sb_sph, sb_tube.reshape(bsz, -1)], dim=1)    # (B, n_ball)
    scl_pool = torch.cat([sb, sh, torch.zeros((bsz, 1), dtype=dt,
                                              device=dev)], dim=1)
    e_src = ecp_s.reshape(bsz, k * n, n_free).transpose(1, 2)
    w_t = (dir_pool.transpose(1, 2)[:, :, dir_idx]
           * scl_pool[:, None, scl_idx])                   # (B, 3, m_p)
    if with_factors:
        e_sel_t = e_src[:, :, ecp_idx]                     # (B, n_free, m_p)
        gt = None
    else:
        # expand_gt's products, written into G^T a few free derivatives at
        # a time: the gathered factor rows never exist whole (0.57 GB at
        # the flagship batch, beside G^T's 1.7).
        m_p = ecp_idx.shape[0]
        gt = torch.empty((bsz, n_free * 3, m_p), dtype=dt, device=dev)
        g4 = gt.view(bsz, n_free, 3, m_p)
        for p0 in range(0, n_free, _ASSEMBLY_ROWS):
            e_c = e_src[:, p0:p0 + _ASSEMBLY_ROWS][:, :, ecp_idx]
            torch.mul(e_c[:, :, None, :], w_t[:, None, :, :],
                      out=g4[:, p0:p0 + _ASSEMBLY_ROWS])
            del e_c

    # --- Offsets / radii (small tensors; same gather trick for b). ---------
    b_sph = ((cp0[:, :k - 1, n - 1, :] - waypoints[:, 1:k])
             * sb_sph[..., None])                          # (B, K-1, 3)
    b_tube = torch.einsum('bkcd,bkjd->bkjc', proj,
                          cp0[:, :, mid] - p_start[:, :, None, :]) \
        * sb_tube[..., None]                               # (B, K, M, 3)
    r_prev = torch.cat([radii[:, :1, 0], radii[:, :-1, 1]], dim=1)
    p_cap_start = p_start - nvec * r_prev[..., None]
    p_cap_end = p_end + nvec * radii[:, :, 1][..., None]
    caps = torch.stack([p_cap_start, p_cap_end], dim=2)    # (B, K, 2, 3)
    b_half = (torch.einsum('bksd,bkjd->bkjs', dirs, cp0[:, :, mid])
              - torch.einsum('bksd,bksd->bks', dirs, caps)[:, :, None, :]) \
        * sh_kj[..., None]                                 # (B, K, M, 2)
    off_pool = torch.cat([
        b_sph.reshape(bsz, -1), b_tube.reshape(bsz, -1),
        b_half.reshape(bsz, -1),
        torch.zeros((bsz, 1), dtype=dt, device=dev)], dim=1)
    b_pad = off_pool[:, off_idx][:, None, :]               # (B, 1, m_p)

    rb = torch.cat([radii[:, :k - 1, 1] * sb_sph,
                    (radii[:, :, :1].expand(bsz, k, n_mid)
                     * sb_tube).reshape(bsz, -1)], dim=1)
    if with_factors:
        return gt, b_pad, rb, sb, sh, e_sel_t, w_t
    return gt, b_pad, rb, sb, sh


class _Pre(NamedTuple):
    """Pre-stage tensors of a batch (equilibrated, padded layout)."""
    gt: Optional[torch.Tensor]  # (B, nfd, m_p); None with gt_assembly="kernel"
    b_pad: torch.Tensor        # (B, 1, m_p)
    rb: torch.Tensor           # (B, n_ball) scaled radii
    sb: torch.Tensor           # (B, n_ball)
    sh: torch.Tensor           # (B, n_half)
    p_eq: torch.Tensor         # (B, n_free, n_free) equilibrated R_pp
    q_flat: torch.Tensor       # (B, nfd)
    x_flat0: torch.Tensor      # (B, nfd)
    d_scale: torch.Tensor      # (B, n_free)
    # gt_assembly="kernel" only: G^T's rank-1 row factors, gt[:, p*3 + d] =
    # e_t[:, p] * w_t[:, d].
    e_t: Optional[torch.Tensor] = None   # (B, n_free, m_p)
    w_t: Optional[torch.Tensor] = None   # (B, 3, m_p)


def _warmstart_position_cols(structure: ProblemStructure):
    """Static (pos, rest) free-column index split for the warm start:
    pos = interior-vertex position columns, rest = the others."""
    fc = np.asarray(structure.free_cols)
    interior = (fc[:, 0] > 0) & (fc[:, 0] < structure.n_vertices - 1)
    pos_mask = interior & (fc[:, 1] == 0)
    pos = np.nonzero(pos_mask)[0].astype(np.int64)
    rest = np.nonzero(~pos_mask)[0].astype(np.int64)
    return pos, rest


def _objective_blocks(structure: ProblemStructure, d_fixed: torch.Tensor,
                      times: torch.Tensor, config: ADMMConfig,
                      x0: Optional[torch.Tensor],
                      warmstart_positions: Optional[torch.Tensor] = None):
    """Equilibrated objective (p_eq/q_eq/d_scale) + scaled warm start.

    x0: (B, n_free, D) free derivatives to start from, or None.
    warmstart_positions: (B, V-2, D) interior waypoint positions.  When
    given (and x0 is None), the position-constrained warm start is computed
    on the free-structure R blocks assembled here: pin the interior-position
    free columns to the waypoints and solve the remaining SPD system -- the
    equality-constrained minimum the reference's
    computeInitialSolutionWithPositionConstraints obtains via a separate
    standard-structure solve (nonlinear_impl.h:199-272).  With neither, the
    start is the unconstrained minimum P x = -q.
    """
    nf = structure.n_fixed
    n_free = structure.n_free
    dt, dev = times.dtype, times.device
    # Objective blocks: per-dim quadratic with the same R_pp
    # (constructRkDim, qcqp_impl.h:189-221, is block-diagonal over dims).
    r = linear.assemble_r(structure, times)
    r_pf = r[:, nf:, :nf]
    r_pp = r[:, nf:, nf:]
    q_lin = r_pf @ d_fixed                                 # 0.5 grad at x=0
    # Cost scaling: x = d_scale * x_tilde with unit-diagonal P_tilde.
    d_scale = torch.rsqrt(torch.diagonal(r_pp, dim1=-2, dim2=-1))  # (B, nfr)
    p_eq = r_pp * d_scale[:, :, None] * d_scale[:, None, :]
    q_eq = q_lin * d_scale[:, :, None]
    if x0 is not None:
        x_init = x0.to(dt) / d_scale[:, :, None]
    elif warmstart_positions is not None:
        pos_np, rest_np = _warmstart_position_cols(structure)
        pos = const((structure, "ws_pos"), lambda: pos_np, torch.long, dev)
        rest = const((structure, "ws_rest"), lambda: rest_np, torch.long, dev)
        wp = warmstart_positions.to(dt)                    # (B, n_pos, D)
        r_rr = r_pp[:, rest][:, :, rest]
        r_rp = r_pp[:, rest][:, :, pos]
        rhs = -(q_lin[:, rest] + r_rp @ wp)
        s_r = torch.rsqrt(torch.diagonal(r_rr, dim1=-2, dim2=-1))
        x_r = s_r[:, :, None] * (linalg.spd_inverse(
            r_rr * s_r[:, :, None] * s_r[:, None, :])
            @ (rhs * s_r[:, :, None]))
        x0_full = torch.zeros((times.shape[0], n_free, wp.shape[-1]),
                              dtype=dt, device=dev)
        x0_full[:, pos] = wp
        x0_full[:, rest] = x_r
        x_init = x0_full / d_scale[:, :, None]
    else:
        # Unconstrained minimum: P x = -q  (per dim).
        # (no error check: a scenario with non-finite times keeps its own
        # non-finite start and does not take the batch down)
        eye = torch.eye(n_free, dtype=dt, device=dev)
        chol, _ = torch.linalg.cholesky_ex(p_eq + config.sigma * eye,
                                           check_errors=False)
        x_init = -torch.cholesky_solve(q_eq, chol)
    return p_eq, q_eq, d_scale, x_init


def _pre(structure: ProblemStructure, d_fixed, times, waypoints, radii,
         config: ADMMConfig, x0, layout: _PadLayout,
         warmstart_positions=None) -> _Pre:
    """Batch setup for the fused stage: the equilibrated system assembled
    directly in the kernel's padded component-plane layout (G^T as its
    factors with ``gt_assembly="kernel"``)."""
    p_eq, q_eq, d_scale, x_init = _objective_blocks(
        structure, d_fixed, times, config, x0,
        warmstart_positions=warmstart_positions)
    gt, b_pad, rb, sb, sh, *factors = _padded_constraint_system(
        structure, times, d_fixed, waypoints, radii, d_scale, layout,
        config.rho_sphere_factor, config.rho_tube_factor,
        config.rho_half_factor, with_factors=config.gt_assembly == "kernel")
    bsz = times.shape[0]
    return _Pre(gt, b_pad, rb, sb, sh, p_eq, q_eq.reshape(bsz, -1),
                x_init.reshape(bsz, -1), d_scale, *factors)


def _objective_band(p_eq: torch.Tensor, blk: int, dim: int):
    """(pb_d (B, m, blk, blk), pb_u (B, m-1, blk, blk)): the band of
    kron(p_eq, I_dim) in vertex blocks of ``blk`` rows."""
    bsz, n_free, _ = p_eq.shape
    m_blk = n_free * dim // blk
    bp = blk // dim                                        # p_eq block (5)
    eye_d = torch.eye(dim, dtype=p_eq.dtype, device=p_eq.device)
    pe = p_eq.reshape(bsz, m_blk, bp, m_blk, bp)
    pe_d = torch.stack([pe[:, i, :, i, :] for i in range(m_blk)], dim=1)
    pe_u = torch.stack([pe[:, i, :, i + 1, :] for i in range(m_blk - 1)],
                       dim=1)

    def kron(a):
        return torch.einsum('smab,cd->smacbd', a, eye_d).reshape(
            bsz, a.shape[1], blk, blk).contiguous()

    return kron(pe_d), kron(pe_u)


def _kkt_band(gt: torch.Tensor, p_eq: torch.Tensor, blk: int,
              band_gram: str = "xla"):
    """Band of the stage KKT kron(p_eq, I_D) + rho G^T G + sigma I, which is
    exactly block-tridiagonal in vertex blocks (banded.kkt_tridiag_block).

    Returns (pb_d (B, m, blk, blk), pb_u (B, m-1, blk, blk)) objective
    blocks and (gd, gu) the matching blocks of the Gram G^T G.  With
    ``band_gram="xla"`` the dense Gram is a batched product outside any
    kernel (in chunks of scenarios), as in the reference's default
    configuration, and only its band is read; "pallas" / "pallas_block"
    take the band from the kernel ``gram_band``; "pallas_db" leaves gd and
    gu None: ``_kkt_band_at`` then forms each stage's whole band in
    ``gram_band_factors``.
    """
    bsz, nfd, _ = gt.shape
    m_blk = nfd // blk
    pb_d, pb_u = _objective_band(p_eq, blk, nfd // p_eq.shape[-1])
    if band_gram == "pallas_db":
        gd = gu = None
    elif band_gram in ("pallas", "pallas_block"):
        gd, gu = admm_kernel.gram_band(
            gt, blk=blk, per_block=(band_gram == "pallas_block"))
    else:
        # The dense Gram of _GRAM_SCENARIOS scenarios at a time: only its
        # band is kept (the whole is 0.45 GB at the flagship batch).
        gd = torch.empty((bsz, m_blk, blk, blk), dtype=gt.dtype,
                         device=gt.device)
        gu = torch.empty((bsz, m_blk - 1, blk, blk), dtype=gt.dtype,
                         device=gt.device)
        for b0 in range(0, bsz, _GRAM_SCENARIOS):
            g_c = gt[b0:b0 + _GRAM_SCENARIOS]
            g5 = (g_c @ g_c.transpose(-1, -2)).reshape(
                g_c.shape[0], m_blk, blk, m_blk, blk)  # (b, m, blk, m, blk)
            torch.stack([g5[:, i, :, i, :] for i in range(m_blk)], dim=1,
                        out=gd[b0:b0 + _GRAM_SCENARIOS])
            torch.stack([g5[:, i, :, i + 1, :] for i in range(m_blk - 1)],
                        dim=1, out=gu[b0:b0 + _GRAM_SCENARIOS])
            del g5
    return pb_d, pb_u, gd, gu


def _kkt_band_at(band, rho: torch.Tensor, sigma: float,
                 gt: Optional[torch.Tensor] = None, factors=None):
    """The KKT band (db (B, m, b, b), ub (B, m-1, b, b)) of one stage:
    db = pb_d + rho gd + sigma I, ub = pb_u + rho gu.  band: from
    ``_kkt_band``; rho: (B, 1, 1).  Where the band came without its Gram
    blocks, the whole band comes from a kernel: from G^T's row factors
    ``factors`` = (e_t, w_t) in ``gram_band_factors_ew`` when given
    (``gt_assembly="kernel"``), else from ``gt`` in ``gram_band_factors``
    (``band_gram="pallas_db"``)."""
    pb_d, pb_u, gd, gu = band
    blk = pb_d.shape[-1]
    if gd is None and factors is not None:
        return admm_kernel.gram_band_factors_ew(*factors, pb_d, pb_u, rho,
                                                blk=blk, sigma=sigma)
    if gd is None:
        return admm_kernel.gram_band_factors(gt, pb_d, pb_u, rho, blk=blk,
                                             sigma=sigma)
    eye_b = torch.eye(blk, dtype=pb_d.dtype, device=pb_d.device)
    rho_b = rho[:, None, :, :]                             # (B, 1, 1, 1)
    return pb_d + rho_b * gd + sigma * eye_b, pb_u + rho_b * gu


def _stage_factors(band, rho: torch.Tensor, sigma: float,
                   q_flat: torch.Tensor, gt: Optional[torch.Tensor] = None,
                   factors=None):
    """Block-LDL^T factors of one stage's KKT band and xq = -W^-1 q.

    band: (pb_d, pb_u, gd, gu) from ``_kkt_band``; rho: (B, 1, 1); gt and
    factors as ``_kkt_band_at`` takes them.  Returns (sinv (B, m, b, b), t
    (B, m-1, b, b), tt = t^T, xq (B, nfd, 1)), contiguous, as the stage
    kernel takes them.
    """
    db, ub = _kkt_band_at(band, rho, sigma, gt, factors)
    s_inv, t_fac = banded.spd_block_tridiag_factor(db, ub)
    xq = -banded.spd_block_tridiag_solve_factored(
        s_inv, t_fac, q_flat[:, :, None])
    t_st = torch.stack(t_fac[1:], dim=1)                   # (B, m-1, b, b)
    return (torch.stack(s_inv, dim=1).contiguous(), t_st.contiguous(),
            t_st.transpose(-1, -2).contiguous(), xq.contiguous())


def _rb_pad(rb: torch.Tensor, layout: _PadLayout) -> torch.Tensor:
    """(B, n_ball) scaled radii -> (B, 1, nb_p).  Tail lanes are half-space
    rows; the projection masks them off the ball path, so their radius entry
    is inert (set to 1)."""
    ones = torch.ones((rb.shape[0], layout.tail), dtype=rb.dtype,
                      device=rb.device)
    return torch.cat([rb, ones], dim=-1)[:, None, :].contiguous()


def _kron_eye(p_eq: torch.Tensor, dim: int) -> torch.Tensor:
    """kron(p_eq, I_dim) for a batch: (B, n, n) -> (B, n dim, n dim), index
    p * dim + d (the p-major order of the flattened free derivatives)."""
    bsz, n, _ = p_eq.shape
    eye_d = torch.eye(dim, dtype=p_eq.dtype, device=p_eq.device)
    return torch.einsum('bpq,cd->bpcqd', p_eq, eye_d).reshape(
        bsz, n * dim, n * dim)


class _KKT(NamedTuple):
    """What every stage of one solve reuses, on the route of
    ``_kkt_setup``: the band from ``_kkt_band`` (banded routes), or the
    dense Gram and kron(p_eq, I3) (dense route); G^T's row factors (e_t,
    w_t), contiguous, on the ``gt_assembly="kernel"`` route."""
    factored: bool
    band: Optional[tuple] = None
    gtg: Optional[torch.Tensor] = None
    p_big: Optional[torch.Tensor] = None
    factors: Optional[tuple] = None


def _kkt_setup(config: ADMMConfig, pre: _Pre, kkt_block: Optional[int]
               ) -> _KKT:
    """The route (module docstring) and its once-a-solve tensors."""
    if config.gt_assembly == "kernel":
        band = _objective_band(pre.p_eq, kkt_block, pre.w_t.shape[1])
        return _KKT(factored=True, band=band + (None, None),
                    factors=(pre.e_t.contiguous(), pre.w_t.contiguous()))
    gt = pre.gt
    if kkt_block is not None and config.kkt_inverse == "schur":
        return _KKT(factored=config.kkt_apply == "factored",
                    band=_kkt_band(gt, pre.p_eq, kkt_block,
                                   config.band_gram))
    # The dense Gram and the dense inverse stay library calls, as in the JAX
    # package, where they sit outside any kernel.
    return _KKT(factored=False, gtg=gt @ gt.transpose(-1, -2),
                p_big=_kron_eye(pre.p_eq, gt.shape[1] // pre.p_eq.shape[-1]))


def _kkt_inverse(kkt: _KKT, rho: torch.Tensor, sigma: float,
                 gt: torch.Tensor) -> torch.Tensor:
    """Dense inverse (B, nfd, nfd) of one stage's KKT matrix on a dense
    route: from the band by block-Thomas sweeps, or of kron(p_eq, I3) +
    rho G^T G + sigma I by ``linalg.spd_inverse``."""
    if kkt.band is not None:
        return banded.spd_block_tridiag_inverse_blocks(
            *_kkt_band_at(kkt.band, rho, sigma, gt))
    eye = torch.eye(gt.shape[1], dtype=gt.dtype, device=gt.device)
    return linalg.spd_inverse(kkt.p_big + rho * kkt.gtg + sigma * eye)


def _run_stages(config: ADMMConfig, pre: _Pre, layout: _PadLayout,
                kkt_block: Optional[int]):
    """Staged ADMM with the inner iterations in a fused stage kernel.

    Per stage: the KKT matrix for the current rho on the route the config
    and the structure pick (module docstring), xq = -W^-1 q, ``n_iters``
    iterations in ``admm_stage_fused_factored`` (banded + factored),
    ``admm_stage_fused_factored_ew`` (the same from G^T's row factors, with
    the band from ``gram_band_factors_ew``: ``gt_assembly="kernel"``) or
    ``admm_stage_fused`` (a dense inverse), entered with ``init_z`` on the
    first stage only; then rho is rebalanced from the residual ratio (OSQP
    section 5.2: rho <- rho sqrt(rp/rd), the scaled duals u = nu/rho rescale
    inversely).  ``kkt_block``: ``banded.kkt_tridiag_block`` of the
    structure, None where there is no block band.

    Returns (x (B, nfd), z, u, y (B, m) unpadded in the flat
    [ball-x | ball-y | ball-z | half] order, rho, prim, dual (B,));
    y = G x + b in scaled space, for the caller's violation check.
    """
    gt = None if pre.gt is None else pre.gt.contiguous()
    b_pad = pre.b_pad.contiguous()
    dt, dev = b_pad.dtype, b_pad.device
    bsz = b_pad.shape[0]
    nb_p, n_ball = layout.nb_p, layout.n_ball
    rb_pad = _rb_pad(pre.rb, layout)
    with timing.span("band"):
        kkt = _kkt_setup(config, pre._replace(gt=gt), kkt_block)
    q_col = pre.q_flat[:, :, None]

    x = pre.x_flat0[:, :, None].contiguous()               # (B, nfd, 1)
    z = u = None    # the first stage initializes z/u from x inside the kernel
    rho = torch.full((bsz, 1, 1), config.rho, dtype=dt, device=dev)
    prim_res = dual_res = y = None
    for stage in range(config.n_stages):
        kw = dict(n_iters=config.n_iters, alpha=config.alpha, nb_p=nb_p,
                  n_ball=n_ball, init_z=(stage == 0))
        if kkt.factored:
            with timing.span("factor"):
                sinv, t_st, tt_st, xq = _stage_factors(
                    kkt.band, rho, config.sigma, pre.q_flat, gt, kkt.factors)
            if kkt.factors is not None:
                stage_fn, g_src = (admm_kernel.admm_stage_fused_factored_ew,
                                   kkt.factors)
            else:
                stage_fn, g_src = admm_kernel.admm_stage_fused_factored, (gt,)
            with timing.span("stage"):
                x, z, _, u, prim, dualm, y = stage_fn(
                    rho, sinv, t_st, tt_st, *g_src, b_pad, rb_pad, xq, x, z,
                    u, **kw)
        else:
            with timing.span("factor"):
                w_inv = _kkt_inverse(kkt, rho, config.sigma, gt)
                xq = -(w_inv @ q_col)                      # (B, nfd, 1)
            with timing.span("stage"):
                x, z, _, u, prim, dualm, y = admm_kernel.admm_stage_fused(
                    rho, w_inv.contiguous(), gt, b_pad, rb_pad,
                    xq.contiguous(), x, z, u, **kw)
        prim_res = prim[:, 0, 0]
        # Padded entries of z are fixed points of the iteration (y=0, b=0),
        # so dz is zero there and the padded matvec is exact.
        dual_res = rho[:, 0, 0] * dualm[:, 0, 0]
        if stage + 1 < config.n_stages:
            ratio = torch.sqrt(torch.clamp(prim_res, min=1e-30)
                               / torch.clamp(dual_res, min=1e-30)
                               )[:, None, None]
            new_rho = torch.clamp(rho * ratio, config.rho_min, config.rho_max)
            u = (u * (rho / new_rho)).contiguous()
            rho = new_rho

    unpad = const(("unpad", layout), lambda: _unpad_index(layout),
                  torch.long, dev)
    return (x[:, :, 0], z[:, 0, unpad], u[:, 0, unpad], y[:, 0, unpad],
            rho[:, 0, 0], prim_res, dual_res)


def _post(structure: ProblemStructure, config: ADMMConfig, d_fixed, times,
          pre: _Pre, x_fin, u_fin, y_fin, rho, prim_res, dual_res
          ) -> QCQPSolution:
    """Batch outputs: violation from the scaled y, coefficients, dual
    certificates (flat [ball-x | ball-y | ball-z | half] vector order)."""
    bsz = times.shape[0]
    n_free = structure.n_free
    dim = structure.dimension
    n_ball = pre.sb.shape[1]
    # True-space violation from the scaled y: y_scaled = s * y_true.
    yb_pl = y_fin[:, :3 * n_ball].reshape(bsz, 3, n_ball)
    nb_norm = torch.linalg.vector_norm(yb_pl, dim=1)       # (B, n_ball)
    viol_ball = ((nb_norm - pre.rb) / pre.sb).amax(dim=1)
    yh = y_fin[:, 3 * n_ball:]
    viol = torch.maximum(viol_ball, (yh / pre.sh).amax(dim=1))

    ub = u_fin[:, :3 * n_ball].reshape(bsz, 3, n_ball).transpose(1, 2)
    uh = u_fin[:, 3 * n_ball:]
    converged = (prim_res < config.eps_primal) & (dual_res < config.eps_dual)
    d_free = x_fin.reshape(bsz, n_free, dim) * pre.d_scale[:, :, None]
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)
    # Dual convention: the internal objective is 0.5 x^T R_pp x +
    # (R_pf d_f)^T x; the factor 2 converts the duals to the reference's
    # J_d = x^T R x + 2 d_f^T R_fp x convention
    # (getCostAndGradientDerivative, nonlinear_impl.h:1537-1606).
    rho_c = rho[:, None]
    dual_ball = 2.0 * rho_c[:, :, None] * pre.sb[:, :, None] * ub
    dual_half = 2.0 * rho_c * pre.sh * uh
    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=dual_res,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half)


def _check_free_interior(structure: ProblemStructure) -> None:
    """ValueError unless ``structure`` is of the free-interior family that
    ``solve_qcqp_batch`` solves."""
    mask = np.asarray(structure.fixed_mask, dtype=bool)
    if (structure.dimension != 3 or structure.n_vertices < 3
            or not mask[0].all() or not mask[-1].all() or mask[1:-1].any()):
        raise ValueError(
            "solve_qcqp_batch needs the free-interior family "
            "(free_interior_mask): D = 3, start and goal fully fixed, every "
            "derivative of the interior vertices free, and at least one "
            f"interior vertex; got D = {structure.dimension}, "
            f"{structure.n_vertices} vertices, fixed_mask "
            f"{mask.astype(int).tolist()}")


def solve_qcqp_batch(structure: ProblemStructure, d_fixed, times, waypoints,
                     radii, config: ADMMConfig = ADMMConfig(),
                     x0=None, warmstart_values=None,
                     device: DeviceLike = None, _return_pre: bool = False):
    """Batched tube-constrained QCQP (all array args carry a leading batch
    axis B; tensors or array-likes).

    ``structure`` must be the free-interior family (``free_interior_mask``):
    start/goal fully fixed, interior vertex derivatives all free (at least
    one interior vertex), positions confined by the sphere/tube geometry,
    D = 3; any other structure raises ValueError.  The KKT route follows
    ``config`` and the structure (module docstring): K = 2 has no block
    band and always takes the dense route (with ``gt_assembly="kernel"``,
    which has no dense route, it raises ValueError).

    Args:
      d_fixed: (B, n_fixed, 3) fixed start/goal derivatives.
      times: (B, K) segment times.
      waypoints: (B, V, 3) vertex positions (interior positions are geometry
        for the tubes, not equality constraints).
      radii: (B, K, 2) per-segment (tube radius r1, sphere radius r2).
      x0: (B, n_free, 3) free derivatives to start from.
      warmstart_values: (B, V, N/2, 3) vertex values: start from the
        position-constrained minimum through the interior positions.
        Mutually exclusive with ``x0``; with neither, start from the
        unconstrained minimum.
      device: where to run.  ``None`` means the CUDA card (RuntimeError if
        there is none -- no silent CPU fallback); ``"cpu"`` runs the stage's
        plain PyTorch version on the host.

    The working dtype is the promotion of ``d_fixed`` and ``times``; on a
    CUDA device it must be float32 (the stage kernel's type).

    While a profiler session is active the call is the span ``qcqp``
    (``utils.timing``), tiled by ``pre``, ``band``, ``factor`` and ``stage``
    (once a stage each) and ``post``.

    Returns QCQPSolution with per-scenario convergence status; with
    ``_return_pre`` the pair (solution, ``_Pre`` bundle), so that
    ``ipm_lanes.solve_qcqp_ipm_lanes(pre=...)`` can polish from the system
    assembled here (not with ``gt_assembly="kernel"``, whose bundle has no
    G^T: ValueError).
    """
    if x0 is not None and warmstart_values is not None:
        raise ValueError("pass x0 or warmstart_values, not both")
    if _return_pre and config.gt_assembly == "kernel":
        raise ValueError("_return_pre requires gt_assembly='xla': the "
                         "lanes polish reuses the assembled G^T, which the "
                         "'kernel' assembly never forms")
    _check_free_interior(structure)
    kkt_block = banded.kkt_tridiag_block(structure)
    if config.gt_assembly == "kernel" and kkt_block is None:
        raise ValueError(
            "gt_assembly='kernel' needs the banded factored route "
            "(block-tridiagonal KKT + LDL^T factors); this structure has no "
            "block band (e.g. K = 2): use gt_assembly='xla'")
    dev = resolve_device(device)
    with timing.span("qcqp", dev):
        dtype = torch.promote_types(tensor_dtype(d_fixed),
                                    tensor_dtype(times))
        d_fixed, times, waypoints, radii = (
            as_tensor(a, dtype, dev)
            for a in (d_fixed, times, waypoints, radii))
        layout = _flagship_layout(structure)
        wp = None
        if warmstart_values is not None:
            # Interior positions come from the vertex values; start/goal
            # derivatives from d_fixed (callers pass consistent values).
            wp = as_tensor(warmstart_values, dtype, dev)[:, 1:-1, 0, :]
        if x0 is not None:
            x0 = as_tensor(x0, dtype, dev)
        with timing.span("pre"):
            pre = _pre(structure, d_fixed, times, waypoints, radii, config,
                       x0, layout, warmstart_positions=wp)
        x_fin, _, u_fin, y_fin, rho, prim_res, dual_res = _run_stages(
            config, pre, layout, kkt_block)
        with timing.span("post"):
            sol = _post(structure, config, d_fixed, times, pre, x_fin, u_fin,
                        y_fin, rho, prim_res, dual_res)
    return (sol, pre) if _return_pre else sol


def _run_stages_dense(config: ADMMConfig, g_all, b_all, p_big, q_flat,
                      x_flat0, project_flat):
    """Staged ADMM on the reference-layout system, the inner iterations as
    plain batched products: per stage a dense KKT inverse per scenario
    (``ops.linalg.spd_inverse``), ``wgt = W^-1 G^T``, then ``n_iters`` steps
    of two matvecs and a projection; rho is rebalanced between stages.

    g_all: (B, m, nfd); b_all: (B, m); p_big: (B, nfd, nfd); q_flat, x_flat0:
    (B, nfd).  Returns (x, z, u, rho (B,), prim (B,), dual (B,)).
    """
    bsz, _, nfd = g_all.shape
    dt, dev = g_all.dtype, g_all.device
    g_t = g_all.transpose(1, 2)
    gtg = g_t @ g_all
    eye_kkt = torch.eye(nfd, dtype=dt, device=dev)

    def mv(mat, vec):
        return (mat @ vec[:, :, None])[:, :, 0]

    rho = torch.full((bsz,), config.rho, dtype=dt, device=dev)
    x = x_flat0
    z = project_flat(mv(g_all, x) + b_all)
    z_prev = z
    u = torch.zeros_like(z)
    prim_res = dual_res = torch.full((bsz,), float("inf"), dtype=dt,
                                     device=dev)
    for stage in range(config.n_stages):
        kkt = p_big + rho[:, None, None] * gtg + config.sigma * eye_kkt
        w_inv = linalg.spd_inverse(kkt)                    # (B, nfd, nfd)
        wgt = w_inv @ g_t                                  # (B, nfd, m)
        xq = -mv(w_inv, q_flat)
        y = None
        for _ in range(config.n_iters):
            x = xq + rho[:, None] * mv(wgt, z - u - b_all)
            y = mv(g_all, x) + b_all
            y_rel = config.alpha * y + (1 - config.alpha) * z
            z_prev = z
            z = project_flat(y_rel + u)
            u = u + y_rel - z
        if y is not None:
            prim_res = (y - z).abs().amax(dim=-1)
        dual_res = rho * mv(g_t, z - z_prev).abs().amax(dim=-1)
        if stage + 1 < config.n_stages:
            # Residual balancing (OSQP section 5.2): rho <- rho sqrt(rp/rd),
            # the scaled duals u = nu/rho rescale inversely.
            ratio = torch.sqrt(torch.clamp(prim_res, min=1e-30)
                               / torch.clamp(dual_res, min=1e-30))
            new_rho = torch.clamp(rho * ratio, config.rho_min, config.rho_max)
            u = u * (rho / new_rho)[:, None]
            rho = new_rho
    return x, z, u, rho, prim_res, dual_res


def _solve_qcqp_rows(structure: ProblemStructure, d_fixed, times, waypoints,
                     radii, config: ADMMConfig, x0=None,
                     warmstart_positions=None) -> QCQPSolution:
    """``solve_qcqp`` for a batch of scenarios: tensors of one float dtype on
    one device, each with the batch axis in front."""
    dt, dev = times.dtype, times.device
    bsz = times.shape[0]
    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim

    p_eq, q_eq, d_scale, x_init = _objective_blocks(
        structure, d_fixed, times, config, x0,
        warmstart_positions=warmstart_positions)
    p_big = _kron_eye(p_eq, dim)
    q_flat = q_eq.reshape(bsz, nfd)
    x_flat0 = x_init.reshape(bsz, nfd)

    cons = build_constraints(structure, times, d_fixed, waypoints, radii)
    gb = cons.g_ball * d_scale[:, None, None, :, None]
    gh = cons.g_half * d_scale[:, None, :, None]

    # Row scaling: per ball block / half row to unit Frobenius scale, clamped
    # to _row_scale_bounds(N): constraints whose Jacobian block is (near-)
    # zero -- e.g. tube constraints on the first segment's leading control
    # points, which depend only on fixed start derivatives -- are constants,
    # and unbounded up-scaling of those rows poisons the solvers.
    rs_lo, rs_hi = _row_scale_bounds(structure.n_coefficients)
    sb = 1.0 / torch.clamp(torch.sqrt((gb ** 2).sum(dim=(2, 3, 4)) / 3.0),
                           rs_lo, rs_hi)
    sh = 1.0 / torch.clamp(torch.sqrt((gh ** 2).sum(dim=(2, 3))), rs_lo,
                           rs_hi)
    n_ball = gb.shape[1]
    n_half = gh.shape[1]
    if (config.rho_sphere_factor, config.rho_tube_factor,
            config.rho_half_factor) != (1.0, 1.0, 1.0):
        n_sph = structure.n_segments - 1
        fac_b = torch.cat([
            torch.full((n_sph,), float(np.sqrt(config.rho_sphere_factor)),
                       dtype=dt, device=dev),
            torch.full((n_ball - n_sph,),
                       float(np.sqrt(config.rho_tube_factor)), dtype=dt,
                       device=dev)])
        sb = sb * fac_b
        sh = sh * float(np.sqrt(config.rho_half_factor))
    gb = gb * sb[:, :, None, None, None]
    bb = cons.b_ball * sb[:, :, None]
    rb = cons.r_ball * sb
    gh = gh * sh[:, :, None, None]
    bh = cons.b_half * sh

    # x (n_free, D) flattens p-major (index p * dim + d); ball rows flatten
    # component-major ([all x | all y | all z]) so that the ball projection
    # is three contiguous slices.
    mb = n_ball * 3
    g_all = torch.cat([gb.transpose(1, 2).reshape(bsz, mb, nfd),
                       gh.reshape(bsz, n_half, nfd)], dim=1)   # (B, m, nfd)
    b_all = torch.cat([bb.transpose(1, 2).reshape(bsz, mb), bh], dim=1)

    def project_flat(v):
        vb = v[:, :mb].reshape(bsz, 3, n_ball)
        sq = (vb * vb).sum(dim=1)
        scale = torch.where(sq > rb * rb,
                            rb / torch.sqrt(torch.clamp(sq, min=1e-30)),
                            torch.ones_like(sq))
        return torch.cat([(vb * scale[:, None, :]).reshape(bsz, mb),
                          torch.clamp(v[:, mb:], max=0.0)], dim=1)

    x_fin, _, u_fin, rho, prim_res, dual_res = _run_stages_dense(
        config, g_all, b_all, p_big, q_flat, x_flat0, project_flat)

    ub = u_fin[:, :mb].reshape(bsz, 3, n_ball).transpose(1, 2)
    uh = u_fin[:, mb:]
    converged = (prim_res < config.eps_primal) & (dual_res < config.eps_dual)
    d_free = x_fin.reshape(bsz, n_free, dim) * d_scale[:, :, None]

    # Outputs: coefficients and the true-space violation.
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)
    viol = _true_violation(cons, d_free)

    # Original-space dual certificates: for the scaled system
    # grad f_eq + Geq^T (rho u) = 0, so unscaling gives S rho u; the factor 2
    # converts to the reference's J_d = x^T R x + 2 d_f^T R_fp x convention
    # (see ``_post``).
    dual_ball = 2.0 * rho[:, None, None] * sb[:, :, None] * ub
    dual_half = 2.0 * rho[:, None] * sh * uh
    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=dual_res,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half)


def _true_violation(cons: _ConstraintSystem, d_free: torch.Tensor):
    """(B,) largest violation of the unscaled constraints at d_free
    (B, n_free, D): ball rows |y| - r, half rows y."""
    yb = torch.einsum('bnipd,bpd->bni', cons.g_ball, d_free) + cons.b_ball
    viol_ball = (torch.linalg.vector_norm(yb, dim=-1)
                 - cons.r_ball).amax(dim=-1)
    yh = torch.einsum('bhpd,bpd->bh', cons.g_half, d_free) + cons.b_half
    return torch.maximum(viol_ball, yh.amax(dim=-1))


def _single(a, dtype, dev):
    """One scenario's array as a batch of one."""
    return as_tensor(a, dtype, dev)[None]


def _unbatch(sol):
    """A batch-of-one solution as one scenario's."""
    return type(sol)(*(None if f is None else f[0] for f in sol))


def solve_qcqp(structure: ProblemStructure, d_fixed, times, waypoints, radii,
               config: ADMMConfig = ADMMConfig(), x0=None,
               warmstart_positions=None,
               device: DeviceLike = None) -> QCQPSolution:
    """Solve one tube-constrained QCQP scenario on the reference-layout
    system (per-constraint Jacobians, dense KKT inverse): any float dtype,
    no kernel.  ``solve_qcqp_batch`` is the throughput path.

    Args as ``solve_qcqp_batch`` without the batch axis: d_fixed
    (n_fixed, 3), times (K,), waypoints (V, 3), radii (K, 2), x0
    (n_free, 3).  ``warmstart_positions`` (V-2, 3): interior waypoint
    positions for the position-constrained warm start, mutually exclusive
    with ``x0``.  The working dtype is the promotion of ``d_fixed`` and
    ``times``.  ``device``: ``None`` means the CUDA card.

    Returns a QCQPSolution without a batch axis (``infeasible`` is None).
    """
    if x0 is not None and warmstart_positions is not None:
        raise ValueError("pass x0 or warmstart_positions, not both")
    dev = resolve_device(device)
    dtype = torch.promote_types(tensor_dtype(d_fixed), tensor_dtype(times))
    opt = lambda a: None if a is None else _single(a, dtype, dev)
    return _unbatch(_solve_qcqp_rows(
        structure, _single(d_fixed, dtype, dev), _single(times, dtype, dev),
        _single(waypoints, dtype, dev), _single(radii, dtype, dev), config,
        x0=opt(x0), warmstart_positions=opt(warmstart_positions)))


def position_constrained_warmstart(free_structure: ProblemStructure,
                                   vertex_values: torch.Tensor,
                                   times: torch.Tensor,
                                   method: str = "cholesky") -> torch.Tensor:
    """x0 for the QCQP, (..., n_free, D): the position-constrained linear
    solve's endpoint derivatives, read out at the free structure's free
    columns (computeInitialSolutionWithPositionConstraints,
    nonlinear_impl.h:199-272; the derivatives are read off the compact
    solution directly, without the pseudo-inverse detour).

    vertex_values (..., V, N/2, D) and times (..., K) are tensors; the work
    runs on their device.  ``method`` as in ``linear.solve_linear``.
    """
    n = free_structure.n_coefficients
    v = free_structure.n_vertices
    std = make_structure(standard_mask(v, n), free_structure.dimension, n,
                         free_structure.derivative_to_optimize)
    d_fixed_std = linear.extract_fixed_values(std, vertex_values)
    d_free_std = linear.solve_free_derivatives(std, d_fixed_std, times,
                                               method=method)
    d_all_std = torch.cat(
        [d_fixed_std.to(d_free_std.dtype).expand(
            d_free_std.shape[:-2] + d_fixed_std.shape[-2:]), d_free_std],
        dim=-2)
    # free column (vertex, derivative) of the free structure -> its compact
    # column in the standard structure
    std_col = {tuple(c): i for i, c in enumerate(std.fixed_cols)}
    std_col.update({tuple(c): std.n_fixed + i
                    for i, c in enumerate(std.free_cols)})
    idx = const((free_structure, "warmstart_cols"), lambda: np.asarray(
        [std_col[tuple(c)] for c in free_structure.free_cols]), torch.long,
        d_all_std.device)
    return torch.index_select(d_all_std, -2, idx)
