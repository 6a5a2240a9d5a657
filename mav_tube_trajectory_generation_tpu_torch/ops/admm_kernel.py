"""The ADMM stage of the tube-constrained QCQP and the Gram band of its KKT
matrix: CUDA kernels, wrappers and plain PyTorch versions.

Replaces the Pallas TPU kernels of the JAX package's ``ops/admm_kernel.py``:

  * ``admm_stage_fused_factored`` (``_kernel_fused_factored`` +
    ``_stage_core``), one stage, per scenario:

      1. m1 = W^-1 G^T by block-Thomas sweeps over the block-LDL^T factors of
         the KKT matrix (``solver.banded.spd_block_tridiag_factor``),
      2. z = Proj(G x0 + b), u = 0 on the first stage (``init_z``), else
         z0/u0 are carried in,
      3. ``n_iters`` over-relaxed ADMM steps: v = z - u - b; x = xq + rho m1 v;
         y = G x + b; yr = alpha y + (1 - alpha) z; z+ = Proj(yr + u);
         u += yr - z+,
      4. prim = max|y - z|, dual = max|G^T' (z - z_prev)|;

  * ``admm_stage_fused`` (``_kernel_fused`` + ``_stage_core``): the same
    stage with m1 = winv G^T formed from a dense KKT inverse winv;
  * ``admm_stage`` (``_kernel``): step 3 alone from a given m1, starting at
    x = xq, z = z_prev = z0, u = u0, with no y and no dual;
  * ``gram_band`` (``_kernel_gram_band``): the block-tridiagonal band (gd,
    gu) of G^T G, and ``gram_band_factors`` (``_kernel_gram_band_factors``):
    the KKT band db = pb_d + rho gd + sigma I, ub = pb_u + rho gu;
  * ``admm_stage_fused_factored_ew`` (``_kernel_fused_factored_ew``) and
    ``gram_band_factors_ew`` (``_kernel_gram_band_factors_ew``): the factored
    stage and the KKT band with G^T given as its rank-1 row factors e
    (B, nf, m_p) and w (B, 3, m_p), ``gt[:, p*3 + d, m] = e[:, p, m] *
    w[:, d, m]`` (``expand_gt``); G^T never exists as a tensor.

Constraint lanes are ``[ball-x | ball-y | ball-z | half]``: each ball plane
is ``nb_p`` lanes whose first ``n_ball`` carry the coupled (x, y, z) ball
rows and whose tail carries packed half-space rows; the rest of the
half-space rows follow in a final plane, which may be absent
(``solver.qcqp._PadLayout``).

The kernels are ``csrc/admm_stage.cu`` (four entry points over one
iteration phase, and a second design of three of them) and
``csrc/gram_band.cu`` (three entry points), CUDA C++ for sm_90a.  What
bounds the stage on an H100: per scenario it does 2 * n_iters matvecs
against (nfd, m_p) matrices plus the m1 formation -- about 19 MFLOP at
n_iters = 48 with the factors, 32 with the dense inverse -- on 0.29-0.36 MB
of inputs, so by each input read once it is bound by float32 arithmetic.

* ``admm_stage_fused_factored``, ``admm_stage_fused`` and
  ``admm_stage_fused_factored_ew`` run, wherever a block's share fits
  (``factored_design``, ``fused_design``, ``ew_design``: the flagship and
  the K=4 shapes among them, K=2 for the dense inverse), in a cluster of two
  thread blocks a scenario, one body for the three: x = xq + rho W^-1 (G^T
  v) with the dense W^-1 in shared memory (formed once from the factors, or
  the caller's copied in), no m1, each block keeping its half of the lanes'
  G^T columns (``cluster_lane_split``) -- as stored, or for the ew entry
  point as its row factors e and w, each entry formed in registers as
  ``expand_gt`` rounds it -- for all iterations and exchanging one
  nfd-vector an iteration through distributed shared memory, in blocks of
  64-512 threads (``block_threads``).  It reads each input from device
  memory once; what bounds it is stated in its source.
  ``admm_stage_fused_factored_winv_plain``, ``admm_stage_fused_winv_plain``
  and ``admm_stage_fused_factored_ew_winv_plain`` are the three in that
  order in plain PyTorch; ``cluster_smem_bytes`` mirrors a block's shared
  memory.  The library alone chooses the design and the block size, from
  what it reads of the device.
* Their other shapes, and ``admm_stage``, run one block a scenario
  ("stream"): G^T and m1 together are 0.54 MB a scenario, more than a
  block's 227 KB of shared memory, so m1 is written once to a scratch
  tensor and both are re-read from L2 / device memory in every iteration
  (about 26 MB a scenario), which bounds them.  The ew entry points read
  each G^T entry there as the rounded float32 product of its two factor
  entries and do the arithmetic of the stream design on it, so they give
  the bits of ``gram_band_factors`` and of the stream design on the
  expanded G^T.

The Gram band reads G^T once, so it is bound by bytes (its source says
how each design meets that).  ``gram_band`` and ``gram_band_factors`` run
the "ring" design at the band block of every assembly (blk 15): a ring of
G^T slabs in shared memory fed by bulk copies, register tiles over a split
of the lanes; other blocks keep the "window" body, which ``gram_band_
factors_ew`` runs at every shape.  ``band_design`` names the design and
launch parameters a shape takes; the launchers take them from it.

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version only for CPU tensors; it never falls back from one to the other.
``launches`` counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import _build

# Number of times each wrapper has launched its CUDA kernel in this process.
launches: Dict[str, int] = {"admm_stage_fused_factored": 0,
                            "admm_stage_fused_factored_ew": 0,
                            "admm_stage_fused": 0, "admm_stage": 0,
                            "gram_band": 0, "gram_band_factors": 0,
                            "gram_band_factors_ew": 0}

# Rows of w, the G^T factor the ew kernels take (the problem's dimension).
DIMS = 3

# Threads per block of the stage kernels' stream design.
THREADS = 512

# The libraries whose C signatures are declared, by id (a variant of a
# source, put in _build._LIBS, is declared at its first use).
_configured: Dict[int, bool] = {}
# The design each stage entry point takes, by (entry, device, shapes).
_designs: Dict[tuple, str] = {}
# The entry points of the cluster design as csrc/admm_stage.cu numbers them
# (its Entry).
CLUSTER_ENTRIES = {"admm_stage_fused_factored": 0, "admm_stage_fused": 1,
                   "admm_stage_fused_factored_ew": 2}


class BandDesign(NamedTuple):
    """The design a Gram-band launch takes (``band_design``)."""
    design: str      # "ring" or "window"
    threads: int     # a block's threads (the ring: its computing warps
                     # and one producer warp)
    slots: int       # G^T slabs in the ring (window: its two slabs)
    per_block: int   # scenarios a block; 0: as many blocks as the card
                     # holds at once, each walking the scenarios
    tile: str        # a thread's tile of gd and of gu, rows x columns
    smem_bytes: int  # a block's dynamic shared memory


# The band kernels' designs as csrc/gram_band.cu numbers them, and the
# ring's tile shapes by its launcher's code.
BAND_DESIGNS = {"window": 0, "ring": 1}
RING_TILES = {"5x3": 0, "3x5": 1}
# The ring's band block, and its launch parameters (chosen by measurement
# on an H100: stage_profile.py --kernel gram_band --designs, PERF.md).
RING_BLOCK = 15
RING_THREADS = 160
RING_SLOTS = 3
RING_PER_BLOCK = 0
RING_TILE = "3x5"
# The window body's threads (one block a scenario).
WINDOW_THREADS = 256
# Dynamic shared memory a block may take on an H100.
MAX_BLOCK_SMEM = 232448

StageOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor, torch.Tensor]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _project(w: torch.Tensor, rb: torch.Tensor, nb_p: int, n_ball: int
             ) -> torch.Tensor:
    """Projection onto balls x half-lines in the padded lane layout.

    w: (B, 1, m_p), rb: (B, 1, nb_p).  Lanes < n_ball of the three ball
    planes are scaled onto the ball of radius rb; every other lane gets
    min(., 0).
    """
    wx = w[:, :, 0:nb_p]
    wy = w[:, :, nb_p:2 * nb_p]
    wz = w[:, :, 2 * nb_p:3 * nb_p]
    sq = wx * wx + wy * wy + wz * wz
    scale = torch.where(sq > rb * rb,
                        rb * torch.rsqrt(torch.clamp(sq, min=1e-30)),
                        torch.ones_like(sq))
    ball = torch.arange(nb_p, device=w.device) < n_ball           # (nb_p,)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    parts = [torch.where(ball, wx * scale, torch.minimum(wx, zero)),
             torch.where(ball, wy * scale, torch.minimum(wy, zero)),
             torch.where(ball, wz * scale, torch.minimum(wz, zero))]
    if w.shape[2] > 3 * nb_p:       # final half-space plane (may be absent)
        parts.append(torch.minimum(w[:, :, 3 * nb_p:], zero))
    return torch.cat(parts, dim=2)


def _iterate_plain(rho, solve, gt, b, rb, xq, x, z, zp, u, prim, y, *,
                   n_iters: int, alpha: float, nb_p: int, n_ball: int):
    """The iteration phase every stage shares: ``n_iters`` over-relaxed ADMM
    steps from (x, z, z_prev, u, prim, y); returns the six after them.
    ``solve(v)`` is W^-1 G^T v (B, nfd, 1) for v (B, 1, m_p), in the order
    of the stage at hand."""
    for _ in range(n_iters):
        v = z - u - b                                     # (B, 1, m_p)
        x = xq + rho * solve(v)                           # (B, nfd, 1)
        y = x.transpose(1, 2) @ gt + b
        y_rel = alpha * y + (1.0 - alpha) * z
        z_new = _project(y_rel + u, rb, nb_p, n_ball)
        u = u + y_rel - z_new
        zp, z = z, z_new
        prim = (y - z).abs().amax(dim=2, keepdim=True)    # (B, 1, 1)
    return x, z, zp, u, prim, y


def _with_m1(m1):
    """``solve`` for ``_iterate_plain`` from m1 = W^-1 G^T: (m1 v)."""
    return lambda v: m1 @ v.transpose(1, 2)


def _stage_core_plain(rho, solve, gt, b, rb, xq, x0, z0, u0, *, n_iters: int,
                      alpha: float, nb_p: int, n_ball: int, init_z: bool
                      ) -> StageOut:
    """Phases 2-4 of a fused stage (the JAX ``_stage_core``), W^-1 G^T
    applied by ``solve`` (``_iterate_plain``)."""
    y = x0.transpose(1, 2) @ gt + b                       # (B, 1, m_p)
    if init_z:
        z = _project(y, rb, nb_p, n_ball)
        u = torch.zeros_like(z)
    else:
        z, u = z0, u0
    prim = torch.full_like(rho, float("inf"))
    x, z, zp, u, prim, y = _iterate_plain(
        rho, solve, gt, b, rb, xq, x0, z, z, u, prim, y, n_iters=n_iters,
        alpha=alpha, nb_p=nb_p, n_ball=n_ball)
    gdz = gt @ (z - zp).transpose(1, 2)                   # (B, nfd, 1)
    dual = gdz.abs().amax(dim=1, keepdim=True)            # (B, 1, 1)
    return x, z, zp, u, prim, dual, y


def admm_stage_fused_factored_plain(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, gt: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """The stage in plain PyTorch (batched matmuls, a Python loop over the
    iterations); any float dtype, any device.  Same arguments and results as
    ``admm_stage_fused_factored``."""
    if n_ball < 0:
        n_ball = nb_p
    m1 = factored_solve(sinv, t, tt, gt)                  # (B, nfd, m_p)
    return _stage_core_plain(rho, _with_m1(m1), gt, b, rb, xq, x0, z0, u0,
                             n_iters=n_iters, alpha=alpha, nb_p=nb_p,
                             n_ball=n_ball, init_z=init_z)


def factored_solve(sinv: torch.Tensor, t: torch.Tensor, tt: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """W^-1 rhs (B, nfd, k) by block-Thomas sweeps over W's block-LDL^T
    factors: forward (I+L) y = rhs, diagonal z = S^-1 y, backward (I+L)^T x
    = z, block row by block row (the kernels' phase 1)."""
    m_blk, bsz = sinv.shape[1], sinv.shape[-1]
    y_p = []
    for i in range(m_blk):
        r_i = rhs[:, i * bsz:(i + 1) * bsz, :]
        if i:
            r_i = r_i - t[:, i - 1] @ y_p[i - 1]
        y_p.append(r_i)
    z_p = [sinv[:, i] @ y_p[i] for i in range(m_blk)]
    x_p = [None] * m_blk
    x_p[m_blk - 1] = z_p[m_blk - 1]
    for i in range(m_blk - 2, -1, -1):
        x_p[i] = z_p[i] - tt[:, i] @ x_p[i + 1]
    return torch.cat(x_p, dim=1)


def admm_stage_fused_factored_winv_plain(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, gt: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """``admm_stage_fused_factored`` in plain PyTorch in the order of its
    cluster design: the dense W^-1 formed once from the factors (the sweeps
    on the identity), then x = xq + rho W^-1 (G^T v) each iteration, in
    place of xq + rho (W^-1 G^T) v.  The same function; any float dtype, any
    device.  The wrapper's plain version stays the reference order
    (``admm_stage_fused_factored_plain``); this one is the float32 yardstick
    of the cluster design's rounding."""
    if n_ball < 0:
        n_ball = nb_p
    nfd = gt.shape[1]
    eye = torch.eye(nfd, dtype=gt.dtype, device=gt.device).expand(
        gt.shape[0], nfd, nfd)
    winv = factored_solve(sinv, t, tt, eye)               # (B, nfd, nfd)
    return _stage_core_plain(
        rho, lambda v: winv @ (gt @ v.transpose(1, 2)), gt, b, rb, xq, x0,
        z0, u0, n_iters=n_iters, alpha=alpha, nb_p=nb_p, n_ball=n_ball,
        init_z=init_z)


def cluster_lane_split(m_p: int, nb_p: int):
    """The lanes of each block of the cluster design (``csrc/admm_stage.cu``
    ``split_of``): [(lanes, balls)] for ranks 0 and 1, ``lanes`` the global
    lanes in the block's local order [ball-x | ball-y | ball-z | half] and
    ``balls`` the ball-plane indices j (with their rb[j]) it holds.  Rank 0
    takes the first ceil(nb_p / 2) of each ball plane and the first half
    (rounded up) of the final plane, rank 1 the rest, so that a ball triple
    (j, nb_p + j, 2 nb_p + j) lives in one block."""
    nh = m_p - 3 * nb_p
    out = []
    for rank in (0, 1):
        hb = (nb_p + 1) // 2 if rank == 0 else nb_p // 2
        j0 = 0 if rank == 0 else (nb_p + 1) // 2
        fb = (nh + 1) // 2 if rank == 0 else nh // 2
        f0 = 0 if rank == 0 else (nh + 1) // 2
        lanes = [d * nb_p + j0 + j for d in range(3) for j in range(hb)]
        lanes += [3 * nb_p + f0 + k for k in range(fb)]
        out.append((lanes, range(j0, j0 + hb)))
    return out


def expand_gt(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """G^T (B, nf * dw, m_p) from its rank-1 row factors e (B, nf, m_p) and
    w (B, dw, m_p): ``gt[:, p * dw + d, m] = e[:, p, m] * w[:, d, m]``, the
    expression ``solver.qcqp._padded_constraint_system`` assembles G^T by."""
    bsz, nf, m_p = e.shape
    return (e[:, :, None, :] * w[:, None, :, :]).reshape(
        bsz, nf * w.shape[1], m_p)


def admm_stage_fused_factored_ew_plain(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, e: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """``admm_stage_fused_factored_ew`` in plain PyTorch: G^T expanded from
    its factors, then ``admm_stage_fused_factored_plain``; any float dtype,
    any device."""
    return admm_stage_fused_factored_plain(
        rho, sinv, t, tt, expand_gt(e, w), b, rb, xq, x0, z0, u0,
        n_iters=n_iters, alpha=alpha, nb_p=nb_p, n_ball=n_ball,
        init_z=init_z)


def admm_stage_fused_factored_ew_winv_plain(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, e: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """``admm_stage_fused_factored_ew`` in plain PyTorch in the order of its
    cluster design, which forms each G^T entry from the factors rounded as
    ``expand_gt`` does and then does kernel 1's cluster arithmetic on it:
    ``admm_stage_fused_factored_winv_plain`` on the expanded G^T.  The same
    function; any float dtype, any device.  The wrapper's plain version
    stays the reference order (``admm_stage_fused_factored_ew_plain``); this
    one is the float32 yardstick of the cluster design's rounding."""
    return admm_stage_fused_factored_winv_plain(
        rho, sinv, t, tt, expand_gt(e, w), b, rb, xq, x0, z0, u0,
        n_iters=n_iters, alpha=alpha, nb_p=nb_p, n_ball=n_ball,
        init_z=init_z)


def admm_stage_fused_plain(
        rho: torch.Tensor, winv: torch.Tensor, gt: torch.Tensor,
        b: torch.Tensor, rb: torch.Tensor, xq: torch.Tensor,
        x0: torch.Tensor, z0: Optional[torch.Tensor] = None,
        u0: Optional[torch.Tensor] = None, *, n_iters: int, alpha: float,
        nb_p: int, n_ball: int = -1, init_z: bool = True) -> StageOut:
    """``admm_stage_fused`` in plain PyTorch; any float dtype, any device."""
    if n_ball < 0:
        n_ball = nb_p
    return _stage_core_plain(rho, _with_m1(winv @ gt), gt, b, rb, xq, x0, z0,
                             u0, n_iters=n_iters, alpha=alpha, nb_p=nb_p,
                             n_ball=n_ball, init_z=init_z)


def admm_stage_fused_winv_plain(
        rho: torch.Tensor, winv: torch.Tensor, gt: torch.Tensor,
        b: torch.Tensor, rb: torch.Tensor, xq: torch.Tensor,
        x0: torch.Tensor, z0: Optional[torch.Tensor] = None,
        u0: Optional[torch.Tensor] = None, *, n_iters: int, alpha: float,
        nb_p: int, n_ball: int = -1, init_z: bool = True) -> StageOut:
    """``admm_stage_fused`` in plain PyTorch in the order of its cluster
    design: x = xq + rho winv (G^T v) each iteration, winv's rows as given,
    in place of xq + rho (winv G^T) v.  The same function; any float dtype,
    any device.  The wrapper's plain version stays the reference order
    (``admm_stage_fused_plain``); this one is the float32 yardstick of the
    cluster design's rounding."""
    if n_ball < 0:
        n_ball = nb_p
    return _stage_core_plain(
        rho, lambda v: winv @ (gt @ v.transpose(1, 2)), gt, b, rb, xq, x0,
        z0, u0, n_iters=n_iters, alpha=alpha, nb_p=nb_p, n_ball=n_ball,
        init_z=init_z)


def admm_stage_plain(rho: torch.Tensor, m1: torch.Tensor, gt: torch.Tensor,
                     b: torch.Tensor, rb: torch.Tensor, xq: torch.Tensor,
                     z0: torch.Tensor, u0: torch.Tensor, *, n_iters: int,
                     alpha: float, nb_p: int, n_ball: int = -1):
    """``admm_stage`` in plain PyTorch; any float dtype, any device."""
    if n_ball < 0:
        n_ball = nb_p
    prim = torch.full_like(rho, float("inf"))
    x, z, zp, u, prim, _ = _iterate_plain(
        rho, _with_m1(m1), gt, b, rb, xq, xq, z0, z0, u0, prim, None,
        n_iters=n_iters, alpha=alpha, nb_p=nb_p, n_ball=n_ball)
    return x, z, zp, u, prim


def gram_band_plain(gt: torch.Tensor, *, blk: int, per_block: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gram_band`` in plain PyTorch (one batched product per block
    diagonal); any float dtype, any device.  ``per_block`` is accepted and
    changes nothing."""
    bsz, nfd, m_p = gt.shape
    rows = gt.reshape(bsz, nfd // blk, blk, m_p)
    gd = rows @ rows.transpose(-1, -2)
    gu = rows[:, :-1] @ rows[:, 1:].transpose(-1, -2)
    return gd, gu


def gram_band_factors_plain(gt: torch.Tensor, pb_d: torch.Tensor,
                            pb_u: torch.Tensor, rho: torch.Tensor, *,
                            blk: int, sigma: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gram_band_factors`` in plain PyTorch; any float dtype, any
    device."""
    gd, gu = gram_band_plain(gt, blk=blk)
    rho_b = rho[:, None]                                  # (B, 1, 1, 1)
    eye = torch.eye(blk, dtype=gt.dtype, device=gt.device)
    return pb_d + rho_b * gd + sigma * eye, pb_u + rho_b * gu


def gram_band_factors_ew_plain(e: torch.Tensor, w: torch.Tensor,
                               pb_d: torch.Tensor, pb_u: torch.Tensor,
                               rho: torch.Tensor, *, blk: int, sigma: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gram_band_factors_ew`` in plain PyTorch: G^T expanded from its
    factors, then ``gram_band_factors_plain``; any float dtype, any
    device."""
    return gram_band_factors_plain(expand_gt(e, w), pb_d, pb_u, rho, blk=blk,
                                   sigma=sigma)


def _library(name: str) -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load(name)
    if _configured.get(id(lib)):
        return lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "admm_stage":
        lib.admm_stage_fused_factored_launch.argtypes = (
            [ptr] * 19 + [i32] * 8 + [f32, i32, i32, ptr])
        lib.admm_stage_fused_factored_ew_launch.argtypes = (
            [ptr] * 20 + [i32] * 8 + [f32, i32, i32, ptr])
        lib.admm_stage_fused_launch.argtypes = (
            [ptr] * 17 + [i32] * 6 + [f32, i32, i32, ptr])
        lib.admm_stage_launch.argtypes = (
            [ptr] * 13 + [i32] * 6 + [f32, i32, ptr])
        lib.admm_stage_smem_bytes.argtypes = [i32] * 6
        lib.admm_stage_fused_smem_bytes.argtypes = [i32] * 4
        lib.admm_stage_iter_smem_bytes.argtypes = [i32] * 4
        lib.admm_stage_factored_design.argtypes = [i32] * 6
        lib.admm_stage_fused_design.argtypes = [i32] * 4
        lib.admm_stage_fused_factored_ew_design.argtypes = [i32] * 6
        lib.admm_stage_cluster_smem_bytes.argtypes = [i32] * 6
        lib.admm_stage_cluster_occupancy.argtypes = [i32] * 7
        lib.admm_stage_cluster_threads.argtypes = [i32] * 7
        for fn in ("admm_stage_fused_factored_launch",
                   "admm_stage_fused_factored_ew_launch",
                   "admm_stage_fused_launch", "admm_stage_launch",
                   "admm_stage_smem_bytes", "admm_stage_fused_smem_bytes",
                   "admm_stage_iter_smem_bytes", "admm_stage_factored_design",
                   "admm_stage_fused_design",
                   "admm_stage_fused_factored_ew_design",
                   "admm_stage_cluster_smem_bytes",
                   "admm_stage_cluster_occupancy",
                   "admm_stage_cluster_threads"):
            getattr(lib, fn).restype = i32
    else:
        lib.gram_band_launch.argtypes = [ptr] * 3 + [i32] * 9 + [ptr]
        lib.gram_band_factors_launch.argtypes = (
            [ptr] * 6 + [i32] * 4 + [f32] + [i32] * 5 + [ptr])
        lib.gram_band_factors_ew_launch.argtypes = (
            [ptr] * 7 + [i32] * 4 + [f32, i32, ptr])
        lib.gram_band_smem_bytes.argtypes = [i32] * 5
        lib.gram_band_ring_blocks_per_sm.argtypes = [i32] * 4
        lib.gram_band_ring_grid.argtypes = [i32] * 6
        for fn in ("gram_band_launch", "gram_band_factors_launch",
                   "gram_band_factors_ew_launch", "gram_band_smem_bytes",
                   "gram_band_ring_blocks_per_sm", "gram_band_ring_grid"):
            getattr(lib, fn).restype = i32
    _configured[id(lib)] = True
    return lib


def cluster_smem_bytes(kind: str, nfd: int, m_p: int, m_blk: int, bsz: int,
                       nb_p: int) -> int:
    """Dynamic shared memory of one block of the cluster design of stage
    entry point ``kind`` (a key of ``CLUSTER_ENTRIES``), in bytes: the
    Python mirror of ``make_cluster_layout`` in ``csrc/admm_stage.cu``
    (``chip_smoke.py``'s build phase holds the two equal).  W^-1 (nfd rows
    of round4(nfd)); the rows of G^T's source a block keeps -- nfd stored
    rows, or for the ew entry point nf = nfd / 3 rows of e and 3 of w -- of
    ldl lanes, over which the W^-1 sweeps' scratch lies where W^-1 is
    formed; the block's lane vectors; x, xq, the partials of G^T v."""
    nl = len(cluster_lane_split(m_p, nb_p)[0][0])
    ldw = round_up(nfd, 4)
    ldl = round_up(nl, 4)
    if (ldl // 4) % 2 == 0:
        ldl += 4
    rows = (nfd // DIMS + DIMS if kind == "admm_stage_fused_factored_ew"
            else nfd)
    bb = bsz * bsz
    scr = 0 if kind == "admm_stage_fused" else (
        round_up(m_blk * bb, 4) + 2 * round_up((m_blk - 1) * bb, 4)
        + 2 * bsz * round_up((nfd + 1) // 2, 4))
    floats = (nfd * ldw + max(rows * ldl, scr) + 6 * ldl
              + round_up((nb_p + 1) // 2, 4) + 3 * ldw + 4 * ldw + 32 + 4)
    return 4 * floats


def ring_ld(m_p: int) -> int:
    """Floats between two rows of a ring slab: ``round_up(m_p, 32) + 8``, a
    multiple of 8 that is 2 mod 8 in 16-byte units (csrc/gram_band.cu)."""
    return round_up(m_p, 32) + 8


def ring_smem_bytes(m_p: int, threads: int = RING_THREADS,
                    slots: int = RING_SLOTS) -> int:
    """Dynamic shared memory of a ring block: ``slots`` slabs of RING_BLOCK
    padded rows, each computing warp's partials of gd and gu (every warp but
    the producer), an mbarrier a slot."""
    bb = RING_BLOCK * RING_BLOCK
    return (4 * (slots * RING_BLOCK * ring_ld(m_p)
                 + (threads // 32 - 1) * 2 * bb) + 8 * slots)


def window_smem_bytes(m_p: int, blk: int) -> int:
    """Dynamic shared memory of a window block: two slabs of blk rows of
    m_p + 1 floats."""
    return 4 * 2 * blk * (m_p + 1)


def window_design(m_p: int, blk: int) -> BandDesign:
    """The window body's launch: one block of WINDOW_THREADS a scenario."""
    return BandDesign("window", WINDOW_THREADS, 2, 1, "1x1",
                      window_smem_bytes(m_p, blk))


def band_design(nfd: int, m_p: int, blk: int) -> BandDesign:
    """The design ``gram_band`` and ``gram_band_factors`` launch at these
    shapes: the ring wherever its tiles cover the band block (blk ==
    RING_BLOCK) and its shared memory fits a block, else the window body.
    Pure Python: the launchers take their parameters from it."""
    if nfd % blk:
        raise ValueError(f"gram band: nfd={nfd} is not a multiple of "
                         f"blk={blk}")
    ring = ring_smem_bytes(m_p)
    if blk == RING_BLOCK and ring <= MAX_BLOCK_SMEM:
        return BandDesign("ring", RING_THREADS, RING_SLOTS, RING_PER_BLOCK,
                          RING_TILE, ring)
    return window_design(m_p, blk)


def _band_params(d: BandDesign) -> Tuple[int, int, int, int, int]:
    """(design, threads, slots, per_block, tile) as the launchers take
    them."""
    return (BAND_DESIGNS[d.design], d.threads, d.slots, d.per_block,
            RING_TILES.get(d.tile, 0))


def ring_blocks_per_sm(m_p: int, d: BandDesign) -> int:
    """Blocks of the ring design ``d`` an SM of the current device holds at
    once; raises on a CUDA error."""
    n = int(_library("gram_band").gram_band_ring_blocks_per_sm(
        m_p, d.threads, d.slots, RING_TILES[d.tile]))
    if n <= 0:
        raise RuntimeError(f"gram band ring occupancy failed with CUDA "
                           f"error {-n}")
    return n


def ring_grid(batch: int, m_p: int, d: BandDesign) -> int:
    """Blocks a ring launch of ``batch`` scenarios in design ``d`` takes on
    the current device; raises on a CUDA error."""
    n = int(_library("gram_band").gram_band_ring_grid(
        batch, m_p, d.threads, d.slots, d.per_block, RING_TILES[d.tile]))
    if n <= 0:
        raise RuntimeError(f"gram band ring grid failed with CUDA error "
                           f"{-n}")
    return n


def stage_design(kind: str, nfd: int, m_p: int, m_blk: int, bsz: int,
                 nb_p: int) -> str:
    """The design stage entry point ``kind`` (a key of ``CLUSTER_ENTRIES``)
    launches at these shapes on the current CUDA device, as its launcher
    chooses it: "cluster" (two blocks a scenario, G^T's halves -- or their
    row factors -- and W^-1 in their shared memory, no m1) wherever a
    block's share fits, else "stream" (one block a scenario, m1 in a scratch
    tensor).  A choice by shape between two kernels; builds the library if
    needed.  ``m_blk`` and ``bsz`` are read where W^-1 is formed."""
    key = (kind, torch.cuda.current_device(), nfd, m_p, m_blk, bsz, nb_p)
    if key not in _designs:
        lib = _library("admm_stage")
        if kind == "admm_stage_fused":
            fits = lib.admm_stage_fused_design(nfd, m_p, nb_p, THREADS)
        elif kind == "admm_stage_fused_factored_ew":
            fits = lib.admm_stage_fused_factored_ew_design(
                nfd, m_p, m_blk, bsz, nb_p, THREADS)
        else:
            fits = lib.admm_stage_factored_design(nfd, m_p, m_blk, bsz, nb_p,
                                                  THREADS)
        _designs[key] = "cluster" if fits else "stream"
    return _designs[key]


def factored_design(nfd: int, m_p: int, m_blk: int, bsz: int,
                    nb_p: int) -> str:
    """The design ``admm_stage_fused_factored`` launches (``stage_design``)."""
    return stage_design("admm_stage_fused_factored", nfd, m_p, m_blk, bsz,
                        nb_p)


def fused_design(nfd: int, m_p: int, nb_p: int) -> str:
    """The design ``admm_stage_fused`` launches (``stage_design``)."""
    return stage_design("admm_stage_fused", nfd, m_p, 0, 0, nb_p)


def ew_design(nfd: int, m_p: int, m_blk: int, bsz: int, nb_p: int) -> str:
    """The design ``admm_stage_fused_factored_ew`` launches
    (``stage_design``)."""
    return stage_design("admm_stage_fused_factored_ew", nfd, m_p, m_blk, bsz,
                        nb_p)


def cluster_occupancy(nfd: int, m_p: int, m_blk: int, bsz: int, nb_p: int,
                      kind: str = "admm_stage_fused_factored") -> int:
    """Clusters of ``kind``'s cluster design the current device holds at
    once at the block size it takes there (``cudaOccupancyMaxActive-
    Clusters``); raises on a CUDA error."""
    n = int(_library("admm_stage").admm_stage_cluster_occupancy(
        CLUSTER_ENTRIES[kind], nfd, m_p, m_blk, bsz, nb_p, THREADS))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA "
                           f"error {-n}")
    return n


def block_threads(nfd: int, m_p: int, m_blk: int, bsz: int, nb_p: int,
                  kind: str = "admm_stage_fused_factored") -> int:
    """Threads a block of ``kind``'s cluster design takes at these shapes on
    the current device, as its launcher chooses them (builds the library if
    needed)."""
    return int(_library("admm_stage").admm_stage_cluster_threads(
        CLUSTER_ENTRIES[kind], nfd, m_p, m_blk, bsz, nb_p, THREADS))


def smem_bytes(nfd: int, m_p: int, m_blk: int, bsz: int, nb_p: int,
               kind: str = "admm_stage_fused_factored",
               design: Optional[str] = None) -> int:
    """Dynamic shared memory one block of a kernel of this module takes at
    these shapes, as the library computes it (builds it if needed).
    ``kind``: a key of ``launches``; for a stage entry point with a cluster
    design, ``design`` "cluster" or "stream" names either, None the one it
    takes there (``stage_design``).  ``m_blk`` and ``bsz`` are read by the
    factored stages only, ``bsz`` (the band block) by the Gram-band
    kernels, which take ``band_design``'s design (``gram_band_factors_ew``:
    the window's)."""
    if kind.startswith("gram_band"):
        d = (window_design(m_p, bsz) if kind == "gram_band_factors_ew"
             else band_design(nfd, m_p, bsz))
        return int(_library("gram_band").gram_band_smem_bytes(
            BAND_DESIGNS[d.design], m_p, bsz, d.threads, d.slots))
    lib = _library("admm_stage")
    if kind in CLUSTER_ENTRIES:
        design = design or stage_design(kind, nfd, m_p, m_blk, bsz, nb_p)
        if design == "cluster":
            return int(lib.admm_stage_cluster_smem_bytes(
                CLUSTER_ENTRIES[kind], nfd, m_p, m_blk, bsz, nb_p))
    if kind == "admm_stage":
        return int(lib.admm_stage_iter_smem_bytes(nfd, m_p, nb_p, THREADS))
    if kind == "admm_stage_fused":
        return int(lib.admm_stage_fused_smem_bytes(nfd, m_p, nb_p, THREADS))
    return int(lib.admm_stage_smem_bytes(nfd, m_p, m_blk, bsz, nb_p,
                                         THREADS))


def _check(name: str, a: torch.Tensor, shape, device) -> None:
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{a.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if a.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _device_of(gt: torch.Tensor) -> Optional[torch.device]:
    """None for a CPU tensor (the plain version runs), the CUDA device
    otherwise; raises for any other device."""
    if gt.device.type == "cpu":
        return None
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")
    return gt.device


def _check_lanes(gt: torch.Tensor, nb_p: int, n_ball: int):
    if gt.dim() != 3:
        raise ValueError(f"gt: expected (B, nfd, m_p), got {tuple(gt.shape)}")
    return _check_lane_layout(*gt.shape, nb_p, n_ball)


def _check_lane_layout(bsz_b: int, nfd: int, m_p: int, nb_p: int,
                       n_ball: int):
    if m_p % 4 or 3 * nb_p > m_p or not 0 <= n_ball <= nb_p or nfd < 1:
        raise ValueError(f"bad lane layout: m_p={m_p}, nb_p={nb_p}, "
                         f"n_ball={n_ball}")
    return bsz_b, nfd, m_p


def _factor_shape(e: torch.Tensor, w: torch.Tensor):
    """(B, nfd, m_p) of the G^T that e (B, nf, m_p) and w (B, 3, m_p)
    factor; raises on other shapes (the kernels take three dimensions)."""
    if (e.dim() != 3 or w.dim() != 3 or w.shape[0] != e.shape[0]
            or w.shape[1] != DIMS or w.shape[2] != e.shape[2]):
        raise ValueError(f"G^T factors: expected e (B, nf, m_p) and w (B, "
                         f"{DIMS}, m_p), got {tuple(e.shape)} and "
                         f"{tuple(w.shape)}")
    return e.shape[0], e.shape[1] * DIMS, e.shape[2]


def _check_stage_vectors(b, rb, xq, x0, z0, u0, init_z, bsz_b, nfd, m_p,
                         nb_p, dev) -> None:
    _check("b", b, (bsz_b, 1, m_p), dev)
    _check("rb", rb, (bsz_b, 1, nb_p), dev)
    _check("xq", xq, (bsz_b, nfd, 1), dev)
    if x0 is not None:
        _check("x0", x0, (bsz_b, nfd, 1), dev)
    if not init_z:
        _check("z0", z0, (bsz_b, 1, m_p), dev)
        _check("u0", u0, (bsz_b, 1, m_p), dev)


def _raise_on(err: int, name: str, **shapes) -> None:
    if err != 0:
        desc = ", ".join(f"{k}={v}" for k, v in shapes.items())
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} ({desc})")


def _stage_outputs(bsz_b: int, nfd: int, m_p: int, dev, with_y: bool):
    f32 = torch.float32
    x = torch.empty((bsz_b, nfd, 1), dtype=f32, device=dev)
    lanes = [torch.empty((bsz_b, 1, m_p), dtype=f32, device=dev)
             for _ in range(4 if with_y else 3)]
    scalars = [torch.empty((bsz_b, 1, 1), dtype=f32, device=dev)
               for _ in range(2 if with_y else 1)]
    return x, lanes, scalars


def admm_stage_fused_factored(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, gt: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """One fused ADMM stage from block-LDL^T KKT factors, for a flat batch.

    Args:
      rho: (B, 1, 1).  sinv: (B, m, bs, bs) pivot-block inverses.
      t / tt: (B, m-1, bs, bs) subdiagonal factors T_i and their transposes.
      gt: (B, nfd, m_p) with nfd = m * bs.  b: (B, 1, m_p).
      rb: (B, 1, nb_p).  xq / x0: (B, nfd, 1).
      z0 / u0: (B, 1, m_p), needed when ``init_z`` is False.
      n_ball: lanes < n_ball of each ball plane are ball rows (default: the
        whole plane).

    Returns (x (B, nfd, 1), z, z_prev, u (B, 1, m_p), prim (B, 1, 1),
    dual_matvec_max (B, 1, 1) -- multiply by rho for the dual residual --,
    y (B, 1, m_p) = G x + b).

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``factored_design`` names for these shapes; CPU tensors through the
    plain version (the reference order).  Anything the kernel does not take
    raises.
    """
    if n_ball < 0:
        n_ball = nb_p
    if not init_z and (z0 is None or u0 is None):
        raise ValueError("init_z=False needs z0 and u0")
    dev = _device_of(gt)
    if dev is None:
        return admm_stage_fused_factored_plain(
            rho, sinv, t, tt, gt, b, rb, xq, x0, z0, u0, n_iters=n_iters,
            alpha=alpha, nb_p=nb_p, n_ball=n_ball, init_z=init_z)

    bsz_b, nfd, m_p = _check_lanes(gt, nb_p, n_ball)
    if sinv.dim() != 4:
        raise ValueError("sinv: expected (B, m, bs, bs)")
    m_blk, bsz = sinv.shape[1], sinv.shape[-1]
    if m_blk * bsz != nfd:
        raise ValueError(f"nfd={nfd} is not m*bs = {m_blk}*{bsz}")
    _check("rho", rho, (bsz_b, 1, 1), dev)
    _check("sinv", sinv, (bsz_b, m_blk, bsz, bsz), dev)
    _check("t", t, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("tt", tt, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    _check_stage_vectors(b, rb, xq, x0, z0, u0, init_z, bsz_b, nfd, m_p,
                         nb_p, dev)

    lib = _library("admm_stage")
    x, (z, zp, u, y), (prim, dual) = _stage_outputs(bsz_b, nfd, m_p, dev,
                                                    True)
    with torch.cuda.device(dev):
        # Scratch for W^-1 G^T, on the stream design only.  It is released
        # when this function returns, while the kernel may still run: safe,
        # because PyTorch's allocator hands the block out again only to work
        # queued later on the same stream.
        m1 = (None if factored_design(nfd, m_p, m_blk, bsz, nb_p) == "cluster"
              else torch.empty_like(gt))
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.admm_stage_fused_factored_launch(
            rho.data_ptr(), sinv.data_ptr(), t.data_ptr(), tt.data_ptr(),
            gt.data_ptr(), b.data_ptr(), rb.data_ptr(), xq.data_ptr(),
            x0.data_ptr(),
            None if init_z else z0.data_ptr(),
            None if init_z else u0.data_ptr(),
            None if m1 is None else m1.data_ptr(), x.data_ptr(),
            z.data_ptr(), zp.data_ptr(),
            u.data_ptr(), prim.data_ptr(), dual.data_ptr(), y.data_ptr(),
            bsz_b, nfd, m_p, m_blk, bsz, nb_p, n_ball, int(n_iters),
            float(alpha), int(bool(init_z)), THREADS, stream)
    _raise_on(err, "admm_stage_fused_factored", B=bsz_b, nfd=nfd, m_p=m_p,
              m=m_blk, bs=bsz)
    launches["admm_stage_fused_factored"] += 1
    return x, z, zp, u, prim, dual, y


def admm_stage_fused_factored_ew(
        rho: torch.Tensor, sinv: torch.Tensor, t: torch.Tensor,
        tt: torch.Tensor, e: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        rb: torch.Tensor, xq: torch.Tensor, x0: torch.Tensor,
        z0: Optional[torch.Tensor] = None, u0: Optional[torch.Tensor] = None,
        *, n_iters: int, alpha: float, nb_p: int, n_ball: int = -1,
        init_z: bool = True) -> StageOut:
    """``admm_stage_fused_factored`` with G^T given as its rank-1 row factors
    e (B, nf, m_p) and w (B, 3, m_p), ``gt[:, p*3 + d] = e[:, p] * w[:, d]``
    (``expand_gt``); the other arguments and the seven outputs as there.

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``ew_design`` names for these shapes; CPU tensors through the plain
    version (the reference order).  Anything the kernel does not take
    raises.
    """
    if n_ball < 0:
        n_ball = nb_p
    if not init_z and (z0 is None or u0 is None):
        raise ValueError("init_z=False needs z0 and u0")
    dev = _device_of(e)
    if dev is None:
        return admm_stage_fused_factored_ew_plain(
            rho, sinv, t, tt, e, w, b, rb, xq, x0, z0, u0, n_iters=n_iters,
            alpha=alpha, nb_p=nb_p, n_ball=n_ball, init_z=init_z)

    bsz_b, nfd, m_p = _check_lane_layout(*_factor_shape(e, w), nb_p, n_ball)
    if sinv.dim() != 4:
        raise ValueError("sinv: expected (B, m, bs, bs)")
    m_blk, bsz = sinv.shape[1], sinv.shape[-1]
    if m_blk * bsz != nfd:
        raise ValueError(f"nfd={nfd} is not m*bs = {m_blk}*{bsz}")
    _check("rho", rho, (bsz_b, 1, 1), dev)
    _check("sinv", sinv, (bsz_b, m_blk, bsz, bsz), dev)
    _check("t", t, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("tt", tt, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("e", e, (bsz_b, nfd // DIMS, m_p), dev)
    _check("w", w, (bsz_b, DIMS, m_p), dev)
    _check_stage_vectors(b, rb, xq, x0, z0, u0, init_z, bsz_b, nfd, m_p,
                         nb_p, dev)

    lib = _library("admm_stage")
    x, (z, zp, u, y), (prim, dual) = _stage_outputs(bsz_b, nfd, m_p, dev,
                                                    True)
    with torch.cuda.device(dev):
        # Scratch for W^-1 G^T on the stream design only, as in the factored
        # wrapper.
        m1 = (None if ew_design(nfd, m_p, m_blk, bsz, nb_p) == "cluster"
              else torch.empty((bsz_b, nfd, m_p), dtype=torch.float32,
                               device=dev))
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.admm_stage_fused_factored_ew_launch(
            rho.data_ptr(), sinv.data_ptr(), t.data_ptr(), tt.data_ptr(),
            e.data_ptr(), w.data_ptr(), b.data_ptr(), rb.data_ptr(),
            xq.data_ptr(), x0.data_ptr(),
            None if init_z else z0.data_ptr(),
            None if init_z else u0.data_ptr(),
            None if m1 is None else m1.data_ptr(), x.data_ptr(),
            z.data_ptr(), zp.data_ptr(),
            u.data_ptr(), prim.data_ptr(), dual.data_ptr(), y.data_ptr(),
            bsz_b, nfd, m_p, m_blk, bsz, nb_p, n_ball, int(n_iters),
            float(alpha), int(bool(init_z)), THREADS, stream)
    _raise_on(err, "admm_stage_fused_factored_ew", B=bsz_b, nfd=nfd, m_p=m_p,
              m=m_blk, bs=bsz)
    launches["admm_stage_fused_factored_ew"] += 1
    return x, z, zp, u, prim, dual, y


def admm_stage_fused(rho: torch.Tensor, winv: torch.Tensor, gt: torch.Tensor,
                     b: torch.Tensor, rb: torch.Tensor, xq: torch.Tensor,
                     x0: torch.Tensor, z0: Optional[torch.Tensor] = None,
                     u0: Optional[torch.Tensor] = None, *, n_iters: int,
                     alpha: float, nb_p: int, n_ball: int = -1,
                     init_z: bool = True) -> StageOut:
    """One fused ADMM stage from a dense KKT inverse, for a flat batch: the
    phases of ``admm_stage_fused_factored`` with W^-1 = winv given (its rows
    as given; it need not be symmetric).

    Args:
      rho: (B, 1, 1).  winv: (B, nfd, nfd) KKT inverse.  gt: (B, nfd, m_p).
      b: (B, 1, m_p).  rb: (B, 1, nb_p).  xq / x0: (B, nfd, 1).
      z0 / u0: (B, 1, m_p), needed when ``init_z`` is False.

    Returns the seven outputs of ``admm_stage_fused_factored``.

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``fused_design`` names for these shapes (the stream one forms m1 = winv
    G^T in the kernel); CPU tensors through the plain version (the
    reference order).  Anything the kernel does not take raises.
    """
    if n_ball < 0:
        n_ball = nb_p
    if not init_z and (z0 is None or u0 is None):
        raise ValueError("init_z=False needs z0 and u0")
    dev = _device_of(gt)
    if dev is None:
        return admm_stage_fused_plain(
            rho, winv, gt, b, rb, xq, x0, z0, u0, n_iters=n_iters,
            alpha=alpha, nb_p=nb_p, n_ball=n_ball, init_z=init_z)

    bsz_b, nfd, m_p = _check_lanes(gt, nb_p, n_ball)
    _check("rho", rho, (bsz_b, 1, 1), dev)
    _check("winv", winv, (bsz_b, nfd, nfd), dev)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    _check_stage_vectors(b, rb, xq, x0, z0, u0, init_z, bsz_b, nfd, m_p,
                         nb_p, dev)

    lib = _library("admm_stage")
    x, (z, zp, u, y), (prim, dual) = _stage_outputs(bsz_b, nfd, m_p, dev,
                                                    True)
    with torch.cuda.device(dev):
        # scratch for winv G^T on the stream design only, as in the
        # factored wrapper
        m1 = (None if fused_design(nfd, m_p, nb_p) == "cluster"
              else torch.empty_like(gt))
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.admm_stage_fused_launch(
            rho.data_ptr(), winv.data_ptr(), gt.data_ptr(), b.data_ptr(),
            rb.data_ptr(), xq.data_ptr(), x0.data_ptr(),
            None if init_z else z0.data_ptr(),
            None if init_z else u0.data_ptr(),
            None if m1 is None else m1.data_ptr(), x.data_ptr(),
            z.data_ptr(), zp.data_ptr(),
            u.data_ptr(), prim.data_ptr(), dual.data_ptr(), y.data_ptr(),
            bsz_b, nfd, m_p, nb_p, n_ball, int(n_iters), float(alpha),
            int(bool(init_z)), THREADS, stream)
    _raise_on(err, "admm_stage_fused", B=bsz_b, nfd=nfd, m_p=m_p)
    launches["admm_stage_fused"] += 1
    return x, z, zp, u, prim, dual, y


def admm_stage(rho: torch.Tensor, m1: torch.Tensor, gt: torch.Tensor,
               b: torch.Tensor, rb: torch.Tensor, xq: torch.Tensor,
               z0: torch.Tensor, u0: torch.Tensor, *, n_iters: int,
               alpha: float, nb_p: int, n_ball: int = -1):
    """The ADMM iterations of one stage from a given m1 = W^-1 G^T.

    Args:
      rho: (B, 1, 1).  m1 / gt: (B, nfd, m_p).  b: (B, 1, m_p).
      rb: (B, 1, nb_p).  xq: (B, nfd, 1).  z0 / u0: (B, 1, m_p).

    Starts at x = xq, z = z_prev = z0, u = u0, prim = inf; returns (x
    (B, nfd, 1), z, z_prev, u (B, 1, m_p), prim (B, 1, 1)) -- with
    ``n_iters=0`` exactly (xq, z0, z0, u0, inf).

    CUDA tensors (float32, contiguous) go through the kernel; CPU tensors
    through the plain version.  Anything the kernel does not take raises.
    """
    if n_ball < 0:
        n_ball = nb_p
    dev = _device_of(gt)
    if dev is None:
        return admm_stage_plain(rho, m1, gt, b, rb, xq, z0, u0,
                                n_iters=n_iters, alpha=alpha, nb_p=nb_p,
                                n_ball=n_ball)

    bsz_b, nfd, m_p = _check_lanes(gt, nb_p, n_ball)
    _check("rho", rho, (bsz_b, 1, 1), dev)
    _check("m1", m1, (bsz_b, nfd, m_p), dev)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    _check_stage_vectors(b, rb, xq, None, z0, u0, False, bsz_b, nfd, m_p,
                         nb_p, dev)

    lib = _library("admm_stage")
    x, (z, zp, u), (prim,) = _stage_outputs(bsz_b, nfd, m_p, dev, False)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.admm_stage_launch(
            rho.data_ptr(), m1.data_ptr(), gt.data_ptr(), b.data_ptr(),
            rb.data_ptr(), xq.data_ptr(), z0.data_ptr(), u0.data_ptr(),
            x.data_ptr(), z.data_ptr(), zp.data_ptr(), u.data_ptr(),
            prim.data_ptr(), bsz_b, nfd, m_p, nb_p, n_ball, int(n_iters),
            float(alpha), THREADS, stream)
    _raise_on(err, "admm_stage", B=bsz_b, nfd=nfd, m_p=m_p)
    launches["admm_stage"] += 1
    return x, z, zp, u, prim


def _check_band(gt: torch.Tensor, blk: int):
    if gt.dim() != 3:
        raise ValueError(f"gt: expected (B, nfd, m_p), got {tuple(gt.shape)}")
    bsz_b, nfd, m_p = gt.shape
    if blk < 1 or nfd % blk or m_p % 4:
        raise ValueError(f"gram band: nfd={nfd} must be a multiple of "
                         f"blk={blk} and m_p={m_p} of 4")
    return bsz_b, nfd, m_p, nfd // blk


def gram_band(gt: torch.Tensor, *, blk: int, per_block: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-tridiagonal band of the Gram G^T G for a flat batch.

    gt: (B, nfd, m_p) with nfd = m * blk.  Returns (gd (B, m, blk, blk)
    diagonal blocks, gu (B, m-1, blk, blk) super-diagonal blocks).

    ``per_block`` chose between two Mosaic code-generation strategies of the
    TPU kernel that compute the same band; it is accepted here, and both
    values launch the same kernel.

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``band_design`` names for these shapes; CPU tensors through the plain
    version.  Anything the kernel does not take raises.
    """
    dev = _device_of(gt)
    if dev is None:
        return gram_band_plain(gt, blk=blk, per_block=per_block)
    bsz_b, nfd, m_p, m_blk = _check_band(gt, blk)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    lib = _library("gram_band")
    gd = torch.empty((bsz_b, m_blk, blk, blk), dtype=torch.float32,
                     device=dev)
    gu = torch.empty((bsz_b, m_blk - 1, blk, blk), dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        err = lib.gram_band_launch(
            gt.data_ptr(), gd.data_ptr(), gu.data_ptr(), bsz_b, nfd, m_p, blk,
            *_band_params(band_design(nfd, m_p, blk)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gram_band", B=bsz_b, nfd=nfd, m_p=m_p, blk=blk)
    launches["gram_band"] += 1
    return gd, gu


def gram_band_factors(gt: torch.Tensor, pb_d: torch.Tensor,
                      pb_u: torch.Tensor, rho: torch.Tensor, *, blk: int,
                      sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage KKT band for a flat batch: db = pb_d + rho gd + sigma I,
    ub = pb_u + rho gu, with (gd, gu) the Gram band of ``gram_band``.

    gt: (B, nfd, m_p).  pb_d: (B, m, blk, blk), pb_u: (B, m-1, blk, blk)
    objective band.  rho: (B, 1, 1).  Returns (db, ub) of the same shapes.

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``band_design`` names for these shapes; CPU tensors through the plain
    version.  Anything the kernel does not take raises.
    """
    dev = _device_of(gt)
    if dev is None:
        return gram_band_factors_plain(gt, pb_d, pb_u, rho, blk=blk,
                                       sigma=sigma)
    bsz_b, nfd, m_p, m_blk = _check_band(gt, blk)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    _check("pb_d", pb_d, (bsz_b, m_blk, blk, blk), dev)
    _check("pb_u", pb_u, (bsz_b, m_blk - 1, blk, blk), dev)
    _check("rho", rho, (bsz_b, 1, 1), dev)
    lib = _library("gram_band")
    db, ub = torch.empty_like(pb_d), torch.empty_like(pb_u)
    with torch.cuda.device(dev):
        err = lib.gram_band_factors_launch(
            gt.data_ptr(), pb_d.data_ptr(), pb_u.data_ptr(), rho.data_ptr(),
            db.data_ptr(), ub.data_ptr(), bsz_b, nfd, m_p, blk, float(sigma),
            *_band_params(band_design(nfd, m_p, blk)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gram_band_factors", B=bsz_b, nfd=nfd, m_p=m_p, blk=blk)
    launches["gram_band_factors"] += 1
    return db, ub


def gram_band_factors_ew(e: torch.Tensor, w: torch.Tensor,
                         pb_d: torch.Tensor, pb_u: torch.Tensor,
                         rho: torch.Tensor, *, blk: int, sigma: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gram_band_factors`` with G^T given as its rank-1 row factors e
    (B, nf, m_p) and w (B, 3, m_p) (``expand_gt``).

    CUDA tensors (float32, contiguous) go through the kernel, in the window
    design at every shape (``window_design``); CPU tensors through the plain
    version.  Anything the kernel does not take raises.
    """
    dev = _device_of(e)
    if dev is None:
        return gram_band_factors_ew_plain(e, w, pb_d, pb_u, rho, blk=blk,
                                          sigma=sigma)
    bsz_b, nfd, m_p = _factor_shape(e, w)
    if blk < 1 or nfd % blk or m_p % 4:
        raise ValueError(f"gram band: nfd={nfd} must be a multiple of "
                         f"blk={blk} and m_p={m_p} of 4")
    m_blk = nfd // blk
    _check("e", e, (bsz_b, nfd // DIMS, m_p), dev)
    _check("w", w, (bsz_b, DIMS, m_p), dev)
    _check("pb_d", pb_d, (bsz_b, m_blk, blk, blk), dev)
    _check("pb_u", pb_u, (bsz_b, m_blk - 1, blk, blk), dev)
    _check("rho", rho, (bsz_b, 1, 1), dev)
    lib = _library("gram_band")
    db, ub = torch.empty_like(pb_d), torch.empty_like(pb_u)
    with torch.cuda.device(dev):
        err = lib.gram_band_factors_ew_launch(
            e.data_ptr(), w.data_ptr(), pb_d.data_ptr(), pb_u.data_ptr(),
            rho.data_ptr(), db.data_ptr(), ub.data_ptr(), bsz_b, nfd, m_p,
            blk, float(sigma), WINDOW_THREADS,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gram_band_factors_ew", B=bsz_b, nfd=nfd, m_p=m_p,
              blk=blk)
    launches["gram_band_factors_ew"] += 1
    return db, ub
