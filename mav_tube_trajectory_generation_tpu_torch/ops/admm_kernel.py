"""The fused ADMM stage of the tube-constrained QCQP: CUDA kernel, wrapper
and plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel ``admm_stage_fused_factored``
(``ops/admm_kernel.py``: ``_kernel_fused_factored`` + ``_stage_core``).  One
stage, per scenario:

  1. m1 = W^-1 G^T by block-Thomas sweeps over the block-LDL^T factors of
     the KKT matrix (``solver.banded.spd_block_tridiag_factor``),
  2. z = Proj(G x0 + b), u = 0 on the first stage (``init_z``), else z0/u0
     are carried in,
  3. ``n_iters`` over-relaxed ADMM steps: v = z - u - b; x = xq + rho m1 v;
     y = G x + b; yr = alpha y + (1 - alpha) z; z+ = Proj(yr + u);
     u += yr - z+,
  4. prim = max|y - z|, dual = max|G^T' (z - z_prev)|.

Constraint lanes are ``[ball-x | ball-y | ball-z | half]``: each ball plane
is ``nb_p`` lanes whose first ``n_ball`` carry the coupled (x, y, z) ball
rows and whose tail carries packed half-space rows; the rest of the
half-space rows follow in a final plane (``solver.qcqp._PadLayout``).

The kernel is ``csrc/admm_stage.cu`` (CUDA C++, sm_90a), one thread block
per scenario.  What bounds it on an H100: per scenario the stage does 26
products of (15, 15) @ (15, 512) and 2 * n_iters matvecs against (135, 512)
matrices -- about 19 MFLOP at n_iters = 48 -- on 0.29 MB of inputs, so by
each input read once it is bound by float32 arithmetic.  But G^T and m1
together are 0.54 MB a scenario, more than the 227 KB of shared memory a
block can have, so this first design writes m1 once to a scratch tensor and
re-reads both matrices from L2 / device memory in every iteration (about
26 MB a scenario): as built it is bound by those bytes.  The vectors and
the factors stay in shared memory.  Keeping G^T in its rank-1 form, or a
thread-block cluster per scenario, would lift that and is left for later.

``admm_stage_fused_factored`` launches the kernel for CUDA tensors and runs
``admm_stage_fused_factored_plain`` only for CPU tensors; it never falls
back from one to the other.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

# Number of times the wrapper has launched the CUDA kernel in this process.
launches = 0

# Threads per block (one block per scenario).
THREADS = 512

_LIB_NAME = "admm_stage"
_configured = False

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
    m_blk, bsz = sinv.shape[1], sinv.shape[-1]

    # m1 = W^-1 G^T: forward (I+L) y = G^T, diagonal z = S^-1 y, backward
    # (I+L)^T x = z, block row by block row.
    y_p = []
    for i in range(m_blk):
        r_i = gt[:, i * bsz:(i + 1) * bsz, :]
        if i:
            r_i = r_i - t[:, i - 1] @ y_p[i - 1]
        y_p.append(r_i)
    z_p = [sinv[:, i] @ y_p[i] for i in range(m_blk)]
    x_p = [None] * m_blk
    x_p[m_blk - 1] = z_p[m_blk - 1]
    for i in range(m_blk - 2, -1, -1):
        x_p[i] = z_p[i] - tt[:, i] @ x_p[i + 1]
    m1 = torch.cat(x_p, dim=1)                            # (B, nfd, m_p)
    del y_p, z_p, x_p

    x = x0
    y = x0.transpose(1, 2) @ gt + b                       # (B, 1, m_p)
    if init_z:
        z = _project(y, rb, nb_p, n_ball)
        u = torch.zeros_like(z)
    else:
        z, u = z0, u0
    zp = z
    prim = torch.full_like(rho, float("inf"))
    for _ in range(n_iters):
        v = z - u - b                                     # (B, 1, m_p)
        x = xq + rho * (m1 @ v.transpose(1, 2))           # (B, nfd, 1)
        y = x.transpose(1, 2) @ gt + b
        y_rel = alpha * y + (1.0 - alpha) * z
        z_new = _project(y_rel + u, rb, nb_p, n_ball)
        u = u + y_rel - z_new
        zp, z = z, z_new
        prim = (y - z).abs().amax(dim=2, keepdim=True)    # (B, 1, 1)
    gdz = gt @ (z - zp).transpose(1, 2)                   # (B, nfd, 1)
    dual = gdz.abs().amax(dim=1, keepdim=True)            # (B, 1, 1)
    return x, z, zp, u, prim, dual, y


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _configured
    lib = _build.load(_LIB_NAME)
    if not _configured:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.admm_stage_fused_factored_launch.argtypes = (
            [ptr] * 19 + [i32] * 8 + [ctypes.c_float, i32, i32, ptr])
        lib.admm_stage_fused_factored_launch.restype = i32
        lib.admm_stage_smem_bytes.argtypes = [i32] * 6
        lib.admm_stage_smem_bytes.restype = i32
        _configured = True
    return lib


def smem_bytes(nfd: int, m_p: int, m_blk: int, bsz: int, nb_p: int) -> int:
    """Dynamic shared memory one block of the kernel takes at these shapes
    (builds the library if needed)."""
    return int(_library().admm_stage_smem_bytes(nfd, m_p, m_blk, bsz, nb_p,
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

    CUDA tensors (float32, contiguous) go through the kernel; CPU tensors
    through the plain version.  Anything the kernel does not take raises.
    """
    global launches
    if n_ball < 0:
        n_ball = nb_p
    if not init_z and (z0 is None or u0 is None):
        raise ValueError("init_z=False needs z0 and u0")
    if gt.device.type == "cpu":
        return admm_stage_fused_factored_plain(
            rho, sinv, t, tt, gt, b, rb, xq, x0, z0, u0, n_iters=n_iters,
            alpha=alpha, nb_p=nb_p, n_ball=n_ball, init_z=init_z)
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")

    dev = gt.device
    if gt.dim() != 3:
        raise ValueError(f"gt: expected (B, nfd, m_p), got {tuple(gt.shape)}")
    bsz_b, nfd, m_p = gt.shape
    if sinv.dim() != 4:
        raise ValueError("sinv: expected (B, m, bs, bs)")
    m_blk, bsz = sinv.shape[1], sinv.shape[-1]
    if m_blk * bsz != nfd:
        raise ValueError(f"nfd={nfd} is not m*bs = {m_blk}*{bsz}")
    if m_p % 4 or 3 * nb_p > m_p or not 0 <= n_ball <= nb_p:
        raise ValueError(f"bad lane layout: m_p={m_p}, nb_p={nb_p}, "
                         f"n_ball={n_ball}")
    _check("rho", rho, (bsz_b, 1, 1), dev)
    _check("sinv", sinv, (bsz_b, m_blk, bsz, bsz), dev)
    _check("t", t, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("tt", tt, (bsz_b, m_blk - 1, bsz, bsz), dev)
    _check("gt", gt, (bsz_b, nfd, m_p), dev)
    _check("b", b, (bsz_b, 1, m_p), dev)
    _check("rb", rb, (bsz_b, 1, nb_p), dev)
    _check("xq", xq, (bsz_b, nfd, 1), dev)
    _check("x0", x0, (bsz_b, nfd, 1), dev)
    if not init_z:
        _check("z0", z0, (bsz_b, 1, m_p), dev)
        _check("u0", u0, (bsz_b, 1, m_p), dev)

    lib = _library()
    f32 = torch.float32
    # Scratch for W^-1 G^T.  It is released when this function returns, while
    # the kernel may still run: safe, because PyTorch's allocator hands the
    # block out again only to work queued later on the same stream.
    m1 = torch.empty_like(gt)
    x = torch.empty((bsz_b, nfd, 1), dtype=f32, device=dev)
    z, zp, u, y = (torch.empty((bsz_b, 1, m_p), dtype=f32, device=dev)
                   for _ in range(4))
    prim, dual = (torch.empty((bsz_b, 1, 1), dtype=f32, device=dev)
                  for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.admm_stage_fused_factored_launch(
            rho.data_ptr(), sinv.data_ptr(), t.data_ptr(), tt.data_ptr(),
            gt.data_ptr(), b.data_ptr(), rb.data_ptr(), xq.data_ptr(),
            x0.data_ptr(),
            None if init_z else z0.data_ptr(),
            None if init_z else u0.data_ptr(),
            m1.data_ptr(), x.data_ptr(), z.data_ptr(), zp.data_ptr(),
            u.data_ptr(), prim.data_ptr(), dual.data_ptr(), y.data_ptr(),
            bsz_b, nfd, m_p, m_blk, bsz, nb_p, n_ball, int(n_iters),
            float(alpha), int(bool(init_z)), THREADS, stream)
    if err != 0:
        raise RuntimeError(
            f"admm_stage kernel launch failed with CUDA error {err} "
            f"(B={bsz_b}, nfd={nfd}, m_p={m_p}, m={m_blk}, bs={bsz})")
    launches += 1
    return x, z, zp, u, prim, dual, y
