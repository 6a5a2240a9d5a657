"""The interior-point step kernels of the plane-layout IPM: CUDA kernels,
wrappers and plain PyTorch versions.

Replaces the Pallas TPU kernels of the JAX package's ``ops/ipm_kernel.py``:

  * ``ipm_eval_step`` (``_kernel_band`` with ``band_block`` set, ``_kernel``
    with ``band_block=0``): at a point (x, s, lam) one evaluation of
    everything a Newton or snap step needs from the constraint tensor --
    y = G x + b, the constraint values c in lane layout, J^T (w r2) (or the
    clipped multiplier estimate with ``phr``), J^T (1/s) and the weighted
    Gram J^T W J + sum_i lam_i G_i^T G_i, as its block-tridiagonal band or
    whole;
  * ``ipm_pipe_step`` (``_pipe_kernel``): finish the previous Newton or snap
    step from given block-Thomas factors (column solve, G dx, step length,
    gated update, best-iterate tracking), then evaluate the next point and
    emit its Hessian band and right-hand side;
  * ``ipm_solve_fused`` (``_solve_kernel``): the whole polish in one launch
    -- the Newton steps with the band factored and solved inside the kernel
    (Jacobi equilibration, block Cholesky with floored pivots where the JAX
    kernel takes Gauss-Jordan inverses of the pivot blocks: ``PIVOT_FLOOR``),
    then the snap sweeps;
  * ``gt_matvec``: y = G v.

All of them work on the padded component-plane lane layout of
``solver.qcqp._PadLayout``: lanes ``[ball-x | ball-y | ball-z | half]``, ball
constraint i at lane ``c * nb_p + i`` of plane c, packed half-space rows in
the ball planes' tails.  Jacobian rows are never materialized: for ball i,
J_i = sum_c y_ic G_ic.  Tensors carry a flat batch axis: ``gt (B, nfd,
m_p)``, lane rows ``(B, 1, m_p)``, columns ``(B, nfd, 1)``.

The kernels are ``csrc/gt_matvec.cu``, ``csrc/ipm_eval.cu``,
``csrc/ipm_pipe.cu`` and ``csrc/ipm_solve.cu`` (CUDA C++, sm_90a; the shared
device code in ``csrc/ipm_common.cuh`` and ``csrc/ipm_cluster.cuh``).
``gt_matvec`` splits a scenario's lanes over ``matvec_chunk`` blocks.
``ipm_eval_step`` (band output and whole Gram), ``ipm_pipe_step`` and
``ipm_solve_fused`` have two designs each, chosen by shape in the launcher
(``ipm_design``): "cluster", one scenario a cluster of two blocks, each
holding its half of the lanes' G^T in shared memory (``cluster_layout``,
lanes split by ball index as ``admm_kernel.cluster_lane_split`` says), where
a block's share fits; else "stream", one block a scenario walking G^T from
L2 / device memory.  What bounds each kernel on an H100 is stated at the top
of its source.

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version only for CPU tensors; it never falls back from one to the other.
``launches`` counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from .admm_kernel import cluster_lane_split

# Number of times each wrapper has launched its CUDA kernel in this process.
launches: Dict[str, int] = {"gt_matvec": 0, "ipm_eval_step": 0,
                            "ipm_eval_step_gram": 0, "ipm_pipe_step": 0,
                            "ipm_solve_fused": 0}

# Threads per block (one block per scenario).
THREADS = 512

# Float4 columns of G^T one block of ``gt_matvec`` covers, largest first.
MATVEC_CHUNKS = (32, 16, 8)
# Blocks per SM ``matvec_chunk`` asks of the grid before it takes a larger
# chunk.
MATVEC_BLOCKS_PER_SM = 2

MODES = ("none", "newton", "snap")
# Step lengths the snap line search tries, in this order.
SNAP_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003)

# The cluster design's band tile (rows, columns) and the scalars a cluster
# combine carries (csrc/ipm_cluster.cuh: TR, TC, NXCH).
CLUSTER_TILE = (3, 5)
_NXCH = 8
# The kernels with a cluster design, by the launch counter's name: the
# prefix of their C functions (<prefix>_design, <prefix>_cluster_smem_bytes,
# <prefix>_cluster_occupancy, <prefix>_smem_bytes) and, in the same order,
# the layout kind of csrc/ipm_cluster.cuh (Kind).
CLUSTER_KERNELS = {"ipm_eval_step": "ipm_eval", "ipm_pipe_step": "ipm_pipe",
                   "ipm_eval_step_gram": "ipm_eval_gram",
                   "ipm_solve_fused": "ipm_solve"}
# The library of each prefix.
_LIBRARY_OF = {"ipm_eval_gram": "ipm_eval"}
# The largest band block a register row of the cluster design holds (BMAX).
CLUSTER_BMAX = 16

# Libraries whose C signatures are declared (by id: a variant build of a
# source may take its name's place).
_configured: Dict[int, bool] = {}
# SM count of each CUDA device a wrapper has run on.
_SMS: Dict[torch.device, int] = {}
# ipm_design's answers, by (device, kernel, shapes).
_designs: Dict[tuple, str] = {}


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def _ball_mask(nb_p: int, n_ball: int, device) -> torch.Tensor:
    return torch.arange(nb_p, device=device) < n_ball              # (nb_p,)


def _c_lanes_k(y, rb, nb_p: int, n_ball: int):
    """Constraint values in lane layout from y (..., m_p): ball values
    0.5 (|y_i|^2 - rb_i^2) replicated over the 3 planes, every other lane
    its own y."""
    m_p = y.shape[-1]
    yx = y[..., 0:nb_p]
    yy = y[..., nb_p:2 * nb_p]
    yz = y[..., 2 * nb_p:3 * nb_p]
    cb = 0.5 * (yx * yx + yy * yy + yz * yz - rb * rb)
    ball = _ball_mask(nb_p, n_ball, y.device)
    parts = [torch.where(ball, cb, yx), torch.where(ball, cb, yy),
             torch.where(ball, cb, yz)]
    if m_p > 3 * nb_p:
        parts.append(y[..., 3 * nb_p:])
    return torch.cat(parts, dim=-1)


def _jdx_lanes_k(gdx, y, nb_p: int, n_ball: int):
    """J dx in lane layout from gdx = G dx: ball lanes sum_c y_c gdx_c
    (replicated), every other lane gdx as it is."""
    m_p = y.shape[-1]
    jb = (y[..., 0:nb_p] * gdx[..., 0:nb_p]
          + y[..., nb_p:2 * nb_p] * gdx[..., nb_p:2 * nb_p]
          + y[..., 2 * nb_p:3 * nb_p] * gdx[..., 2 * nb_p:3 * nb_p])
    ball = _ball_mask(nb_p, n_ball, y.device)
    parts = [torch.where(ball, jb, gdx[..., c * nb_p:(c + 1) * nb_p])
             for c in range(3)]
    if m_p > 3 * nb_p:
        parts.append(gdx[..., 3 * nb_p:])
    return torch.cat(parts, dim=-1)


def _max_step_k(v, dv, tau: float):
    """Fraction-to-boundary step: min(1, tau * min over lanes with dv < 0 of
    -v / dv).  A NaN dv compares false, so its ratio is +inf."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(tau * ratio.amin(dim=-1, keepdim=True), max=1.0)


def _merit_k(c, s, lam, act, cw, mc: int):
    ninf = torch.full_like(c, float("-inf"))
    m1 = torch.where(act > 0, torch.clamp(c, min=0.0), ninf).amax(
        dim=-1, keepdim=True)
    m2 = torch.where(act > 0, (c + s).abs(), ninf).amax(dim=-1, keepdim=True)
    m3 = (cw * s * lam).sum(dim=-1, keepdim=True) / mc
    return m1 + m2 + m3


def _factored_col_solve(sinv, t, tt, dsc, rhs, blk: int):
    """Block-Thomas solve of one column against equilibrated factors.
    sinv: (B, m, b, b); t/tt: (B, m-1, b, b) with t[:, i-1] =
    U_{i-1}^T S_{i-1}^-1 and tt its transpose; dsc: (B, nfd, 1) Jacobi
    scale.  Returns dx (B, nfd, 1)."""
    m_blk = sinv.shape[1]
    r = rhs * dsc
    u = [None] * m_blk
    z = [None] * m_blk
    for i in range(m_blk):
        u[i] = r[:, i * blk:(i + 1) * blk, :]
        if i:
            u[i] = u[i] - t[:, i - 1] @ u[i - 1]
        z[i] = sinv[:, i] @ u[i]
    x_p = [None] * m_blk
    x_p[m_blk - 1] = z[m_blk - 1]
    for i in range(m_blk - 2, -1, -1):
        x_p[i] = z[i] - tt[:, i] @ x_p[i + 1]
    return torch.cat(x_p, dim=1) * dsc


def _pe_band_mv(pe_d, pe_u, x, blk: int):
    """Block-tridiagonal matvec kron-band(P) @ x from the stacked band
    pe_d (B, m, b, b), pe_u (B, m-1, b, b); x (B, nfd, 1)."""
    m_blk = pe_d.shape[1]
    out = []
    for i in range(m_blk):
        o = pe_d[:, i] @ x[:, i * blk:(i + 1) * blk, :]
        if i + 1 < m_blk:
            o = o + pe_u[:, i] @ x[:, (i + 1) * blk:(i + 2) * blk, :]
        if i:
            o = o + pe_u[:, i - 1].transpose(1, 2) \
                @ x[:, (i - 1) * blk:i * blk, :]
        out.append(o)
    return torch.cat(out, dim=1)


def _eval_core(gt, b, rb, x, s, lam, *, nb_p: int, n_ball: int,
               w_cap: float, phr: bool = False):
    """Shared math of the evaluation.

    gt: (B, nfd, m_p); b/s/lam: (B, 1, m_p); rb: (B, 1, nb_p);
    x: (B, nfd, 1).  Returns (y, c, jtwr2, jts, lam_ball, aj, w_aj) where the
    caller finishes gram = (gt * lam_ball) @ gt^T + (aj * w_aj) @ aj^T.

    ``phr`` switches to the clipped-penalty evaluation of the feasibility
    snap: with s fed as lam / rho, w r2 equals the multiplier estimate
    lam + rho c, clipped at zero -- jtwr2 becomes J^T max(lam + rho c, 0),
    the Gram keeps weight rho on every lam > 0 row, and the curvature weight
    is the clipped estimate instead of lam.
    """
    m_p = gt.shape[2]
    y = (gt * x).sum(dim=1, keepdim=True) + b               # (B, 1, m_p)
    yx = y[:, :, 0:nb_p]
    yy = y[:, :, nb_p:2 * nb_p]
    yz = y[:, :, 2 * nb_p:3 * nb_p]
    ball = _ball_mask(nb_p, n_ball, gt.device)
    c = _c_lanes_k(y, rb, nb_p, n_ball)

    s_safe = torch.clamp(s, min=1e-14)
    r2 = c + s
    w = torch.clamp(lam / s_safe, max=w_cap)                # (B, 1, m_p)

    # ymul: ball lanes y_ic, every other lane 1 (gt is 0 on pads anyway).
    ones = torch.ones_like(yx)
    parts_m = [torch.where(ball, yx, ones), torch.where(ball, yy, ones),
               torch.where(ball, yz, ones)]
    if m_p > 3 * nb_p:
        parts_m.append(torch.ones_like(y[:, :, 3 * nb_p:]))
    ymul = torch.cat(parts_m, dim=2)

    if phr:
        m_est = torch.clamp(w * r2, min=0.0)    # max(lam + rho c, 0) per lane
        jtwr2 = (gt * (m_est * ymul)).sum(dim=2, keepdim=True)
    else:
        m_est = None
        jtwr2 = (gt * (w * r2 * ymul)).sum(dim=2, keepdim=True)
    jts = (gt * (ymul / s_safe)).sum(dim=2, keepdim=True)

    # Curvature part sum_i lam_i sum_c G_ic G_ic^T: a lane scale of gt on
    # ball lanes only.  J-row part: aj holds J_i on plane-0 ball lanes, the
    # half rows as they are, zeros elsewhere; weight w per matching lane.
    zeros = torch.zeros_like(y)
    curv = m_est if phr else lam
    z0 = zeros[:, :, 0:nb_p]
    lam_parts = [torch.where(ball, curv[:, :, c0 * nb_p:(c0 + 1) * nb_p], z0)
                 for c0 in range(3)]
    if m_p > 3 * nb_p:
        lam_parts.append(zeros[:, :, 3 * nb_p:])
    lam_ball = torch.cat(lam_parts, dim=2)

    gtx = gt[:, :, 0:nb_p]
    gty = gt[:, :, nb_p:2 * nb_p]
    gtz = gt[:, :, 2 * nb_p:3 * nb_p]
    j_plane0 = gtx * yx + gty * yy + gtz * yz               # (B, nfd, nb_p)
    aj_parts = [torch.where(ball, j_plane0, gtx),
                torch.where(ball, torch.zeros_like(gty), gty),
                torch.where(ball, torch.zeros_like(gtz), gtz)]
    if m_p > 3 * nb_p:
        aj_parts.append(gt[:, :, 3 * nb_p:])
    aj = torch.cat(aj_parts, dim=2)                         # (B, nfd, m_p)
    w_aj_parts = [w[:, :, 0:nb_p],
                  torch.where(ball, z0, w[:, :, nb_p:2 * nb_p]),
                  torch.where(ball, z0, w[:, :, 2 * nb_p:3 * nb_p])]
    if m_p > 3 * nb_p:
        w_aj_parts.append(w[:, :, 3 * nb_p:])
    w_aj = torch.cat(w_aj_parts, dim=2)
    return y, c, jtwr2, jts, lam_ball, aj, w_aj


def _gram_band(gt, lam_ball, aj, w_aj, blk: int):
    """Band of (gt * lam_ball) @ gt^T + (aj * w_aj) @ aj^T: hd (B, nfd, blk)
    stacked diagonal blocks, hu (B, nfd - blk, blk) stacked super blocks.
    Only the band's block products are formed."""
    nfd = gt.shape[1]
    m_blk = nfd // blk
    gl = gt * lam_ball
    aw = aj * w_aj
    hd, hu = [], []
    for i in range(m_blk):
        r = slice(i * blk, (i + 1) * blk)
        hd.append(gl[:, r] @ gt[:, r].transpose(1, 2)
                  + aw[:, r] @ aj[:, r].transpose(1, 2))
        if i + 1 < m_blk:
            q = slice((i + 1) * blk, (i + 2) * blk)
            hu.append(gl[:, r] @ gt[:, q].transpose(1, 2)
                      + aw[:, r] @ aj[:, q].transpose(1, 2))
    return torch.cat(hd, dim=1), torch.cat(hu, dim=1)


def cluster_layout(kernel: str, nfd: int, m_p: int, blk: int,
                   nb_p: int) -> Dict[str, int]:
    """Shared-memory layout of one block of the cluster design of
    ``kernel`` (a name of ``CLUSTER_KERNELS``), in floats: the same function
    as ``make_cluster_layout`` in ``csrc/ipm_cluster.cuh``, with ``total``
    the block's size, ``per`` the band tiles of one block of the band, the
    halves of the band ("eh" entries) and of the rows ("rh") rank 0
    finishes, ``jr`` the Jacobian rows' room (the whole polish: the band and
    its factors, the L_i from ``lf`` on, the C_i from ``cf``) and ``gh`` one
    of the Gram rounds' receive buffers."""
    if kernel not in CLUSTER_KERNELS:
        raise ValueError(f"no cluster design for {kernel}")
    pipe, solve = kernel == "ipm_pipe_step", kernel == "ipm_solve_fused"
    gram = kernel == "ipm_eval_step_gram"
    r4 = lambda n: (n + 3) & ~3
    nh = m_p - 3 * nb_p
    hb, fb = (nb_p + 1) // 2, (nh + 1) // 2              # rank 0's share
    nl = 3 * hb + fb
    m_blk = nfd // blk
    bb = blk * blk
    tr, tc = CLUSTER_TILE
    L = dict(n4=(nl + 3) // 4, nj4=(hb + 3) // 4, ldw=r4(nfd),
             nband=nfd * blk + (nfd - blk) * blk, rh=(nfd + 1) // 2,
             per=(-(-blk // tr)) * (-(-blk // tc)))
    L["ldl"] = 4 * L["n4"] + (4 if L["n4"] % 2 == 0 else 0)
    L["ldj"] = 4 * L["nj4"] + (4 if L["nj4"] % 2 == 0 else 0)
    L["eh"] = r4((L["nband"] + 1) // 2)
    w4 = (max(hb, fb) + 3) // 4                  # G^T's share: segment tiles
    L["lds"] = 4 * w4 + (4 if w4 % 2 == 0 else 0)
    L["nseg"] = 4 if fb > 0 else 3
    L["tile"] = (nfd * L["lds"] + 31) & ~31
    L["lf"] = r4(L["nband"])             # the polish's factors, inside jr
    L["cf"] = L["lf"] + m_blk * bb
    jr = max(nfd * L["ldj"], L["nband"])
    if solve:
        jr = max(jr, L["cf"] + (m_blk - 1) * bb)
    L["gh"] = r4((bb * m_blk + 1) // 2) if gram else 0
    o = L["nseg"] * L["tile"]
    L["jr"] = r4(jr)                                        # J rows, scratch
    o += L["jr"]
    o += (14 if pipe else 12 if solve else 8) * L["ldl"]    # lane vectors
    o += 2 * 4 * L["nj4"]                                   # rb, wjb
    o += (6 if pipe or solve else 1) * L["ldw"]             # nfd vectors
    o += 4 * L["ldw"]                                       # J^T halves
    if gram:                                   # a row block's partial, and
        o += r4(bb * m_blk) + 2 * L["gh"]      # two receive buffers
    else:                                      # band (#11: or the band
        o += max(r4(L["eh"]),                  # factor's elimination rows)
                 r4(blk * (3 * blk + 2)) if solve else 0)
        o += r4(L["eh"]) if pipe or solve else 0            # pe
    o += L["ldl"] + 4 * L["nj4"]                            # row-block masks
    o += r4((m_blk * 4 * L["n4"] + 1) // 2)                 # lane lists
    o += r4((m_blk * 4 * L["nj4"] + 1) // 2) + r4(2 * m_blk)
    if solve:
        o += L["ldl"]                          # G^T's own row-block masks
    o += _NXCH * 32 + 2 * 2 * _NXCH + 4                     # reductions, bar
    L["total"] = o
    return L


def cluster_smem_bytes(kernel: str, nfd: int, m_p: int, blk: int,
                       nb_p: int) -> int:
    """Dynamic shared memory one block of ``kernel``'s cluster design takes
    at these shapes (computed here; the library's own number must agree)."""
    return 4 * cluster_layout(kernel, nfd, m_p, blk, nb_p)["total"]


def gram_row_block(nfd: int) -> int:
    """The row blocks the whole-Gram evaluation's cluster design masks its
    lanes by: the largest divisor of nfd that a band block of the design may
    be (at most ``CLUSTER_BMAX``), so 15, the vertex block, for every
    flagship-family shape (nfd = 15 (K - 1)).  Any divisor gives the same
    Gram; a lane of G^T reaches one or two vertex blocks."""
    return max(d for d in range(1, min(nfd, CLUSTER_BMAX) + 1)
               if nfd % d == 0)


def cluster_band_parts(m_p: int, nb_p: int, n_ball: int):
    """The cluster design's band in its order of sums: [(rank, lanes,
    balls)] for rank 0, then rank 1.  ``lanes``: the global lanes whose G^T
    columns the block sums with the lane weight, in its local order;
    ``balls``: the balls j < n_ball whose Jacobian rows it sums, after them.
    (The kernel walks, for each row block, only the lanes and balls that
    reach it: the terms it leaves out are exact zeros.)"""
    return [(rank, lanes, [j for j in balls if j < n_ball])
            for rank, (lanes, balls) in enumerate(
                cluster_lane_split(m_p, nb_p))]


def _gram_band_cluster(gt, lam_ball, aj, w_aj, blk: int, *, nb_p: int,
                       n_ball: int):
    """``_gram_band`` summed as the cluster design sums it: each block of
    ``cluster_band_parts`` over its lanes (the curvature term on ball lanes,
    the lane term elsewhere) and its balls' Jacobian rows, then rank 0's sum
    plus rank 1's."""
    m_p = gt.shape[2]
    dev = gt.device
    sums = [None, None]
    for rank, lanes, balls in cluster_band_parts(m_p, nb_p, n_ball):
        lb = [l for l in lanes if not (l < nb_p and l < n_ball)] + balls
        la = torch.tensor(lanes, dtype=torch.long, device=dev)
        lb = torch.tensor(lb, dtype=torch.long, device=dev)
        part = _gram_band(gt[:, :, la], lam_ball[:, :, la], aj[:, :, lb],
                          w_aj[:, :, lb], blk)
        sums[rank] = part if sums[rank] is None else tuple(
            a + b for a, b in zip(sums[rank], part))
    return tuple(a + b for a, b in zip(*sums))


def _gram_cluster(gt, lam_ball, aj, w_aj, blk: int, *, nb_p: int,
                  n_ball: int):
    """The whole weighted Gram (gt * lam_ball) @ gt^T + (aj * w_aj) @ aj^T
    summed as the cluster design sums it: each block of
    ``cluster_band_parts`` over its lanes and its balls' Jacobian rows, then
    rank 0's sum plus rank 1's; the blocks (i, j >= i) of blk rows as summed,
    the blocks below the diagonal as the transposes of those above.  (The
    kernel sums each block pair over the lanes that reach both row blocks:
    the terms it leaves out are exact zeros.)"""
    m_p, nfd, dev = gt.shape[2], gt.shape[1], gt.device
    gram = None
    for rank, lanes, balls in cluster_band_parts(m_p, nb_p, n_ball):
        lb = [l for l in lanes if not (l < nb_p and l < n_ball)] + balls
        la = torch.tensor(lanes, dtype=torch.long, device=dev)
        lb = torch.tensor(lb, dtype=torch.long, device=dev)
        g, a = gt[:, :, la], aj[:, :, lb]
        part = ((g * lam_ball[:, :, la]) @ g.transpose(1, 2)
                + (a * w_aj[:, :, lb]) @ a.transpose(1, 2))
        gram = part if gram is None else gram + part
    row_block = torch.arange(nfd, device=dev) // blk
    upper = row_block[:, None] <= row_block[None, :]
    return torch.where(upper, gram, gram.transpose(1, 2))


def ipm_eval_step_plain(gt, b, rb, x, s, lam, *, nb_p: int, n_ball: int,
                        w_cap: float = 1e10, phr: bool = False,
                        band_block: int = 0):
    """``ipm_eval_step`` in plain PyTorch; any float dtype, any device."""
    y, c, jtwr2, jts, lam_ball, aj, w_aj = _eval_core(
        gt, b, rb, x, s, lam, nb_p=nb_p, n_ball=n_ball, w_cap=w_cap, phr=phr)
    if not band_block:
        gram = (torch.einsum('bnl,bml->bnm', gt * lam_ball, gt)
                + torch.einsum('bnl,bml->bnm', aj * w_aj, aj))
        return y, c, jtwr2, jts, gram
    hd, hu = _gram_band(gt, lam_ball, aj, w_aj, band_block)
    return y, c, jtwr2, jts, hd, hu


def ipm_eval_step_cluster_plain(gt, b, rb, x, s, lam, *, nb_p: int,
                                n_ball: int, w_cap: float = 1e10,
                                phr: bool = False, band_block: int = 0):
    """``ipm_eval_step`` in plain PyTorch with the Gram summed in the
    cluster design's order: the band (``_gram_band_cluster``), or with
    ``band_block=0`` the whole Gram (``_gram_cluster``, row blocks of
    ``gram_row_block``).  The same function as ``ipm_eval_step_plain``; the
    wrapper's plain version stays the reference order.  Any float dtype, any
    device."""
    y, c, jtwr2, jts, lam_ball, aj, w_aj = _eval_core(
        gt, b, rb, x, s, lam, nb_p=nb_p, n_ball=n_ball, w_cap=w_cap, phr=phr)
    if not band_block:
        gram = _gram_cluster(gt, lam_ball, aj, w_aj,
                             gram_row_block(gt.shape[1]), nb_p=nb_p,
                             n_ball=n_ball)
        return y, c, jtwr2, jts, gram
    hd, hu = _gram_band_cluster(gt, lam_ball, aj, w_aj, band_block,
                                nb_p=nb_p, n_ball=n_ball)
    return y, c, jtwr2, jts, hd, hu


def gt_matvec_plain(gt, v):
    """``gt_matvec`` in plain PyTorch: (B, nfd, m_p) x (B, nfd, 1) ->
    (B, 1, m_p)."""
    return (gt * v).sum(dim=1, keepdim=True)


def ipm_pipe_step_plain(gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm,
                        sinv, t, tt, dsc, rhs, act, cw, *,
                        nb_p: int, n_ball: int, mc: int, sigma_min: float,
                        tau: float, alpha_max: float, w_cap: float,
                        reg: float, snap_rho: float, blk: int,
                        upd_mode: str, eval_mode: str):
    """``ipm_pipe_step`` in plain PyTorch; any float dtype, any device."""
    return _pipe_step_plain(
        gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm, sinv, t, tt, dsc,
        rhs, act, cw, nb_p=nb_p, n_ball=n_ball, mc=mc, sigma_min=sigma_min,
        tau=tau, alpha_max=alpha_max, w_cap=w_cap, reg=reg,
        snap_rho=snap_rho, blk=blk, upd_mode=upd_mode, eval_mode=eval_mode,
        band=_gram_band)


def ipm_pipe_step_cluster_plain(gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx,
                                by, bm, sinv, t, tt, dsc, rhs, act, cw, *,
                                nb_p: int, n_ball: int, mc: int,
                                sigma_min: float, tau: float,
                                alpha_max: float, w_cap: float, reg: float,
                                snap_rho: float, blk: int, upd_mode: str,
                                eval_mode: str):
    """``ipm_pipe_step_plain`` with the band summed in the cluster design's
    order (``_gram_band_cluster``).  Any float dtype, any device."""
    band = lambda *a: _gram_band_cluster(*a, nb_p=nb_p, n_ball=n_ball)
    return _pipe_step_plain(
        gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm, sinv, t, tt, dsc,
        rhs, act, cw, nb_p=nb_p, n_ball=n_ball, mc=mc, sigma_min=sigma_min,
        tau=tau, alpha_max=alpha_max, w_cap=w_cap, reg=reg,
        snap_rho=snap_rho, blk=blk, upd_mode=upd_mode, eval_mode=eval_mode,
        band=band)


def _pipe_step_plain(gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm,
                     sinv, t, tt, dsc, rhs, act, cw, *, nb_p, n_ball, mc,
                     sigma_min, tau, alpha_max, w_cap, reg, snap_rho, blk,
                     upd_mode, eval_mode, band):
    if upd_mode not in MODES or eval_mode not in MODES:
        raise ValueError(f"modes must be of {MODES}")
    dt = gt.dtype
    best_x, best_y, best_merit = bx, by, bm
    s = torch.clamp(s, min=1e-14) * act + (1.0 - act)

    if upd_mode == "newton":
        dx = _factored_col_solve(sinv, t, tt, dsc, rhs, blk)
        gdx = (gt * dx).sum(dim=1, keepdim=True)
        c = _c_lanes_k(y, rb, nb_p, n_ball)
        r2 = (c + s) * act
        w = torch.clamp(lam / s, max=w_cap)
        mu = (cw * s * lam).sum(dim=2, keepdim=True) / mc
        sig_mu = sigma_min * mu
        jdx = _jdx_lanes_k(gdx, y, nb_p, n_ball)
        ds = (-r2 - jdx) * act
        dlam = ((sig_mu - lam * s) / s - w * ds) * act
        alpha = torch.clamp(torch.minimum(_max_step_k(s, ds, tau),
                                          _max_step_k(lam, dlam, tau)),
                            max=alpha_max)
        fin = (torch.isfinite(ds) & torch.isfinite(dlam)).all(
            dim=2, keepdim=True)
        upd = (alpha > 0) & fin
        x = torch.where(upd, x + alpha * dx, x)
        s = torch.where(upd, s + alpha * ds, s)
        lam = torch.where(upd & (act > 0),
                          torch.clamp(lam + alpha * dlam, min=1e-16), lam)
        y = torch.where(upd, y + alpha * gdx, y)
        c_new = _c_lanes_k(y, rb, nb_p, n_ball)
        merit = _merit_k(c_new, s, lam, act, cw, mc)
        better = merit < best_merit
        best_x = torch.where(better, x, best_x)
        best_y = torch.where(better, y, best_y)
        best_merit = torch.where(better, merit, best_merit)
    elif upd_mode == "snap":
        dx = _factored_col_solve(sinv, t, tt, dsc, rhs, blk)
        gdx = (gt * dx).sum(dim=1, keepdim=True)

        def phi(y_a):
            v = torch.clamp(_c_lanes_k(y_a, rb, nb_p, n_ball), min=0.0)
            return (cw * v * v).sum(dim=2, keepdim=True)

        best_a = torch.zeros_like(bm)
        best_p = phi(best_y)
        for a_t in SNAP_ALPHAS:
            p_t = phi(best_y + a_t * gdx)
            better = p_t < best_p
            best_a = torch.where(better, torch.full_like(bm, a_t), best_a)
            best_p = torch.where(better, p_t, best_p)
        best_x = torch.where(best_a > 0, best_x + best_a * dx, best_x)
        best_y = torch.where(best_a > 0, best_y + best_a * gdx, best_y)

    nfd = gt.shape[1]
    bsz = gt.shape[0]
    if eval_mode == "newton":
        y_e, _, jtwr2, jts, lam_ball, aj, w_aj = _eval_core(
            gt, b, rb, x, s, lam, nb_p=nb_p, n_ball=n_ball, w_cap=w_cap,
            phr=False)
        mu = (cw * s * lam).sum(dim=2, keepdim=True) / mc
        sig_mu = sigma_min * mu
        rhs_new = -(_pe_band_mv(pe_d, pe_u, x, blk) + q + jtwr2
                    + sig_mu * jts)
        y = y_e                         # fresh matvec point
        reg_e = reg
    elif eval_mode == "snap":
        c_b = _c_lanes_k(best_y, rb, nb_p, n_ball)
        margin = 3.0 / snap_rho
        lam_s = torch.where((c_b > -margin) & (act > 0),
                            torch.full_like(c_b, 1e-6),
                            torch.zeros_like(c_b))
        s_s = lam_s / snap_rho
        _, _, jtwr2, _, lam_ball, aj, w_aj = _eval_core(
            gt, b, rb, best_x, s_s, lam_s, nb_p=nb_p, n_ball=n_ball,
            w_cap=snap_rho, phr=True)
        rhs_new = -jtwr2
        reg_e = 1e-6

    if eval_mode == "none":
        hd = torch.zeros((bsz, nfd, blk), dtype=dt, device=gt.device)
        hu = torch.zeros((bsz, nfd - blk, blk), dtype=dt, device=gt.device)
        rhs_new = torch.zeros((bsz, nfd, 1), dtype=dt, device=gt.device)
    else:
        gd, gu = band(gt, lam_ball, aj, w_aj, blk)
        eye_b = torch.eye(blk, dtype=dt, device=gt.device)
        hd = gd + pe_d.reshape(bsz, nfd, blk) \
            + reg_e * eye_b.repeat(nfd // blk, 1)
        hu = gu + pe_u.reshape(bsz, nfd - blk, blk)

    max_lam = torch.where(act > 0, lam, torch.zeros_like(lam)).amax(
        dim=2, keepdim=True)
    return (x, s, lam, y, best_x, best_y, best_merit, max_lam, hd, hu,
            rhs_new)


# The floor under the pivots of the whole polish's band factor, on the
# Jacobi-equilibrated band (unit diagonal).  In float32 a Gauss-Jordan
# inverse of each pivot block (the JAX kernel's scheme), or a Cholesky
# without a floor, loses the snap direction: the float64 solve of the same
# float32 band lowers phi in rows whose float32 direction does not
# (chip_smoke.py, factor_alone).  With the floor the factor is that of an
# SPD matrix H + E (E diagonal, E >= 0, nonzero only where a pivot falls
# under the floor; ``_band_factor_solve`` returns it with
# ``return_shift``), so the direction descends on its model.  Where no pivot
# falls under the floor the factor solves H itself, as the JAX kernel's
# does (tests/test_torch_ipm_factor.py holds the two in float64).
#
# Why 1e-4 and not less (pivot_floor_sweep.py: 1e-5, 1e-6, 1e-7 and only a
# pivot that is not positive, kernel and plain version together): the snap
# sweeps' equilibrated pivots lie under 1e-5 in nearly every row in float64
# too, so every floor float32 can resolve binds there.  At 1e-5 the
# factor-alone check loses rows that the float64 solve of the kernel's own
# band keeps; from 1e-6 down the fused polish also leaves rows above the
# strict gate that the same polish with the plain version, and the scan
# polish, clear.  chip_smoke.py reports, for each whole-polish call it
# checks, the rows in which the plain version floors a pivot, Newton steps
# and snap sweeps apart, in float32 and in float64.
PIVOT_FLOOR = 1e-4


def _floored_elimination(a, r, floor=None, raw=None):
    """L^-1 r for the lower L with L L^T = a + E, E >= 0 diagonal: Gaussian
    elimination without row swaps on [a | r] ((B, b, b), (B, b, q)), each
    pivot max(pivot, floor) (``floor`` None: ``PIVOT_FLOOR``; NaN stays NaN;
    the pivots of the Cholesky of a + E, E's diagonal the floored pivots
    less the raw ones), the eliminated rows of r over the square roots of
    their pivots: the kernel's order (csrc/ipm_solve.cu,
    band_factor_solve).  ``raw``: a list that gets the (B, b) pivots as
    they were before the floor."""
    floor = PIVOT_FLOOR if floor is None else floor
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)[:, None]
    w = torch.cat([a, r], dim=2)
    unfloored, pivots = [], []
    for k in range(n):
        pivot = w[:, k, k]
        unfloored.append(pivot)
        pivot = torch.where(pivot < floor, torch.full_like(pivot, floor),
                            pivot)
        pivots.append(pivot)
        m = torch.where(rows > k, w[:, :, k:k + 1] * (1.0 / pivot)[:, None,
                                                                   None],
                        torch.zeros_like(w[:, :, k:k + 1]))
        w = w - m * w[:, k:k + 1, :]
    if raw is not None:
        raw.append(torch.stack(unfloored, dim=1))
    rd = 1.0 / torch.sqrt(torch.stack(pivots, dim=1))
    return w[:, :, n:] * rd[:, :, None]


def _band_factor_solve(gd, gu, pe_d, pe_u, reg: float, rhs, blk: int,
                       return_shift: bool = False):
    """Equilibrated twisted block-Cholesky factor and single-column solve of
    H = blocktridiag(pe_d + gd + reg I, pe_u + gu), all blocks stacked
    (B, m, blk, blk) / (B, m-1, blk, blk); rhs (B, nfd, 1).  Returns dx
    (B, nfd, 1).

    H is Jacobi-equilibrated (D H D, D = rsqrt(max(diag H, 1e-30))) and
    factored from both ends towards the middle block c = (m - 1) // 2: the
    blocks 0 .. c-1 top-down, the blocks m-1 .. c+1 bottom-up (their
    coupling to the next block the super block transposed).  A block b with
    its neighbour p already factored: S_b = D_b - C_p^T C_p, v_b = D rhs_b -
    C_p^T z_p, and [L_b^-1 | C_b | z_b] = L_b^-1 [I | U_b | v_b] for S_b +
    E_b = L_b L_b^T (``_floored_elimination``; U_b couples b to the next
    block of its sweep); the middle block subtracts both neighbours'.  Then
    x_c = L_c^-T z_c and each half outwards, x_b = L_b^-T (z_b - C_b x_p)
    with p the block nearer the middle: the order of the whole-polish
    kernel, whose cluster runs the two sweeps on its two blocks.  The JAX
    kernel factors top-down with Gauss-Jordan inverses of the pivot blocks
    instead; see ``PIVOT_FLOOR`` for why the port does not, and why its
    floor is 1e-4.

    The factor is that of H + E: E diagonal, E >= 0, its entries the floor
    less the pivot (over D^2) where a pivot falls under ``PIVOT_FLOOR``,
    NaN where a pivot is NaN, else 0.  With ``return_shift`` the call
    returns (dx, E's diagonal (B, nfd, 1)), dx = (H + E)^-1 rhs.
    """
    m_blk = gd.shape[1]
    eye_b = torch.eye(blk, dtype=gd.dtype, device=gd.device)
    h_d = gd + pe_d + reg * eye_b
    dsc = torch.rsqrt(torch.clamp(
        torch.diagonal(h_d, dim1=-2, dim2=-1), min=1e-30))   # (B, m, blk)
    hd = h_d * dsc[:, :, :, None] * dsc[:, :, None, :]
    hu = (gu + pe_u) * dsc[:, :-1, :, None] * dsc[:, 1:, None, :]
    mid = (m_blk - 1) // 2
    linv, cpl, z, raw = {}, {}, {}, {}

    def block(b, prevs, coupling):
        s_b = hd[:, b]
        v_b = rhs[:, b * blk:(b + 1) * blk, :] * dsc[:, b, :, None]
        for p in prevs:
            s_b = s_b - cpl[p].transpose(1, 2) @ cpl[p]
            v_b = v_b - cpl[p].transpose(1, 2) @ z[p]
        parts = [eye_b.expand_as(s_b)] + ([coupling] if coupling is not None
                                          else [])
        got = []
        out = _floored_elimination(s_b, torch.cat(parts + [v_b], dim=2),
                                   raw=got)
        linv[b], z[b], raw[b] = out[:, :, :blk], out[:, :, -1:], got[0]
        if coupling is not None:
            cpl[b] = out[:, :, blk:2 * blk]

    for b in range(mid):                                 # top-down
        block(b, [b - 1] if b else [], hu[:, b])
    for b in range(m_blk - 1, mid, -1):                  # bottom-up
        block(b, [b + 1] if b + 1 < m_blk else [],
              hu[:, b - 1].transpose(1, 2))
    block(mid, [p for p in (mid - 1, mid + 1) if 0 <= p < m_blk], None)
    x_p = {mid: linv[mid].transpose(1, 2) @ z[mid]}
    for b in list(range(mid - 1, -1, -1)) + list(range(mid + 1, m_blk)):
        p = b + 1 if b < mid else b - 1
        x_p[b] = linv[b].transpose(1, 2) @ (z[b] - cpl[b] @ x_p[p])
    dx = torch.cat([x_p[i] * dsc[:, i, :, None] for i in range(m_blk)],
                   dim=1)
    if not return_shift:
        return dx
    shift = torch.clamp(PIVOT_FLOOR - torch.cat([raw[i] for i in
                                                 range(m_blk)], dim=1),
                        min=0.0)                     # NaN stays NaN
    return dx, (shift / dsc.reshape(shift.shape) ** 2)[:, :, None]


def ipm_solve_fused_plain(gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw,
                          *, nb_p: int, n_ball: int, mc: int, n_iters: int,
                          snap_iters: int, sigma_min: float, tau: float,
                          alpha_max: float, w_cap: float, reg: float,
                          snap_rho: float, blk: int):
    """``ipm_solve_fused`` in plain PyTorch; any float dtype, any device."""
    return _solve_fused_plain(
        gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw, nb_p=nb_p,
        n_ball=n_ball, mc=mc, n_iters=n_iters, snap_iters=snap_iters,
        sigma_min=sigma_min, tau=tau, alpha_max=alpha_max, w_cap=w_cap,
        reg=reg, snap_rho=snap_rho, blk=blk, band_sum=_gram_band)


def ipm_solve_fused_cluster_plain(gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0,
                                  act, cw, *, nb_p: int, n_ball: int,
                                  mc: int, n_iters: int, snap_iters: int,
                                  sigma_min: float, tau: float,
                                  alpha_max: float, w_cap: float, reg: float,
                                  snap_rho: float, blk: int):
    """``ipm_solve_fused_plain`` with each step's band summed in the cluster
    design's order (``_gram_band_cluster``).  Any float dtype, any device."""
    band = lambda *a: _gram_band_cluster(*a, nb_p=nb_p, n_ball=n_ball)
    return _solve_fused_plain(
        gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw, nb_p=nb_p,
        n_ball=n_ball, mc=mc, n_iters=n_iters, snap_iters=snap_iters,
        sigma_min=sigma_min, tau=tau, alpha_max=alpha_max, w_cap=w_cap,
        reg=reg, snap_rho=snap_rho, blk=blk, band_sum=band)


def _solve_fused_plain(gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw,
                       *, nb_p, n_ball, mc, n_iters, snap_iters, sigma_min,
                       tau, alpha_max, w_cap, reg, snap_rho, blk,
                       band_sum):
    bsz = gt.shape[0]
    m_blk = gt.shape[1] // blk

    def band(lam_ball, aj, w_aj):
        gd, gu = band_sum(gt, lam_ball, aj, w_aj, blk)
        return (gd.reshape(bsz, m_blk, blk, blk),
                gu.reshape(bsz, m_blk - 1, blk, blk))

    x, s, lam, y = x0, s0, lam0, y0
    best_x, best_y = x0, y0
    best_merit = torch.full((bsz, 1, 1), float("inf"), dtype=gt.dtype,
                            device=gt.device)
    lam_mid = torch.zeros_like(best_merit)
    for it in range(n_iters):
        s = torch.clamp(s, min=1e-14) * act + (1.0 - act)
        y_e, c, jtwr2, jts, lam_ball, aj, w_aj = _eval_core(
            gt, b, rb, x, s, lam, nb_p=nb_p, n_ball=n_ball, w_cap=w_cap,
            phr=False)
        r2 = (c + s) * act
        w = torch.clamp(lam / s, max=w_cap)
        mu = (cw * s * lam).sum(dim=2, keepdim=True) / mc
        sig_mu = sigma_min * mu                              # (B, 1, 1)
        rhs = -(_pe_band_mv(pe_d, pe_u, x, blk) + q + jtwr2 + sig_mu * jts)
        dx = _band_factor_solve(*band(lam_ball, aj, w_aj), pe_d, pe_u, reg,
                                rhs, blk)
        gdx = (gt * dx).sum(dim=1, keepdim=True)             # (B, 1, m_p)
        jdx = _jdx_lanes_k(gdx, y_e, nb_p, n_ball)
        ds = (-r2 - jdx) * act
        dlam = ((sig_mu - lam * s) / s - w * ds) * act
        alpha = torch.clamp(torch.minimum(_max_step_k(s, ds, tau),
                                          _max_step_k(lam, dlam, tau)),
                            max=alpha_max)
        # A NaN direction yields a finite alpha: gate on the direction.
        fin = (torch.isfinite(ds) & torch.isfinite(dlam)).all(
            dim=2, keepdim=True)
        upd = (alpha > 0) & fin
        x = torch.where(upd, x + alpha * dx, x)
        s = torch.where(upd, s + alpha * ds, s)
        lam = torch.where(upd & (act > 0),
                          torch.clamp(lam + alpha * dlam, min=1e-16), lam)
        y = torch.where(upd, y + alpha * gdx, y)
        merit = _merit_k(_c_lanes_k(y, rb, nb_p, n_ball), s, lam, act, cw, mc)
        better = merit < best_merit
        best_x = torch.where(better, x, best_x)
        best_y = torch.where(better, y, best_y)
        best_merit = torch.where(better, merit, best_merit)
        if it == n_iters // 2:
            lam_mid = torch.where(act > 0, lam, torch.zeros_like(lam)).amax(
                dim=2, keepdim=True)

    def phi(y_a):
        v = torch.clamp(_c_lanes_k(y_a, rb, nb_p, n_ball), min=0.0)
        return (cw * v * v).sum(dim=2, keepdim=True)

    for _ in range(snap_iters):
        c = _c_lanes_k(best_y, rb, nb_p, n_ball)
        margin = 3.0 / snap_rho
        lam_s = torch.where((c > -margin) & (act > 0),
                            torch.full_like(c, 1e-6), torch.zeros_like(c))
        s_s = lam_s / snap_rho
        _, _, jtwr2, _, lam_ball, aj, w_aj = _eval_core(
            gt, b, rb, best_x, s_s, lam_s, nb_p=nb_p, n_ball=n_ball,
            w_cap=snap_rho, phr=True)
        dx = _band_factor_solve(*band(lam_ball, aj, w_aj), pe_d, pe_u, 1e-6,
                                -jtwr2, blk)
        gdx = (gt * dx).sum(dim=1, keepdim=True)
        best_a = torch.zeros_like(best_merit)
        best_p = phi(best_y)
        for a_t in SNAP_ALPHAS:
            p_t = phi(best_y + a_t * gdx)
            better = p_t < best_p
            best_a = torch.where(better, torch.full_like(best_a, a_t), best_a)
            best_p = torch.where(better, p_t, best_p)
        best_x = torch.where(best_a > 0, best_x + best_a * dx, best_x)
        best_y = torch.where(best_a > 0, best_y + best_a * gdx, best_y)

    lam_fin_max = torch.where(act > 0, lam, torch.zeros_like(lam)).amax(
        dim=2, keepdim=True)
    return (best_x, best_y, s, lam, y, best_merit, lam_mid, lam_fin_max)


# ----------------------------------------------------------------------------
# CUDA wrappers
# ----------------------------------------------------------------------------

def _library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures
    declared."""
    lib = _build.load(name)
    if not _configured.get(id(lib)):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "gt_matvec":
            lib.gt_matvec_launch.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            lib.gt_matvec_launch.restype = i32
        elif name == "ipm_eval":
            lib.ipm_eval_step_launch.argtypes = (
                [ptr] * 12 + [i32] * 6 + [f32, i32, i32, ptr])
            lib.ipm_eval_step_launch.restype = i32
            lib.ipm_eval_gram_launch.argtypes = (
                [ptr] * 11 + [i32] * 6 + [f32, i32, i32, ptr])
            lib.ipm_eval_gram_launch.restype = i32
            for fn in ("ipm_eval_smem_bytes", "ipm_eval_design",
                       "ipm_eval_cluster_occupancy",
                       "ipm_eval_gram_smem_bytes", "ipm_eval_gram_design",
                       "ipm_eval_gram_cluster_occupancy"):
                getattr(lib, fn).argtypes = [i32] * 5
                getattr(lib, fn).restype = i32
            for fn in ("ipm_eval_cluster_smem_bytes",
                       "ipm_eval_gram_cluster_smem_bytes"):
                getattr(lib, fn).argtypes = [i32] * 4
                getattr(lib, fn).restype = i32
        elif name == "ipm_pipe":
            lib.ipm_pipe_step_launch.argtypes = (
                [ptr] * 31 + [i32] * 7 + [f32] * 6 + [i32] * 3 + [ptr])
            lib.ipm_pipe_step_launch.restype = i32
            for fn in ("ipm_pipe_smem_bytes", "ipm_pipe_design",
                       "ipm_pipe_cluster_occupancy"):
                getattr(lib, fn).argtypes = [i32] * 5
                getattr(lib, fn).restype = i32
            lib.ipm_pipe_cluster_smem_bytes.argtypes = [i32] * 4
            lib.ipm_pipe_cluster_smem_bytes.restype = i32
        elif name == "ipm_solve":
            lib.ipm_solve_fused_launch.argtypes = (
                [ptr] * 20 + [i32] * 9 + [f32] * 6 + [i32, ptr])
            lib.ipm_solve_fused_launch.restype = i32
            for fn in ("ipm_solve_smem_bytes", "ipm_solve_design",
                       "ipm_solve_cluster_occupancy"):
                getattr(lib, fn).argtypes = [i32] * 5
                getattr(lib, fn).restype = i32
            lib.ipm_solve_cluster_smem_bytes.argtypes = [i32] * 4
            lib.ipm_solve_cluster_smem_bytes.restype = i32
            lib.ipm_solve_pivot_floor.argtypes = []
            lib.ipm_solve_pivot_floor.restype = f32
        _configured[id(lib)] = True
    return lib


def smem_bytes(name: str, nfd: int, m_p: int, blk: int, nb_p: int,
               design: str = "stream") -> int:
    """Dynamic shared memory one block of ``ipm_eval``, ``ipm_eval_gram``
    (its whole-Gram entry point), ``ipm_pipe`` or ``ipm_solve`` takes at
    these shapes, in its one-block body ("stream") or its cluster design, as
    the library computes it (builds the library if needed)."""
    lib = _library(_LIBRARY_OF.get(name, name))
    if design == "cluster":
        return int(getattr(lib, f"{name}_cluster_smem_bytes")(nfd, m_p, blk,
                                                              nb_p))
    return int(getattr(lib, f"{name}_smem_bytes")(nfd, m_p, blk, nb_p,
                                                  THREADS))


def ipm_design(kernel: str, nfd: int, m_p: int, blk: int, nb_p: int) -> str:
    """The design ``kernel`` (a name of ``CLUSTER_KERNELS``:
    "ipm_eval_step" with band output, "ipm_eval_step_gram" with the whole
    Gram and ``blk`` its row blocks, "ipm_pipe_step", "ipm_solve_fused")
    launches at these shapes on the current CUDA device: "cluster" wherever
    a block's share fits, else "stream".  A choice by shape between two
    kernels, made by the library; builds it if needed."""
    key = (torch.cuda.current_device(), kernel, nfd, m_p, blk, nb_p)
    if key not in _designs:
        name = CLUSTER_KERNELS[kernel]
        fit = getattr(_library(_LIBRARY_OF.get(name, name)),
                      f"{name}_design")(nfd, m_p, blk, nb_p, THREADS)
        _designs[key] = "cluster" if fit else "stream"
    return _designs[key]


def cluster_occupancy(kernel: str, nfd: int, m_p: int, blk: int,
                      nb_p: int) -> int:
    """Clusters of ``kernel``'s cluster design the current device holds at
    once (``cudaOccupancyMaxActiveClusters``); raises on a CUDA error."""
    name = CLUSTER_KERNELS[kernel]
    n = int(getattr(_library(_LIBRARY_OF.get(name, name)),
                    f"{name}_cluster_occupancy")(nfd, m_p, blk, nb_p,
                                                 THREADS))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA "
                           f"error {-n}")
    return n


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


def _check_layout(gt, nb_p: int, n_ball: int, blk: int = 0):
    if gt.dim() != 3:
        raise ValueError(f"gt: expected (B, nfd, m_p), got {tuple(gt.shape)}")
    bsz, nfd, m_p = gt.shape
    if m_p % 4 or 3 * nb_p > m_p or not 0 <= n_ball <= nb_p:
        raise ValueError(f"bad lane layout: m_p={m_p}, nb_p={nb_p}, "
                         f"n_ball={n_ball}")
    if blk and (nfd % blk or nfd // blk < 2):
        raise ValueError(f"nfd={nfd} is not at least two blocks of {blk}")
    return bsz, nfd, m_p


def _sm_count(dev: torch.device) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _raise_on(err: int, what: str, **shapes) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err} ({shapes})")


def matvec_chunk(batch: int, m_p: int, sms: int) -> int:
    """Float4 columns a block of ``gt_matvec`` covers at this batch: the
    largest of ``MATVEC_CHUNKS`` that still gives the card ``sms`` SMs
    ``MATVEC_BLOCKS_PER_SM`` blocks each, else the smallest."""
    nl4 = m_p // 4
    for chunk in MATVEC_CHUNKS:
        if batch * -(-nl4 // chunk) >= MATVEC_BLOCKS_PER_SM * sms:
            return chunk
    return MATVEC_CHUNKS[-1]


def gt_matvec(gt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = G v: gt (B, nfd, m_p), v (B, nfd, 1) -> (B, 1, m_p).

    CUDA tensors (float32, contiguous) go through the kernel; CPU tensors
    through the plain version.  Anything the kernel does not take raises.
    """
    if gt.device.type == "cpu":
        return gt_matvec_plain(gt, v)
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")
    dev = gt.device
    if gt.dim() != 3 or gt.shape[2] % 4:
        raise ValueError(f"gt: expected (B, nfd, m_p) with m_p % 4 == 0, "
                         f"got {tuple(gt.shape)}")
    bsz, nfd, m_p = gt.shape
    _check("gt", gt, (bsz, nfd, m_p), dev)
    _check("v", v, (bsz, nfd, 1), dev)
    lib = _library("gt_matvec")
    out = torch.empty((bsz, 1, m_p), dtype=torch.float32, device=dev)
    chunk = matvec_chunk(bsz, m_p, _sm_count(dev))
    with torch.cuda.device(dev):
        err = lib.gt_matvec_launch(
            gt.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, nfd, m_p,
            chunk, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gt_matvec", B=bsz, nfd=nfd, m_p=m_p)
    launches["gt_matvec"] += 1
    return out


def ipm_eval_step(gt, b, rb, x, s, lam, *, nb_p: int, n_ball: int,
                  w_cap: float = 1e10, phr: bool = False,
                  band_block: int = 0):
    """One fused IPM evaluation at (x, s, lam).

    Args:
      gt: (B, nfd, m_p) equilibrated G^T in the padded plane layout.
      b: (B, 1, m_p).  rb: (B, 1, nb_p) scaled ball radii (pads 1).
      x: (B, nfd, 1).  s, lam: (B, 1, m_p) slack / multiplier lane vectors
        (ball entries replicated across the 3 planes, pads s=1, lam=0).
      band_block: size of the vertex blocks the weighted Gram is
        block-tridiagonal in (``solver.banded.kkt_tridiag_block``); 0 for
        the whole Gram.

    Returns (y, c (B, 1, m_p), jtwr2, jts (B, nfd, 1), hd (B, nfd, blk)
    stacked diagonal blocks, hu (B, nfd - blk, blk) stacked super blocks),
    or with ``band_block=0`` (y, c, jtwr2, jts, gram (B, nfd, nfd)).

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``ipm_design`` names for these shapes ("ipm_eval_step", or with
    ``band_block=0`` "ipm_eval_step_gram" with row blocks of
    ``gram_row_block(nfd)``); CPU tensors through the plain version.
    Anything the kernel does not take raises.
    """
    if gt.device.type == "cpu":
        return ipm_eval_step_plain(gt, b, rb, x, s, lam, nb_p=nb_p,
                                   n_ball=n_ball, w_cap=w_cap, phr=phr,
                                   band_block=band_block)
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")
    dev = gt.device
    blk = int(band_block)
    bsz, nfd, m_p = _check_layout(gt, nb_p, n_ball, blk)
    _check("gt", gt, (bsz, nfd, m_p), dev)
    for name, a in (("b", b), ("s", s), ("lam", lam)):
        _check(name, a, (bsz, 1, m_p), dev)
    _check("rb", rb, (bsz, 1, nb_p), dev)
    _check("x", x, (bsz, nfd, 1), dev)
    lib = _library("ipm_eval")
    f32 = torch.float32
    y, c = (torch.empty((bsz, 1, m_p), dtype=f32, device=dev)
            for _ in range(2))
    jtwr2, jts = (torch.empty((bsz, nfd, 1), dtype=f32, device=dev)
                  for _ in range(2))
    if blk:
        name, launch = "ipm_eval_step", lib.ipm_eval_step_launch
        grams = (torch.empty((bsz, nfd, blk), dtype=f32, device=dev),
                 torch.empty((bsz, nfd - blk, blk), dtype=f32, device=dev))
    else:
        if nfd < 2:
            raise ValueError(f"nfd={nfd}: the full-Gram kernel needs >= 2")
        name, launch = "ipm_eval_step_gram", lib.ipm_eval_gram_launch
        grams = (torch.empty((bsz, nfd, nfd), dtype=f32, device=dev),)
    with torch.cuda.device(dev):
        err = launch(
            gt.data_ptr(), b.data_ptr(), rb.data_ptr(), x.data_ptr(),
            s.data_ptr(), lam.data_ptr(), y.data_ptr(), c.data_ptr(),
            jtwr2.data_ptr(), jts.data_ptr(), *(g.data_ptr() for g in grams),
            bsz, nfd, m_p, blk or gram_row_block(nfd), nb_p, n_ball,
            float(w_cap),
            int(bool(phr)), THREADS, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name, B=bsz, nfd=nfd, m_p=m_p, blk=blk)
    launches[name] += 1
    return (y, c, jtwr2, jts) + grams


def ipm_pipe_step(gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm,
                  sinv, t, tt, dsc, rhs, act, cw, *,
                  nb_p: int, n_ball: int, mc: int, sigma_min: float,
                  tau: float, alpha_max: float, w_cap: float, reg: float,
                  snap_rho: float, blk: int, upd_mode: str, eval_mode: str):
    """One pipelined IPM step: finish the previous Newton or snap step (solve
    its direction from the given block-Thomas factors, apply the update) and
    evaluate the next point (Hessian band + right-hand side for the caller to
    factor).

    ``upd_mode`` / ``eval_mode``: "none" | "newton" | "snap".  Snap updates
    act on the best-iterate state (bx/by); Newton updates on the running
    x/s/lam/y with the finite-direction gate and best-iterate tracking.

    Args: gt (B, nfd, m_p); b, s, lam, y, by (B, 1, m_p); rb (B, 1, nb_p);
    pe_d (B, m, blk, blk), pe_u (B, m-1, blk, blk) objective band; q, x, bx,
    dsc, rhs (B, nfd, 1); bm (B, 1, 1); sinv (B, m, blk, blk), t / tt
    (B, m-1, blk, blk) factors; act, cw (1, 1, m_p) lane masks.

    Returns (x, s, lam, y, bx, by, bm, max_lam (B, 1, 1), hd (B, nfd, blk),
    hu (B, nfd - blk, blk), rhs (B, nfd, 1)); hd carries pe_d + reg I and hu
    carries pe_u; ``eval_mode="none"`` gives zeros for hd, hu and rhs.

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``ipm_design`` names for these shapes; CPU tensors through the plain
    version.  Anything the kernel does not take raises.
    """
    if upd_mode not in MODES or eval_mode not in MODES:
        raise ValueError(f"modes must be of {MODES}")
    kw = dict(nb_p=nb_p, n_ball=n_ball, mc=mc, sigma_min=sigma_min, tau=tau,
              alpha_max=alpha_max, w_cap=w_cap, reg=reg, snap_rho=snap_rho,
              blk=blk, upd_mode=upd_mode, eval_mode=eval_mode)
    if gt.device.type == "cpu":
        return ipm_pipe_step_plain(gt, b, rb, pe_d, pe_u, q, x, s, lam, y,
                                   bx, by, bm, sinv, t, tt, dsc, rhs, act,
                                   cw, **kw)
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")
    dev = gt.device
    bsz, nfd, m_p = _check_layout(gt, nb_p, n_ball, blk)
    m_blk = nfd // blk
    _check("gt", gt, (bsz, nfd, m_p), dev)
    for name, a in (("b", b), ("s", s), ("lam", lam), ("y", y), ("by", by)):
        _check(name, a, (bsz, 1, m_p), dev)
    _check("rb", rb, (bsz, 1, nb_p), dev)
    for name, a in (("pe_d", pe_d), ("sinv", sinv)):
        _check(name, a, (bsz, m_blk, blk, blk), dev)
    for name, a in (("pe_u", pe_u), ("t", t), ("tt", tt)):
        _check(name, a, (bsz, m_blk - 1, blk, blk), dev)
    for name, a in (("q", q), ("x", x), ("bx", bx), ("dsc", dsc),
                    ("rhs", rhs)):
        _check(name, a, (bsz, nfd, 1), dev)
    _check("bm", bm, (bsz, 1, 1), dev)
    _check("act", act, (1, 1, m_p), dev)
    _check("cw", cw, (1, 1, m_p), dev)

    lib = _library("ipm_pipe")
    f32 = torch.float32
    row = lambda: torch.empty((bsz, 1, m_p), dtype=f32, device=dev)
    col = lambda: torch.empty((bsz, nfd, 1), dtype=f32, device=dev)
    one = lambda: torch.empty((bsz, 1, 1), dtype=f32, device=dev)
    x_o, s_o, lam_o, y_o = col(), row(), row(), row()
    bx_o, by_o, bm_o, ml_o = col(), row(), one(), one()
    hd = torch.empty((bsz, nfd, blk), dtype=f32, device=dev)
    hu = torch.empty((bsz, nfd - blk, blk), dtype=f32, device=dev)
    rhs_o = col()
    ins = (gt, b, rb, pe_d, pe_u, q, x, s, lam, y, bx, by, bm, sinv, t, tt,
           dsc, rhs, act, cw)
    outs = (x_o, s_o, lam_o, y_o, bx_o, by_o, bm_o, ml_o, hd, hu, rhs_o)
    with torch.cuda.device(dev):
        err = lib.ipm_pipe_step_launch(
            *(a.data_ptr() for a in ins), *(a.data_ptr() for a in outs),
            bsz, nfd, m_p, blk, nb_p, n_ball, int(mc),
            float(sigma_min), float(tau), float(alpha_max), float(w_cap),
            float(reg), float(snap_rho),
            MODES.index(upd_mode), MODES.index(eval_mode), THREADS,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ipm_pipe_step", B=bsz, nfd=nfd, m_p=m_p, blk=blk,
              upd_mode=upd_mode, eval_mode=eval_mode)
    launches["ipm_pipe_step"] += 1
    return outs


def ipm_solve_fused(gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw, *,
                    nb_p: int, n_ball: int, mc: int, n_iters: int,
                    snap_iters: int, sigma_min: float, tau: float,
                    alpha_max: float, w_cap: float, reg: float,
                    snap_rho: float, blk: int):
    """The whole plane-layout polish in one launch: ``n_iters``
    single-direction Newton steps at fixed centring ``sigma_min`` (band factor
    and solve inside the kernel), then ``snap_iters`` Gauss-Newton feasibility
    sweeps from the best iterate.

    Args: gt (B, nfd, m_p); b, s0, lam0, y0 (B, 1, m_p); rb (B, 1, nb_p);
    pe_d (B, m, blk, blk), pe_u (B, m-1, blk, blk) objective band; q, x0
    (B, nfd, 1); act, cw (1, 1, m_p) lane masks.

    Returns (x_fin (B, nfd, 1), y_fin, s_fin, lam_fin, y_last (B, 1, m_p),
    best_merit, lam_mid, lam_fin_max (B, 1, 1)): the best iterate after the
    snap, the last Newton state, and the largest multiplier after step
    ``n_iters // 2`` and at the end (zero and max(lam0) when ``n_iters=0``).

    CUDA tensors (float32, contiguous) go through the kernel, in the design
    ``ipm_design`` names for these shapes; CPU tensors through the plain
    version.  Anything the kernel does not take raises.
    """
    if n_iters < 0 or snap_iters < 0:
        raise ValueError("n_iters and snap_iters must not be negative")
    kw = dict(nb_p=nb_p, n_ball=n_ball, mc=mc, n_iters=n_iters,
              snap_iters=snap_iters, sigma_min=sigma_min, tau=tau,
              alpha_max=alpha_max, w_cap=w_cap, reg=reg, snap_rho=snap_rho,
              blk=blk)
    if gt.device.type == "cpu":
        return ipm_solve_fused_plain(gt, b, rb, pe_d, pe_u, q, x0, s0, lam0,
                                     y0, act, cw, **kw)
    if gt.device.type != "cuda":
        raise ValueError(f"unsupported device {gt.device}")
    dev = gt.device
    bsz, nfd, m_p = _check_layout(gt, nb_p, n_ball, blk)
    m_blk = nfd // blk
    _check("gt", gt, (bsz, nfd, m_p), dev)
    for name, a in (("b", b), ("s0", s0), ("lam0", lam0), ("y0", y0)):
        _check(name, a, (bsz, 1, m_p), dev)
    _check("rb", rb, (bsz, 1, nb_p), dev)
    _check("pe_d", pe_d, (bsz, m_blk, blk, blk), dev)
    _check("pe_u", pe_u, (bsz, m_blk - 1, blk, blk), dev)
    _check("q", q, (bsz, nfd, 1), dev)
    _check("x0", x0, (bsz, nfd, 1), dev)
    _check("act", act, (1, 1, m_p), dev)
    _check("cw", cw, (1, 1, m_p), dev)

    lib = _library("ipm_solve")
    if lib.ipm_solve_pivot_floor() != ctypes.c_float(PIVOT_FLOOR).value:
        raise ValueError(f"the ipm_solve library floors its pivots at "
                         f"{lib.ipm_solve_pivot_floor()}, the plain version "
                         f"at PIVOT_FLOOR = {PIVOT_FLOOR}")
    f32 = torch.float32
    row = lambda: torch.empty((bsz, 1, m_p), dtype=f32, device=dev)
    one = lambda: torch.empty((bsz, 1, 1), dtype=f32, device=dev)
    outs = (torch.empty((bsz, nfd, 1), dtype=f32, device=dev), row(), row(),
            row(), row(), one(), one(), one())
    ins = (gt, b, rb, pe_d, pe_u, q, x0, s0, lam0, y0, act, cw)
    with torch.cuda.device(dev):
        err = lib.ipm_solve_fused_launch(
            *(a.data_ptr() for a in ins), *(a.data_ptr() for a in outs),
            bsz, nfd, m_p, blk, nb_p, n_ball, int(mc), int(n_iters),
            int(snap_iters), float(sigma_min), float(tau), float(alpha_max),
            float(w_cap), float(reg), float(snap_rho), THREADS,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ipm_solve_fused", B=bsz, nfd=nfd, m_p=m_p, blk=blk,
              n_iters=n_iters, snap_iters=snap_iters)
    launches["ipm_solve_fused"] += 1
    return outs
