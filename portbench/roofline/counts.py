"""Operations and bytes of the program's kernels, frozen, and the card's
peaks.

Copied from the counts the port's ``chip_smoke.py`` uses for its kernel
table (``stage_flops``, the input and output bytes counted once), so that
the benchmark's rooflines do not move when that script does.  Peaks: one
NVIDIA H100 SXM, dense float32 outside the tensor cores and HBM3 bandwidth,
at its full 700 W power limit (the run prints the card's limit beside every
share).
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def stage_shapes(k: int, n: int):
    """(nfd, m_p, m_blk, bs) of the free-interior family's stage kernel:
    free derivatives x 3, the padded lanes (three ball planes of
    round_up(n_ball, 128) lanes, their tails packed with half-space rows,
    the rest of the half-space rows in a last plane), the vertex blocks of
    the KKT band and their size."""
    h = n // 2
    nfd = (k - 1) * h * 3
    n_ball = (k - 1) + k * (n - 2)
    n_half = 2 * k * (n - 2)
    nb_p = round_up(n_ball, 128)
    rest = max(n_half - 3 * (nb_p - n_ball), 0)
    nh_p = round_up(rest, 128) if rest else 0
    bs = 3 * h
    return nfd, 3 * nb_p + nh_p, nfd // bs, bs


def stage_flops(bsz: int, nfd: int, m_p: int, m_blk: int, bs: int,
                n_iters: int) -> int:
    """Kernel 1's work: (3m - 2) products of (b, b) @ (b, m_p) and
    2 n_iters + 2 matvecs against (nfd, m_p), 2 flops per multiply-add."""
    return bsz * ((3 * m_blk - 2) * 2 * bs * bs * m_p
                  + (2 * n_iters + 2) * 2 * nfd * m_p)


def stage_bytes(bsz: int, nfd: int, m_p: int, m_blk: int, bs: int,
                nb_p: int = 128) -> int:
    """Kernel 1's inputs read once and outputs written once, float32:
    rho, the pivot inverses, T and T^T, G^T, b, the radii, xq and x in;
    x, z, z_prev, u, y, prim and dual out (the first stage: no z, u in)."""
    ins = (1 + m_blk * bs * bs + 2 * (m_blk - 1) * bs * bs + nfd * m_p + m_p
           + nb_p + 2 * nfd)
    outs = nfd + 4 * m_p + 2
    return bsz * (ins + outs) * F32


def roofline_ms(flops: float, nbytes: float):
    """(the least time in ms the card could take, "operations" or "bytes")."""
    f_ms = flops / PEAK_F32_FLOPS * 1e3
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")
