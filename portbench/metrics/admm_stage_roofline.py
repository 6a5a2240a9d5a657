"""admm_stage_roofline: kernel #1's roofline time at the cell's shapes (the
frozen operation and byte counts, 67 TFLOP/s, 3.35 TB/s) over the median
CUDA-event span of ``ops.admm_kernel.admm_stage_fused_factored`` as the path
calls it, in %."""

import statistics

from portbench.roofline import counts


def read(ctx):
    stage = [c["entry/stage"] for c in ctx.spans if "entry/stage" in c]
    if not stage:
        return None
    cfg = ctx.cell.config
    nfd, m_p, m_blk, bs = counts.stage_shapes(int(cfg["n_segments"]),
                                              int(cfg["n_coefficients"]))
    bsz = int(ctx.cell.traffic["batch"])
    flops = counts.stage_flops(bsz, nfd, m_p, m_blk, bs,
                               int(cfg["admm"]["n_iters"]))
    nbytes = counts.stage_bytes(bsz, nfd, m_p, m_blk, bs)
    bound_ms, _ = counts.roofline_ms(flops, nbytes)
    return 100.0 * bound_ms / statistics.median(stage)
