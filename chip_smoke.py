#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases toolchain,build,kernel_check

Builds the port's CUDA kernels from ``csrc/`` with nvcc (one nvcc per
source, all started together), holds each kernel against its plain PyTorch
version on the card, then drives the port's main paths through their public
entry points and checks the solution quality: ``solve_qcqp_batch`` on the
10-segment min-snap QP+QCQP benchmark configuration, batch 6144; the polish
with the whole interior-point method in one kernel launch
(``solve_qcqp_polished_batch`` with ``IPMConfig(fused=True)``) on the same
batch, beside the step-by-step polish at the router's row counts; the
strict verdict router ``solve_qcqp_strict`` with its defaults (float64 last
tier on) on the same batch and on a tight-corridor batch of 512, where its
escalation tiers do the work; the other KKT routes of ``solve_qcqp_batch``;
the headline with ``gt_assembly="kernel"`` (G^T never formed: the stage
and band kernels expand it from its rank-1 factors); the linear planner
path, which runs no kernel: ``solve_linear`` and ``solve_linear_banded``
over the K sweep (2, 10, 50, 100; batch 2048) and the extrema feasibility
check (``solve_linear`` then ``max_magnitude`` of velocity and acceleration,
batch 6144), each held to float64 on the card; and the nonlinear slice,
which runs no kernel either: the signed distance field of the demo's
100 x 100 x 50 forest map (``esdf_from_occupancy``, the min-plus transform
on the card against the host C++ one and a brute force), the demo's
collision objective (``optimize``, examples/demo_main_torch.py, one scenario
and 1024 at once, against float64) and the TIME objective's four optimizers
of benchmarks/nonlinear_bench.py (Nelder-Mead and L-BFGS through the inner
solve with the zoom, backtracking and hybrid line searches, batch 1024,
held to the JAX package's medians); and the scenario-parallel layer over
torch.distributed, in child processes of this script: the strict router
sharded over a world of 1 under NCCL against the unsharded router with the
same schedule, and over a world of 2 under gloo with both ranks on the one
card (a correctness run, not a scaling measurement).
Every phase prints one JSON object on a line of its own;
a failing phase raises, so the script exits non-zero and prints no final
line.  There is no CPU mode: without a CUDA device it exits with code 2.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and device-memory bandwidth.  Used only for the bound.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version on the card.  Both are float32 and differ in the
# order of sums and in rsqrtf (not correctly rounded on the card); the scaled
# free derivatives x reach several 1e2 while the KKT solve has cond ~1e3, so
# after 48 iterations any two float32 runs differ by a few 1e-6 of max|x| in
# EVERY output (y = G x + b carries x's noise into the O(1) constraint
# space).  Two criteria, both must hold for each of the seven outputs:
#  1. |kernel - plain_f32| <= KERNEL_TOL * max(1, max|x|);
#  2. against the plain version run in float64 on the same inputs, the
#     kernel is no worse than float32 arithmetic allows:
#     |kernel - plain_f64| <= 3 |plain_f32 - plain_f64| + 1e-6 max(1, max|x|).
# Kernel 1's cluster design computes x = xq + rho W^-1 (G^T v) in place of
# xq + rho (W^-1 G^T) v: criterion 1 holds it to the plain version in that
# order (admm_stage_fused_factored_winv_plain), criterion 2 to the reference
# order's plain version in float64 with the reference order's float32 error
# as the floor, as before.  A negative control, the kernel with alpha
# WRONG_ALPHA for the config's 1.6, must fail them at the flagship shape.
KERNEL_TOL = 2e-5

# Quality bars of the main path at seed 0: the JAX reference recorded
# 6110/6144 feasible at the 1e-2 gate and a median violation of 1.49e-4.
MAIN_BATCH = 6144
MIN_FEASIBLE = 6080
MAX_MEDIAN_VIOLATION = 3e-4
# Launches of the small SPD inverse (csrc/spd_inverse.cu) in one call of the
# main path: the warm start's 36 x 36 block, and the K - 1 = 9 pivot blocks
# of the band's block-LDL^T sweep (15 x 15).
SPD_INVERSE_LAUNCHES = 10
# Launches of the Gram band kernel #6 (csrc/gram_band.cu, ``gram_band``) in
# one call of the main path: the default band_gram, "auto", takes the band
# from it once a solve wherever G^T is float32 on the card.
GRAM_BAND_LAUNCHES = 1
# The kernel against the library chain on the same blocks, in the
# equilibrated frame (|inverse| times d_i d_j, d = diag(a)^1/2): the largest
# gap of a block over its largest entry, the tolerances of
# tests/test_torch_spd_inverse.py.
SPD_INVERSE_RTOL = {"float32": 2e-4, "float64": 1e-10}
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet): the small
# SPD inverse computes in float64 for either type.
PEAK_F64_FLOPS = 34e12
OUT_NAMES = ("x", "z", "z_prev", "u", "prim", "dual", "y")
ALL_PHASES = ("toolchain", "build", "kernel_check", "main_path",
              "multi_stage", "dense_path", "band_gram", "stage_bits",
              "ipm_bits", "band_bits",
              "ipm_kernel_check", "fused_path", "strict_path",
              "strict_tight", "ew_path", "linear_sweep", "extrema",
              "esdf", "nonlinear_collision", "nonlinear_time", "sharded",
              "kernels")

# The interior-point kernels against their plain versions, per output, on
# inputs recorded from real solves.  Every row is compared (one scenario at a
# time) as a share of the output's scale, max |plain float64 output|.
# A fixed tolerance per row does not separate a right kernel from a wrong one
# here: the weighted-Gram weights span 12 decades (w up to w_cap = 1e6 beside
# 1e-6), the K=10 Newton systems are ill-conditioned, and the step takes
# discrete decisions on float comparisons (the seven-point line search,
# "merit < best", the update gate), so after ONE Newton step at K=10 plain
# float32 is itself 2e-4 of scale from plain float64 in the median row of
# x_fin, and the kernel 6e-2 from plain float32 in the worst row of 6144
# (the `kernels` line prints both), and nothing but a statistical statement
# holds for a whole polish.  So the kernel is held to
# float32's own error, measured on the same inputs: with e_k = |kernel - plain
# float64| and e_p = |plain float32 - plain float64| per row, for each output
#  1. the distribution: at the median, the 90th and the 99th percentile over
#     the rows (a percentile is used where at least IPM_TAIL_ROWS rows lie
#     beyond it), e_k <= IPM_DIST_FACTOR * e_p + IPM_FLOOR;
#  2. the gross rows, e > IPM_GROSS of scale: the kernel has at most twice
#     as many as plain float32 plus IPM_GROSS_SLACK of the batch (at least
#     2 rows);
#  3. whatever plain float32 does, the kernel's gross rows number at most
#     IPM_GROSS_CAP of the batch (plus the same slack).  Exempt are only the
#     outputs named at the call: the merit (a quadratic function of y, it
#     doubles y's error and is judged by 1 and 2), and for a polish of more
#     than IPM_SHORT_RUN Newton steps the endgame's running state (lam_fin,
#     lam_fin_max, the merit), which is rounding noise in any float32 order
#     once mu has reached float32's floor (plain float32 is then 0.3 of
#     scale from plain float64 in the median row).
# The check reports, besides, the worst row of kernel vs plain float32 over
# ALL rows, and the rows beyond IPM_ROW_TOL of scale (reported only).
IPM_ROW_TOL = 2e-4
IPM_QUANTILES = (0.5, 0.9, 0.99)
IPM_TAIL_ROWS = 4
IPM_DIST_FACTOR = 2.0
IPM_FLOOR = 1e-6
IPM_GROSS = 2e-2
IPM_GROSS_SLACK = 0.001
IPM_GROSS_CAP = 0.05
IPM_SHORT_RUN = 3
# IPMConfig.infeas_growth's default, which every path here uses.
FUSED_INFEAS_GROWTH = 10.0
PIPE_OUT = ("x", "s", "lam", "y", "bx", "by", "bm", "max_lam", "hd", "hu",
            "rhs")
EVAL_OUT = ("y", "c", "jtwr2", "jts", "hd", "hu")
GRAM_OUT = ("y", "c", "jtwr2", "jts", "gram")
FUSED_OUT = ("x_fin", "y_fin", "s_fin", "lam_fin", "y_last", "best_merit",
             "lam_mid", "lam_fin_max")

# Quality bars of the strict path at seed 0, batch 6144: the JAX reference
# recorded 6144/6144 determinate with its float64 last tier, and so must this
# router with its defaults; on the 512 tight corridors the router without
# that tier left 18 rows undetermined, and with it may leave no more.
STRICT_GATE = 1e-4
MAX_TIGHT_UNDETERMINED = 18
# strict_path's passes timed tier by tier (about 0.35 s each at batch 6144).
SPLIT_PASSES = 5
# The kernels the strict path launches (the other two wrappers of
# ops.ipm_kernel have paths of their own: fused_path, and the public
# full-Gram evaluation driven in strict_path at tier 1's shape).
STRICT_KERNELS = ("admm_stage_fused_factored", "gt_matvec", "ipm_eval_step",
                  "ipm_pipe_step")
# The fused polish at full width.  Gated against the same polish with the
# fused kernel's plain version in its place (same entry point, same
# schedule, the other kernels unchanged; seeds 0 and 1): relative cost gap
# with a median of at most FUSED_COST_MEDIAN and a 99th percentile of at most
# FUSED_COST_P99 (the bounds tests/test_ipm_lanes.py asks of the median and
# the worst of eight K=4 rows), at most FUSED_COST_OUTLIER_SHARE of the rows
# further apart than FUSED_COST_P99 (two float32 runs of one polish part by
# whole steps in a few rows, where one of the two stops short of the gate),
# rows under the strict gate at most FUSED_UNDER_GATE_SHARE of the batch fewer
# than the plain run's, a 99th-percentile violation of at most 3x the plain
# run's, and rows certified infeasible at most twice the plain run's plus
# IPM_GROSS_SLACK of the batch.  Against the step-by-step (scan) polish, which
# is another schedule, the median and the 99th percentile of the cost gap
# are held to the same two bounds and the violations to the scan run's class;
# its worst rows are reported beside the spread of two other float32
# schedules (pipelined against scan) and gate nothing.
FUSED_COST_MEDIAN = 1e-3
FUSED_COST_P99 = 1e-2
FUSED_COST_OUTLIER_SHARE = 0.0025
FUSED_UNDER_GATE_SHARE = 0.005
FUSED_SEEDS = (0, 1)
# The whole polish's residual class (fused_class) must fail a kernel that
# skips its last snap sweep: the snap-only polish run with one sweep, judged
# against the plain version with two, rejected at the flagship shape (gated)
# and at K=4 (reported).  The six polishes are judged again at
# FUSED_WIDE_ROWS rows of seed 1, where fused_class reads the 99th
# percentile, reported only: there the class is within float32's noise (the
# plain version's two orders of sums part by ~2x at that tail, and a median
# of one float32 step of c, 6.1e-5, meets a bar of 5e-5), which the report
# shows beside it (plain_cluster_order_tail).  On the snap-only polish at
# that batch the factor-alone check is gated: no row may lose the step that
# the float64 solve of the kernel's own band finds (rows_lost_by_factor).
FUSED_WIDE_ROWS = 512
IPM_SOURCES = ("gt_matvec", "ipm_eval", "ipm_pipe", "ipm_solve")
PKG = "mav_tube_trajectory_generation_tpu_torch"


LOG_PATH = None


def say(line):
    """One line to standard output and, with --out, to that file too."""
    print(line, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as fh:
            fh.write(line + "\n")


def emit(phase, **fields):
    say(json.dumps({"phase": phase, **fields}))


def run_text(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"
    return (out.stdout + out.stderr).strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_config(mtt, n_stages=1, n_iters=48):
    return mtt.ADMMConfig(rho=0.005, n_stages=n_stages, n_iters=n_iters,
                          rho_tube_factor=0.125, rho_half_factor=0.125)


def stage_inputs(mtt, k, batch, seed, config, band_gram=None):
    """Stage-kernel inputs exactly as the main path builds them, the Gram
    band on ``band_gram`` (the config's route where None)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    sc = mtt.make_inputs(k, batch, seed=seed)
    layout = qcqp._flagship_layout(sc.free)
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, config, None, layout,
                    warmstart_positions=sc.values[:, 1:-1, 0, :])
    blk = banded.kkt_tridiag_block(sc.free)
    band = qcqp._kkt_band(pre.gt, pre.p_eq, blk,
                          band_gram or config.band_gram)
    rho = torch.full((batch, 1, 1), config.rho, dtype=torch.float32,
                     device=pre.gt.device)
    sinv, t_st, tt_st, xq = qcqp._stage_factors(band, rho, config.sigma,
                                                pre.q_flat)
    args = (rho, sinv, t_st, tt_st, pre.gt.contiguous(),
            pre.b_pad.contiguous(), qcqp._rb_pad(pre.rb, layout), xq,
            pre.x_flat0[:, :, None].contiguous())
    kw = dict(n_iters=config.n_iters, alpha=config.alpha, nb_p=layout.nb_p,
              n_ball=layout.n_ball)
    return args, kw


def compare_outputs(ours, plain, plain64, ref32=None):
    """Per-output max abs differences (kernel vs plain float32, kernel vs
    plain float64, plain float32 vs plain float64) and whether both criteria
    stated at KERNEL_TOL hold.  ``ref32``: the float32 run whose distance to
    ``plain64`` is criterion 2's floor, where it is not ``plain`` (kernel 1:
    the reference order's)."""
    import torch
    ref32 = plain if ref32 is None else ref32
    diffs, diffs64, floor64, plain64_err, ok = {}, {}, {}, {}, True
    scale = max(1.0, float(plain[0].abs().max()))
    for name, a, b, c, r in zip(OUT_NAMES, ours, plain, plain64, ref32):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"kernel output {name}: bad shape or "
                               f"non-finite values")
        diffs[name] = float((a - b).abs().max())
        diffs64[name] = float((a.double() - c).abs().max())
        floor64[name] = float((r.double() - c).abs().max())
        plain64_err[name] = float((b.double() - c).abs().max())
        ok = (ok and diffs[name] <= KERNEL_TOL * scale
              and diffs64[name] <= 3.0 * floor64[name] + 1e-6 * scale)
    out = dict(kernel_vs_plain=diffs, kernel_vs_plain_f64=diffs64,
               plain_vs_plain_f64=floor64, scale=scale)
    if ref32 is not plain:
        out["order_plain_vs_plain_f64"] = plain64_err
    return out, ok


def run_three(admm_kernel, args, kw, extra=(), init_z=True, alpha=None,
              design="cluster"):
    """Kernel 1's (kernel, plain float32 in the kernel's order, plain
    float64, plain float32 in the reference order) outputs on the same
    inputs; with ``alpha`` the kernel alone runs with that alpha (the
    negative control).  The kernel's order is the cluster design's
    (``admm_stage_fused_factored_winv_plain``) or, for ``design`` "stream",
    the reference order itself."""
    import torch
    k_kw = kw if alpha is None else dict(kw, alpha=alpha)
    ours = admm_kernel.admm_stage_fused_factored(*args, *extra,
                                                 init_z=init_z, **k_kw)
    torch.cuda.synchronize()
    ref32 = admm_kernel.admm_stage_fused_factored_plain(
        *args, *extra, init_z=init_z, **kw)
    plain = ref32 if design == "stream" else \
        admm_kernel.admm_stage_fused_factored_winv_plain(
            *args, *extra, init_z=init_z, **kw)
    plain64 = admm_kernel.admm_stage_fused_factored_plain(
        *(a.double() for a in args), *(a.double() for a in extra),
        init_z=init_z, **kw)
    return ours, plain, plain64, ref32


def phase_toolchain(state):
    import torch
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    from mav_tube_trajectory_generation_tpu_torch import _build
    nvcc = _build.find_nvcc()
    release = re.search(r"release [^\n]*", run_text([nvcc, "--version"]))
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    state["nvidia_smi"] = smi
    emit("toolchain", python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, triton=triton_version,
         nvcc=release.group(0) if release else None, nvidia_smi=smi,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def build_report(_build, name):
    info = _build.build_info(name)
    log = _build.build_log(name)
    return dict(
        source=f"{PKG}/csrc/{name}.cu", built_now=info["built"],
        nvcc_seconds=round(info["seconds"], 3),
        registers=[int(x) for x in re.findall(r"Used (\d+) registers", log)],
        spill_store_bytes=[int(x) for x in
                           re.findall(r"(\d+) bytes spill stores", log)])


# The entry functions of the two ADMM sources, by the name in the source.
ADMM_ENTRIES = {"admm_stage": ("admm_stage_fused_factored_kernel",
                               "admm_stage_fused_factored_ew_kernel",
                               "admm_stage_fused_kernel",
                               "admm_stage_iter_kernel",
                               "admm_stage_cluster_kernel",
                               "admm_stage_fused_cluster_kernel",
                               "admm_stage_ew_cluster_kernel",
                               "admm_stage_given_cluster_kernel"),
                "gram_band": ("gram_band_kernel", "gram_band_ew_kernel",
                              "gram_band_ring_kernel")}
# A block's dynamic shared memory may not exceed this on an H100.
MAX_DYNAMIC_SMEM = 232448
# The stage entry points with a cluster design, each with (nfd, m_p, nb_p)
# at its shapes and the design it must take there: the cluster design
# wherever a block's share fits, the stream design past that: kernel 1 and
# #2 from K=11 (at K=12 half of G^T alone is 211 KB), #3 from K=14 (its
# share of e and w is a third of G^T's), #7 (a cluster of four, a quarter of
# m1's and G^T's lanes a block) from K=13.  Where the cluster design is
# taken, the block size its launcher must take too (512 threads an SM over
# as many blocks as the SM's shared memory holds, at least 64).
STAGE_DESIGNS = {
    "admm_stage_fused_factored": {"flagship": (135, 512, "cluster", 512),
                                  "K=4": (45, 384, "cluster", 128),
                                  "K=12": (165, 640, "stream", None)},
    "admm_stage_fused": {"K=2": (15, 384, "cluster", 64),
                         "K=4": (45, 384, "cluster", 128),
                         "flagship": (135, 512, "cluster", 512),
                         "K=12": (165, 640, "stream", None)},
    "admm_stage_fused_factored_ew": {"K=4": (45, 384, "cluster", 64),
                                     "flagship": (135, 512, "cluster", 512),
                                     "K=12": (165, 640, "cluster", 512),
                                     "K=14": (195, 640, "stream", None)},
    "admm_stage": {"K=2": (15, 384, "cluster", 64),
                   "K=4": (45, 384, "cluster", 64),
                   "flagship": (135, 512, "cluster", 512),
                   "K=12": (165, 640, "cluster", 512),
                   "K=14": (195, 640, "stream", None)}}
# #7's negative control: its cluster design built with rank 3's partial of
# m1 v left out of g.
STAGE_DROP_RANK3 = ("ADMM_STAGE_CONTROL_DROP_RANK3",)
STAGE_CONTROL_BUILDS = (("admm_stage", STAGE_DROP_RANK3),)


# #5 and #6 (nfd, m_p, blk) at the solver's shapes and one other band block,
# the design each must take there (ops.admm_kernel.band_design: the ring at
# the band block of every assembly, 15, the window body at any other), and
# where the ring is taken the blocks an SM must hold (two at K=2 to K=10:
# the ring and the partials take 77,784-100,824 B).  #4 (G^T as its row
# factors) takes the same designs at the same shapes, with w's buffer and
# one more mbarrier: 87,008-113,120 B, two blocks an SM to K=10.
BAND_DESIGN_SHAPES = {"K=2": (15, 384, 15, "ring", 2),
                      "K=4": (45, 384, 15, "ring", 2),
                      "flagship": (135, 512, 15, "ring", 2),
                      "K=12": (165, 640, 15, "ring", 1),
                      "flagship blk 9": (135, 512, 9, "window", None)}
BAND_SOURCES = {"stored": "gram_band", "factors": "gram_band_factors_ew"}
# The ring's negative control: the same source built with the last warp's
# partial left out of every entry.
BAND_SKIP_COMBINE = ("GRAM_BAND_CONTROL_SKIP_COMBINE",)
BAND_CONTROL_BUILDS = (("gram_band", BAND_SKIP_COMBINE),)


# #8-#11 (nfd, m_p) at K=10, 4 and 12 and the design each must take there:
# the cluster design wherever a block's share fits, the one-block "stream"
# body past that (K=12: half of G^T alone is 211 KB).
IPM_DESIGNS = {"flagship": (135, 512, "cluster"),
               "K=4": (45, 384, "cluster"),
               "K=12": (165, 640, "stream")}
IPM_ENTRIES = {"ipm_eval": ("ipm_eval_kernel", "ipm_eval_cluster_kernel",
                            "ipm_eval_gram_cluster_kernel"),
               "ipm_pipe": ("ipm_pipe_kernel", "ipm_pipe_cluster_kernel"),
               "ipm_solve": ("ipm_solve_kernel", "ipm_solve_cluster_kernel")}
# The negative control of the cluster designs: the same sources built with
# rank 0's partial of the band (#8, #9, #11) or of the Gram (#10) left out
# of the sum.
IPM_DROP_RANK0 = ("IPM_CONTROL_DROP_RANK0",)
# The whole-polish kernel that writes its first snap sweep's band,
# right-hand side and direction (factor_alone), in the design the shape
# takes.
IPM_SOLVE_DUMP = ("IPM_SOLVE_DUMP",)
IPM_CONTROL_BUILDS = (("ipm_eval", IPM_DROP_RANK0),
                      ("ipm_pipe", IPM_DROP_RANK0),
                      ("ipm_solve", IPM_DROP_RANK0),
                      ("ipm_solve", IPM_SOLVE_DUMP))


def entry_report(log, names):
    """Registers, spill-store bytes and static shared memory per entry
    function, read from ``nvcc -Xptxas -v``'s output (mangled names are
    matched by their length-prefixed identifier)."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        for name in names:
            if f"{len(name)}{name}" in mangled:
                regs = re.search(r"Used (\d+) registers", chunk)
                spill = re.search(r"(\d+) bytes spill stores", chunk)
                smem = re.search(r"(\d+) bytes smem", chunk)
                out[name] = dict(
                    registers=int(regs.group(1)) if regs else None,
                    spill_store_bytes=int(spill.group(1)) if spill else None,
                    static_smem_bytes=int(smem.group(1)) if smem else None)
    return out


def ring_entries(log):
    """``entry_report`` of the ring's kernels, one a tile shape and G^T
    source (``gram_band_ring_kernel<TR,TC,SRC>``, SRC 0 stored, 1 factors,
    matched by their template arguments in the mangled name)."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        tile = re.search(r"21gram_band_ring_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                         mangled)
        if tile:
            name = (f"gram_band_ring_kernel<{tile.group(1)},{tile.group(2)},"
                    f"{tile.group(3)}>")
            out.update({name: entry_report(
                "Compiling entry function '" + chunk,
                ["gram_band_ring_kernel"])["gram_band_ring_kernel"]})
    return out


def band_design_report(admm_kernel):
    """The band kernels' design at each shape of BAND_DESIGN_SHAPES, for G^T
    stored (#5, #6) and as its row factors (#4), with a block's shared
    memory as the library and as ops.admm_kernel compute it and, for the
    ring, the blocks an SM holds and the grid at MAIN_BATCH; the labels of
    the shapes that do not take what they must."""
    designs, bad = {}, []
    for (label, (nfd, m_p, blk, want, per_sm)), (source, kind) in (
            (shape, src) for src in BAND_SOURCES.items()
            for shape in BAND_DESIGN_SHAPES.items()):
        label = f"{kind} {label}"
        d = admm_kernel.band_design(nfd, m_p, blk, source)
        entry = dict(d._asdict(), expected_design=want,
                     smem_bytes_of_the_library=admm_kernel.smem_bytes(
                         nfd, m_p, nfd // blk, blk, 0, kind=kind))
        if d.design == "ring":
            entry.update(
                blocks_per_sm=admm_kernel.ring_blocks_per_sm(m_p, d),
                expected_blocks_per_sm=per_sm,
                grid_at_main_batch=admm_kernel.ring_grid(MAIN_BATCH, m_p, d))
        designs[label] = entry
        if (d.design != want
                or entry["smem_bytes_of_the_library"] != d.smem_bytes
                or d.smem_bytes > MAX_DYNAMIC_SMEM
                or entry.get("blocks_per_sm") != per_sm):
            bad.append(label)
    return designs, bad


def phase_build(state):
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    t0 = time.perf_counter()
    if set(_build.SOURCES) != {"admm_stage", "gram_band", "spd_inverse",
                               *IPM_SOURCES}:
        raise RuntimeError(f"unexpected kernel sources: {_build.SOURCES}")
    wall = _build.prebuild(variants=IPM_CONTROL_BUILDS
                           + BAND_CONTROL_BUILDS + STAGE_CONTROL_BUILDS)
    smem = admm_kernel.smem_bytes(135, 512, 9, 15, 128)
    seconds = time.perf_counter() - t0
    # #8-#11: which design each shape takes (IPM_DESIGNS), a block's
    # shared memory in either design (the cluster's as the library and as
    # ops.ipm_kernel.cluster_layout compute it) and the clusters in flight
    designs, bad = {}, []
    for kernel, prefix in ipm_kernel.CLUSTER_KERNELS.items():
        for label, (nfd, m_p, want) in IPM_DESIGNS.items():
            blk = (ipm_kernel.gram_row_block(nfd)
                   if kernel == "ipm_eval_step_gram" else 15)
            design = ipm_kernel.ipm_design(kernel, nfd, m_p, blk, 128)
            lib_bytes = ipm_kernel.smem_bytes(prefix, nfd, m_p, blk, 128,
                                              design="cluster")
            mirror = ipm_kernel.cluster_smem_bytes(kernel, nfd, m_p, blk, 128)
            d = dict(design=design, expected_design=want, blk=blk,
                     cluster_dynamic_smem_bytes=lib_bytes,
                     cluster_dynamic_smem_bytes_computed_in_python=mirror,
                     stream_dynamic_smem_bytes=ipm_kernel.smem_bytes(
                         prefix, nfd, m_p, blk, 128),
                     max_active_clusters=ipm_kernel.cluster_occupancy(
                         kernel, nfd, m_p, blk, 128)
                     if design == "cluster" else None)
            designs[f"{kernel} {label}"] = d
            if (design != want or lib_bytes != mirror
                    or (design == "cluster" and d["max_active_clusters"] < 1)):
                bad.append(f"{kernel} {label}")
    entries = {}
    for src, names in IPM_ENTRIES.items():
        entries.update(entry_report(_build.build_log(src), names))
    state["ipm_designs"] = designs
    # #11's pivot floor as built, beside the plain version's (the wrapper
    # refuses to launch when they differ)
    floor = dict(library=ipm_kernel._library("ipm_solve")
                 .ipm_solve_pivot_floor(), plain=ipm_kernel.PIVOT_FLOOR)
    if floor["library"] != ctypes.c_float(floor["plain"]).value:
        bad.append(f"ipm_solve pivot floor {floor}")
    emit("build_ipm", parallel_wall_seconds=round(wall, 3),
         libraries=[build_report(_build, n) for n in IPM_SOURCES],
         control_builds=[dict(source=n, defines=list(d),
                              built_now=_build.build_info(n, d)["built"])
                         for n, d in IPM_CONTROL_BUILDS],
         dynamic_smem_bytes_flagship={
             n: ipm_kernel.smem_bytes(n, 135, 512, 15, 128)
             for n in ("ipm_eval", "ipm_pipe", "ipm_solve")},
         entry_functions=entries, designs=designs,
         max_dynamic_smem_bytes=MAX_DYNAMIC_SMEM,
         threads_per_block=ipm_kernel.THREADS, ipm_solve_pivot_floor=floor)
    if bad or len(entries) != sum(map(len, IPM_ENTRIES.values())):
        raise RuntimeError(f"build: #8-#11 do not take the expected design "
                           f"{IPM_DESIGNS} with the layout Python computes, "
                           f"or entry functions are missing: {bad}, "
                           f"{sorted(entries)}")
    info = _build.build_info("admm_stage")
    log = _build.build_log("admm_stage")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    static_smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    emit("build", source="mav_tube_trajectory_generation_tpu_torch/csrc/"
         "admm_stage.cu", built_now=info["built"],
         nvcc_seconds=round(info["seconds"], 3), seconds=round(seconds, 3),
         registers=regs, spill_store_bytes=spills,
         static_smem_bytes=static_smem, dynamic_smem_bytes_flagship=smem,
         threads_per_block=admm_kernel.THREADS)
    if spills and max(spills) > 0:
        print("note: the kernel spills registers", file=sys.stderr)
    # The entry points this slice added, with their dynamic shared memory at
    # the flagship shape (nfd 135, m_p 512) and at K=2 (nfd 15, m_p 384).
    entries = {}
    for src, names in ADMM_ENTRIES.items():
        entries.update(entry_report(_build.build_log(src), names))
    ring = ring_entries(_build.build_log("gram_band"))
    smem = {}
    for label, nfd, m_p in (("flagship", 135, 512), ("K=2", 15, 384)):
        smem[label] = {kind: admm_kernel.smem_bytes(nfd, m_p, nfd // 15, 15,
                                                    128, kind=kind)
                       for kind in admm_kernel.launches}
    # The stage entry points' two designs: which one each shape takes
    # (STAGE_DESIGNS) and at what block size, a block's shared memory in
    # either design (the cluster's as the library and as
    # ops.admm_kernel.cluster_smem_bytes compute it) and, where the cluster
    # design is taken, the clusters the card holds at once.
    designs, bad = {}, []
    for kind, shapes in STAGE_DESIGNS.items():
        for label, (k_nfd, k_mp, want, want_threads) in shapes.items():
            k_blk = k_nfd // 15
            nb_p = 128
            design = admm_kernel.stage_design(kind, k_nfd, k_mp, k_blk, 15,
                                              nb_p)
            d = dict(
                design=design, expected_design=want,
                cluster_dynamic_smem_bytes=admm_kernel.smem_bytes(
                    k_nfd, k_mp, k_blk, 15, nb_p, kind, design="cluster"),
                cluster_dynamic_smem_bytes_computed_in_python=admm_kernel.
                cluster_smem_bytes(kind, k_nfd, k_mp, k_blk, 15, nb_p),
                stream_dynamic_smem_bytes=admm_kernel.smem_bytes(
                    k_nfd, k_mp, k_blk, 15, nb_p, kind, design="stream"),
                max_active_clusters=admm_kernel.cluster_occupancy(
                    k_nfd, k_mp, k_blk, 15, nb_p, kind)
                if design == "cluster" else None,
                cluster_block_threads=admm_kernel.block_threads(
                    k_nfd, k_mp, k_blk, 15, nb_p, kind),
                expected_block_threads=want_threads,
                cluster_ranks=admm_kernel.cluster_ranks(kind))
            designs[f"{kind} {label}"] = d
            if (design != want
                    or d["cluster_dynamic_smem_bytes"]
                    != d["cluster_dynamic_smem_bytes_computed_in_python"]
                    or (design == "cluster"
                        and (d["cluster_block_threads"] != want_threads
                             or d["max_active_clusters"] < 1))):
                bad.append(f"{kind} {label}")
    state["stage_designs"] = designs
    band_designs, band_bad = band_design_report(admm_kernel)
    emit("build_admm_routes", libraries=[build_report(_build, "gram_band")],
         entry_functions=entries, ring_entry_functions=ring,
         dynamic_smem_bytes=smem,
         max_dynamic_smem_bytes=MAX_DYNAMIC_SMEM, stage_designs=designs,
         band_designs=band_designs, control_builds=[
             dict(source=n, defines=list(d),
                  built_now=_build.build_info(n, d)["built"])
             for n, d in BAND_CONTROL_BUILDS + STAGE_CONTROL_BUILDS],
         threads_per_block=dict(
             stage=admm_kernel.THREADS,
             gram_band={k: v["threads"] for k, v in band_designs.items()}))
    over = {f"{label} {k}": v for label, d in smem.items()
            for k, v in d.items() if v > MAX_DYNAMIC_SMEM}
    if over or len(entries) != sum(map(len, ADMM_ENTRIES.values())):
        raise RuntimeError(f"build: entry functions {sorted(entries)}, "
                           f"shared memory over the limit: {over}")
    if bad:
        raise RuntimeError(f"build: stage entry points not taking the "
                           f"expected design and block size {STAGE_DESIGNS} "
                           f"with the layout Python computes: {bad}")
    if band_bad or len(ring) != len(admm_kernel.RING_TILES) * len(
            BAND_SOURCES):
        raise RuntimeError(f"build: #4 / #5 / #6 not taking the expected "
                           f"design "
                           f"{BAND_DESIGN_SHAPES} with the shared memory "
                           f"Python computes ({band_bad}), or ring kernels "
                           f"missing: {sorted(ring)}")


def phase_kernel_check(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    results = []
    # (label, K, batch, the design it must take, control gated?)
    cases = (("flagship K=10", 10, 256, "cluster", True),
             ("K=4", 4, 64, "cluster", False),
             ("K=12", 12, 32, "stream", True))
    for label, k, batch, want, gated in cases:
        cfg = bench_config(mtt)
        args, kw = stage_inputs(mtt, k, batch, seed=1, config=cfg)
        _, nfd, m_p = args[4].shape
        design = admm_kernel.factored_design(nfd, m_p, args[1].shape[1],
                                             args[1].shape[-1], kw["nb_p"])
        ours, plain, plain64, ref32 = run_three(admm_kernel, args, kw,
                                                design=design)
        again = admm_kernel.admm_stage_fused_factored(*args, init_z=True,
                                                      **kw)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(ours, again))
        d1, ok1 = compare_outputs(ours, plain, plain64, ref32)
        wrong = run_three(admm_kernel, args, kw, alpha=WRONG_ALPHA,
                          design=design)
        _, ctl_ok = compare_outputs(wrong[0], *wrong[1:3], wrong[3])
        # second stage: z/u carried in (u rescaled as the rho rebalancing
        # does), the kernel entered with init_z=False
        x1, z1, _, u1 = ref32[:4]
        args2 = args[:8] + (x1.contiguous(),)
        extra = (z1.contiguous(), (u1 * 0.5).contiguous())
        out2 = run_three(admm_kernel, args2, kw, extra, init_z=False,
                         design=design)
        d2, ok2 = compare_outputs(out2[0], *out2[1:3], out2[3])
        wrong2 = run_three(admm_kernel, args2, kw, extra, init_z=False,
                           alpha=WRONG_ALPHA, design=design)
        _, ctl2_ok = compare_outputs(wrong2[0], *wrong2[1:3], wrong2[3])
        results.append(dict(shapes=label, batch=batch, design=design,
                            expected_design=want, control_gated=gated,
                            gt_shape=list(args[4].shape),
                            n_iters=kw["n_iters"], init_z=d1, carried=d2,
                            bit_identical=identical,
                            within_tolerance=ok1 and ok2,
                            control_rejected=dict(init_z=not ctl_ok,
                                                  carried=not ctl2_ok)))
        del ours, plain, plain64, ref32, wrong, out2, wrong2
    emit("kernel_check", kernel="admm_stage_fused_factored",
         tolerance=KERNEL_TOL, tolerance_is="kernel vs plain f32 in the "
         "kernel's order (cluster design: admm_stage_fused_factored_winv_"
         "plain; stream design: the reference order) <= tolerance * max(1, "
         "max|x|) per output, and kernel vs plain f64 (reference order) <= "
         "3 * (plain f32 vs plain f64, reference order) + 1e-6 * "
         "max(1, max|x|)",
         control=f"the kernel with alpha {WRONG_ALPHA} for "
         f"{bench_config(mtt).alpha}, rejected at the flagship shape and at "
         f"K=12 (gated) and at K=4 (reported)", cases=results)
    bad = [r["shapes"] for r in results
           if not (r["within_tolerance"] and r["bit_identical"])]
    bad += [f"{r['shapes']}: takes the {r['design']} design, expected "
            f"{r['expected_design']}" for r in results
            if r["design"] != r["expected_design"]]
    bad += [f"{r['shapes']}: the control passes" for r in results
            if r["control_gated"] and not all(r["control_rejected"].values())]
    if bad:
        raise RuntimeError(f"kernel_check failed for {bad}")
    route_kernel_check(mtt)


# The kernels of the other KKT routes.  The stage kernels #2 and #7 are held
# to kernel 1's two criteria (KERNEL_TOL, compare_outputs): in their cluster
# designs against the plain version in that design's order
# (admm_stage_fused_winv_plain; #7's cluster of four: admm_stage_given_plain,
# m1 v summed as the blocks' partials in rank order), in their stream
# designs against the reference order; criterion 2 always against the
# reference order in float64 with the reference order's float32 error as the
# floor.  The band kernels
# #5 and #6 to: per output, max|kernel - plain f64| <= BAND_FACTOR * max|plain
# f32 - plain f64| + BAND_FLOOR * max(1, max|plain f64|).  Each check has a
# negative control that must fail it: #2 and #7 with alpha WRONG_ALPHA for
# the config's 1.6, #5 with rho times WRONG_RHO_FACTOR, #6 with the last row
# of G^T set to zero (the plain versions get the right inputs), and where
# they take the ring design both with its partials' combine short of the
# last warp (BAND_SKIP_COMBINE, a build variant); #7 in its cluster design
# also built with rank 3's partial left out of g (STAGE_DROP_RANK3).  The
# controls run at every shape and must be rejected at the flagship shape,
# the main path's, and at K=12 (#2 past its cluster design's budget); at K=2
# and K=4 the result is reported.  Each check of a kernel with two designs
# records the design its kernel took and fails where that is not the
# shape's (ROUTE_SHAPES; the band kernels': band_design's, held in the build
# phase).  #7 runs at every shape and at K=14 (GIVEN_STREAM_SHAPE), where it
# takes the stream design.  The band kernels run at every shape and on a
# random G^T of the flagship shape, at its band block (the ring) and at a
# block of 9 rows (the window body).
BAND_FACTOR = 2.0
BAND_FLOOR = 1e-6
WRONG_ALPHA = 1.62
WRONG_RHO_FACTOR = 1.001
# (label, K, batch, the design #2 must take, controls gated, the design #7
# must take)
ROUTE_SHAPES = (("K=2", 2, 256, "cluster", False, "cluster"),
                ("K=4", 4, 64, "cluster", False, "cluster"),
                ("flagship K=10", 10, 256, "cluster", True, "cluster"),
                ("K=12", 12, 32, "stream", True, "cluster"))
# #7 alone past its cluster design's budget, its control gated.
GIVEN_STREAM_SHAPE = ("K=14", 14, 32, "stream")
BAND_BLOCK = 15
# The band block of the random G^T's window case.
WINDOW_BLOCK = 9


def route_inputs(mtt, k, batch, seed, config):
    """Inputs of kernels #2, #5, #6 and #7 from a real assembly at the
    config's rho: the dense KKT inverse of the route the structure takes
    (K=2: the dense KKT; otherwise the banded route with kkt_apply="inverse"),
    xq = -W^-1 q, the objective band, and for #7 m1 = W^-1 G^T with z0/u0
    from one plain stage (u halved, as a rebalancing of rho would)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              linalg)
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    sc = mtt.make_inputs(k, batch, seed=seed)
    layout = qcqp._flagship_layout(sc.free)
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, config, None, layout,
                    warmstart_positions=sc.values[:, 1:-1, 0, :])
    gt = pre.gt.contiguous()
    bsz, nfd, _ = gt.shape
    rho = torch.full((bsz, 1, 1), config.rho, dtype=torch.float32,
                     device=gt.device)
    blk = banded.kkt_tridiag_block(sc.free)
    if blk is None:
        eye = torch.eye(nfd, dtype=gt.dtype, device=gt.device)
        pb_d = qcqp._kron_eye(pre.p_eq, 3)
        winv = linalg.spd_inverse(pb_d + rho * (gt @ gt.transpose(1, 2))
                                  + config.sigma * eye)
        pb_d = pb_d.reshape(bsz, 1, nfd, nfd).contiguous()
        pb_u = torch.zeros((bsz, 0, nfd, nfd), dtype=gt.dtype,
                           device=gt.device)
    else:
        band = qcqp._kkt_band(gt, pre.p_eq, blk, "xla")   # as stage_bits
        winv = banded.spd_block_tridiag_inverse_blocks(
            *qcqp._kkt_band_at(band, rho, config.sigma))
        pb_d, pb_u = band[0], band[1]
    winv = winv.contiguous()
    xq = -(winv @ pre.q_flat[:, :, None]).contiguous()
    fused = (rho, winv, gt, pre.b_pad.contiguous(),
             qcqp._rb_pad(pre.rb, layout), xq,
             pre.x_flat0[:, :, None].contiguous())
    kw = dict(n_iters=config.n_iters, alpha=config.alpha, nb_p=layout.nb_p,
              n_ball=layout.n_ball)
    x1, z1, _, u1 = admm_kernel.admm_stage_fused_plain(*fused, **kw)[:4]
    carried = (x1.contiguous(), z1.contiguous(), (0.5 * u1).contiguous())
    m1 = (winv @ gt).contiguous()
    stage = (rho, m1, gt, fused[3], fused[4], xq) + carried[1:]
    return dict(fused=fused, carried=carried, stage=stage, kw=kw, gt=gt,
                pb_d=pb_d, pb_u=pb_u, rho=rho, sigma=config.sigma)


def band_compare(names, ours, plain, plain64):
    """The band kernels' criterion stated above BAND_FACTOR, per output."""
    import torch
    out, ok = {}, True
    for name, a, b, c in zip(names, ours, plain, plain64):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"band kernel output {name}: bad shape or "
                               f"non-finite values")
        if a.numel() == 0:
            out[name] = dict(empty=True)
            continue
        e_k = float((a.double() - c).abs().max())
        e_p = float((b.double() - c).abs().max())
        scale = max(1.0, float(c.abs().max()))
        good = e_k <= BAND_FACTOR * e_p + BAND_FLOOR * scale
        out[name] = dict(kernel_vs_plain_f64=e_k, plain_vs_plain_f64=e_p,
                         kernel_vs_plain=float((a - b).abs().max()),
                         scale=scale, ok=good)
        ok = ok and good
    return out, ok


def triple(fn, fn_plain, args, kw, wrong_args=None, wrong_kw=None):
    """(kernel, kernel again, plain float32, plain float64) on the same
    inputs (``fn_plain`` the reference order); with ``wrong_*`` the kernel
    runs on those instead (a control)."""
    import torch
    k_args = args if wrong_args is None else wrong_args
    k_kw = kw if wrong_kw is None else wrong_kw
    ours = as_tuple(fn(*k_args, **k_kw))
    again = as_tuple(fn(*k_args, **k_kw))
    torch.cuda.synchronize()
    plain = as_tuple(fn_plain(*args, **kw))
    plain64 = as_tuple(fn_plain(*(to64(a) for a in args), **kw))
    same = all(torch.equal(a, b) for a, b in zip(ours, again))
    return ours, plain, plain64, same


def check(kernel, variant, fn, plain, args, kw, kind, *controls, twin=None,
          design=None, want=None):
    """One entry of ``run_checks``: the kernel ``fn`` against its plain
    version ``plain`` (the reference order) on ``args`` / ``kw`` by the
    criterion of ``kind`` ("stage" or "band"), and its negative controls,
    each (args, kw) or (args, kw, defines): the kernel built with the
    macros ``defines``.  For a stage kernel in a design that sums in another
    order, ``twin`` is the plain version in that order (criterion 1's
    yardstick); ``design`` the design the kernel took and ``want`` the one
    it must take (None: the shape's, ``run_checks``' ``want_design``)."""
    return dict(kernel=kernel, variant=variant, fn=fn, plain=plain,
                args=args, kw=kw, kind=kind, controls=controls, twin=twin,
                design=design, want=want)


def band_checks(ak, inp, blk=BAND_BLOCK):
    """The entries of ``route_checks`` for the band kernels #6 (both
    per_block values) and #5 at band block ``blk``, each with its design,
    the one ``band_design`` names (held to BAND_DESIGN_SHAPES in the build
    phase)."""
    gt = inp["gt"]
    gt_cut = gt.clone()
    gt_cut[:, -1, :] = 0.0
    rho_off = (inp["rho"] * WRONG_RHO_FACTOR).contiguous()
    band_args = (gt, inp["pb_d"], inp["pb_u"], inp["rho"])
    band_kw = dict(blk=blk, sigma=inp["sigma"])
    design = ak.band_design(gt.shape[1], gt.shape[2], blk).design
    want = "ring" if blk == BAND_BLOCK else "window"
    ring = ((band_args, band_kw, BAND_SKIP_COMBINE),) if design == "ring" \
        else ()
    out = []
    for per_block in (False, True):
        gkw = dict(blk=blk, per_block=per_block)
        ring_g = (((gt,), gkw, BAND_SKIP_COMBINE),) if ring else ()
        out.append(check("gram_band", f"per_block={per_block}", ak.gram_band,
                         ak.gram_band_plain, (gt,), gkw, "band",
                         ((gt_cut,), gkw), *ring_g, design=design,
                         want=want))
    out.append(check("gram_band_factors", "", ak.gram_band_factors,
                     ak.gram_band_factors_plain, band_args, band_kw, "band",
                     ((gt,) + band_args[1:3] + (rho_off,), band_kw), *ring,
                     design=design, want=want))
    return out


def fused_check_design(ak, gt, nb_p):
    """(design #2 takes for ``gt``'s shapes, the plain version in its
    order, or None for the reference order)."""
    design = ak.fused_design(gt.shape[1], gt.shape[2], nb_p)
    return design, (ak.admm_stage_fused_winv_plain if design == "cluster"
                    else None)


def given_checks(ak, inp, want):
    """The ``check`` entry of #7 for one shape: the design it takes (it
    must take ``want``), criterion 1 against the plain version in that
    design's order, the alpha control and, in the cluster design, the build
    without rank 3's partial."""
    kw = inp["kw"]
    _, nfd, m_p = inp["gt"].shape
    design = ak.given_design(nfd, m_p, kw["nb_p"])
    controls = [(inp["stage"], dict(kw, alpha=WRONG_ALPHA))]
    if design == "cluster":
        controls.append((inp["stage"], kw, STAGE_DROP_RANK3, "admm_stage"))
    return [check("admm_stage", "", ak.admm_stage, ak.admm_stage_plain,
                  inp["stage"], kw, "stage", *controls,
                  twin=ak.admm_stage_given_plain if design == "cluster"
                  else None, design=design, want=want)]


def route_checks(ak, inp, want_7):
    """The ``check`` entries for one shape: #2 (init_z True and False), #7
    (which must take the design ``want_7``) and the band kernels."""
    kw = inp["kw"]
    design, twin = fused_check_design(ak, inp["gt"], kw["nb_p"])
    out = []
    for init_z in (True, False):
        # a later stage: x, z, u carried in from one plain stage
        args = inp["fused"] if init_z else inp["fused"][:6] + inp["carried"]
        fkw = dict(kw, init_z=init_z)
        out.append(check("admm_stage_fused", f"init_z={init_z}",
                         ak.admm_stage_fused, ak.admm_stage_fused_plain,
                         args, fkw, "stage",
                         (args, dict(fkw, alpha=WRONG_ALPHA)), twin=twin,
                         design=design))
    return out + given_checks(ak, inp, want_7) + band_checks(ak, inp)


def random_band_inputs(batch=256, nfd=135, m_p=512, seed=3, blk=BAND_BLOCK):
    """Band-kernel inputs of the flagship shape with random entries.  In the
    real assemblies (K=2, 4, 10) every constraint row of G^T touches one
    free vertex, so their super-diagonal Gram band is exactly zero; these
    inputs hold gu and ub to a band that is not."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    m_blk = nfd // blk
    return dict(gt=rnd(batch, nfd, m_p), pb_d=rnd(batch, m_blk, blk, blk),
                pb_u=rnd(batch, m_blk - 1, blk, blk),
                rho=(0.01 + rnd(batch, 1, 1).abs()).contiguous(), sigma=1e-6)


def run_control(c, control):
    """The kernel of check ``c`` on a control's inputs, with the library
    (``control[3]``, default gram_band) built with the control's macros
    where it names any."""
    args, kw = control[:2]
    if len(control) == 2:
        return as_tuple(c["fn"](*args, **kw))
    name = control[3] if len(control) > 3 else "gram_band"
    with library_variant(name, control[2]):
        return as_tuple(c["fn"](*args, **kw))


def run_checks(label, shape, checks, controls_gate, cases, bad,
               want_design=None):
    """Each check of ``checks`` (``check`` entries): kernel against plain
    float32 (in the kernel's order) and the reference order in float64 by
    its kind's criterion, run to run, and the negative control; appends a
    summary to ``cases`` and what failed to ``bad``.  ``want_design``: the
    design each stage kernel with a cluster design must take here."""
    for c in checks:
        name, variant, kind = c["kernel"], c["variant"], c["kind"]
        ours, ref32, plain64, same = triple(c["fn"], c["plain"], c["args"],
                                            c["kw"])
        if kind == "stage":
            plain = (ref32 if c["twin"] is None
                     else c["twin"](*c["args"], **c["kw"]))
            res, ok = compare_outputs(ours, plain, plain64, ref32)
            judge = lambda out: compare_outputs(out, plain, plain64, ref32)
        else:
            names = ("db", "ub") if "factors" in name else ("gd", "gu")
            res, ok = band_compare(names, ours, ref32, plain64)
            judge = lambda out: band_compare(names, out, ref32, plain64)
        each = [not judge(run_control(c, ctl))[1] for ctl in c["controls"]]
        rejected = all(each)
        entry = dict(kernel=name, variant=variant, shapes=label,
                     gt_shape=list(shape), within_tolerance=ok,
                     bit_identical=same, control_rejected=rejected,
                     controls_rejected=[
                         dict(rejected=r, build=list(ctl[2])
                              if len(ctl) > 2 else None)
                         for r, ctl in zip(each, c["controls"])],
                     errors=res)
        want = c["want"] or want_design
        if c["design"] is not None:
            entry.update(design=c["design"])
            if kind == "stage":
                entry["plain_order"] = ("the design's (twin)"
                                        if c["twin"] is not None
                                        else "reference")
        checked = want is not None and c["design"] is not None
        if checked:
            entry["expected_design"] = want
        cases.append(entry)
        if not (ok and same):
            bad.append(f"{name} {variant} {label}")
        if checked and c["design"] != want:
            bad.append(f"{name} {variant} {label}: takes the {c['design']} "
                       f"design, expected {want}")
        if controls_gate and not rejected:
            bad.append(f"{name} {variant} {label}: the control passes")


def route_kernel_check(mtt):
    """#2 (init_z True and False), #7, #6 (both per_block values) and #5
    against their plain versions in float32 and float64 at K=2, K=4, K=10
    and K=12, and #7 at K=14 too, with the negative controls and the designs
    of #2, #7, #5 and #6; the band kernels also on a random G^T of the
    flagship shape, in the ring and (band block 9) in the window body."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    cases, bad = [], []
    for label, k, batch, want, gated, want_7 in ROUTE_SHAPES:
        inp = route_inputs(mtt, k, batch, seed=1, config=bench_config(mtt))
        run_checks(label, inp["gt"].shape,
                   route_checks(admm_kernel, inp, want_7), gated, cases,
                   bad, want_design=want)
        del inp
    label, k, batch, want_7 = GIVEN_STREAM_SHAPE
    inp = route_inputs(mtt, k, batch, seed=1, config=bench_config(mtt))
    run_checks(label, inp["gt"].shape, given_checks(admm_kernel, inp, want_7),
               True, cases, bad)
    del inp
    for blk in (BAND_BLOCK, WINDOW_BLOCK):
        inp = random_band_inputs(blk=blk)
        run_checks(f"random G^T, flagship shape, blk {blk}",
                   inp["gt"].shape, band_checks(admm_kernel, inp, blk), True,
                   cases, bad)
        del inp
    emit("kernel_check_routes", tolerance_is=dict(
        stage="as kernel_check (KERNEL_TOL, both criteria; #2's cluster "
        "design against admm_stage_fused_winv_plain, #7's against "
        "admm_stage_given_plain)",
        band=f"per output max|kernel - plain f64| <= {BAND_FACTOR} * "
        f"max|plain f32 - plain f64| + {BAND_FLOOR} * max(1, max|plain "
        f"f64|)"), controls=dict(
        stage_alpha=WRONG_ALPHA, gram_band_factors_rho_factor=
        WRONG_RHO_FACTOR, gram_band="last row of G^T zero",
        band_ring=f"both band kernels built with {BAND_SKIP_COMBINE}: the "
        "last warp's partial left out of every entry", admm_stage_cluster=
        f"#7 built with {STAGE_DROP_RANK3}: rank 3's partial of m1 v left "
        "out of g"), controls_gated_at=[r[0] for r in ROUTE_SHAPES if r[4]]
        + [GIVEN_STREAM_SHAPE[0]], cases=cases)
    torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"kernel_check (routes) failed for {bad}")


def solve(mtt, sc, cfg, n=None):
    sl = slice(None) if n is None else slice(0, n)
    return mtt.solve_qcqp_batch(
        sc.free, sc.d_fixed_free[sl], sc.times[sl], sc.waypoints[sl],
        sc.radii[sl], config=cfg, warmstart_values=sc.values[sl])


# Kernel path vs plain path of the WHOLE solve.  The cost is a sum of squares
# of derivatives that span decades, so at K=10 two float32 runs of the same
# algorithm differ by up to ~1e-3 relative in cost (measured: the plain
# float32 path is that far from the float64 path).  The kernel path must be
# no worse than float32 allows: its worst error against the plain float64
# path is at most 3x the plain float32 path's own worst error (a scenario
# that is far from converged amplifies any rounding, so the worst case has no
# useful absolute bound), and its MEDIAN error is inside absolute bounds:
# cost 2e-3 relative, violation 5e-4 absolute (the plain float32 path's own
# medians against float64 are ~3e-4 and ~1e-4; the feasibility gate is 1e-2).
PATH_COST_TOL = 2e-3
PATH_VIOLATION_TOL = 5e-4


def compare_paths(mtt, sc, cfg, n, kernels=("admm_stage_fused_factored",)):
    """Solve the first ``n`` scenarios through the kernels ``kernels``,
    through their plain versions in float32 and through their plain
    versions in float64; returns the error summary and whether the kernel
    path is within the stated bounds.  Reported beside, not gated: the plain
    versions in float32 in each kernel's own order (the twin of the design
    it takes, ``kernel_order_plain``), which sums as the kernel does."""
    kern = solve(mtt, sc, cfg, n)
    with plain_kernels(only=kernels):
        p32 = solve(mtt, sc, cfg, n)
        sc64 = sc._replace(**{f: getattr(sc, f).double() for f in (
            "d_fixed_std", "d_fixed_free", "times", "waypoints", "radii",
            "values")})
        p64 = solve(mtt, sc64, cfg, n)
    with plain_kernels(only=kernels, kernel_order=True):
        order32 = solve(mtt, sc, cfg, n)

    def errs(a, b):
        cost = (a.cost.double() - b.cost).abs() / b.cost.abs()
        viol = (a.max_violation.double() - b.max_violation).abs()
        return dict(cost=float(cost.max()), violation=float(viol.max()),
                    median_cost=float(cost.median()),
                    median_violation=float(viol.median()),
                    worst_violation_row=int(viol.argmax()))

    out = dict(
        n=n,
        max_rel_cost_diff=float(((kern.cost - p32.cost).abs()
                                 / p32.cost.abs()).max()),
        max_abs_violation_diff=float((kern.max_violation
                                      - p32.max_violation).abs().max()),
        kernel_vs_f64=errs(kern, p64), plain_f32_vs_f64=errs(p32, p64),
        kernel_order_f32_vs_f64=errs(order32, p64))
    ek, ep = out["kernel_vs_f64"], out["plain_f32_vs_f64"]
    ok = (ek["cost"] <= 3.0 * ep["cost"] + 1e-6
          and ek["violation"] <= 3.0 * ep["violation"] + 1e-7
          and ek["median_cost"] <= PATH_COST_TOL
          and ek["median_violation"] <= PATH_VIOLATION_TOL)
    return kern, out, ok


def phase_main_path(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              linalg)
    from mav_tube_trajectory_generation_tpu_torch.solver import (banded,
                                                                 linear, qcqp)
    k, batch, n_pass = 10, MAIN_BATCH, 5
    cfg = bench_config(mtt)
    sc = mtt.make_inputs(k, batch, seed=0)
    band_calls = []
    with recorded(admm_kernel, "gram_band", band_calls):
        solve(mtt, sc, cfg)                               # warm-up
    torch.cuda.synchronize()
    # #6's inputs as the default route gives them, for its kernels row
    if band_calls:
        state.setdefault("recorded", {})["gram_band"] = to_device(
            band_calls[0][:2], "cpu")
    del band_calls
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    before = 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_pass + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(n_pass):
        sol = solve(mtt, sc, cfg)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_pass
    pass_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n_pass)]
    ms = sum(pass_ms) / n_pass
    after = admm_kernel.launches["admm_stage_fused_factored"]
    band_launches = admm_kernel.launches["gram_band"]
    others = {n: v for n, v in admm_kernel.launches.items()
              if v and n not in ("admm_stage_fused_factored", "gram_band")}
    state["launches"] = after - before
    state["spd_launches"] = spd_launches = linalg.launches
    state["main_band_launches"] = band_launches
    state["main_passes"] = n_pass
    peak = torch.cuda.max_memory_allocated()
    state["headline_peak"] = peak

    finite = torch.isfinite(sol.cost) & torch.isfinite(sol.max_violation)
    feasible = int((finite & (sol.max_violation < 1e-2)).sum())
    median_viol = float(sol.max_violation.median())
    shapes_ok = (sol.coefficients.shape == (batch, k, 10, 3)
                 and sol.d_free.shape == (batch, 45, 3)
                 and sol.cost.shape == (batch,))

    # A 512-scenario prefix through the plain version on the card.
    n_pre = 512
    _, prefix, prefix_ok = compare_paths(mtt, sc, cfg, n_pre)
    # For scale: the cost of the position-constrained linear solve the warm
    # start equals (the QCQP trades it against corridor feasibility).
    lin = linear.solve_linear(sc.std, sc.d_fixed_std[:n_pre],
                              sc.times[:n_pre])

    # Per-phase times of one pass (CUDA events, each piece run alone).
    layout = qcqp._flagship_layout(sc.free)
    blk = banded.kkt_tridiag_block(sc.free)
    wp = sc.values[:, 1:-1, 0, :]
    parts = {}
    parts["objective_and_warm_start_ms"] = cuda_ms(
        lambda: qcqp._objective_blocks(sc.free, sc.d_fixed_free, sc.times,
                                       cfg, None, warmstart_positions=wp), 3)
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, cfg, None, layout, warmstart_positions=wp)
    parts["pre_total_ms"] = cuda_ms(
        lambda: qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                          sc.radii, cfg, None, layout,
                          warmstart_positions=wp), 3)
    # the band on the route the config takes here, named beside it
    band_route = qcqp._band_route(pre.gt, cfg.band_gram)
    parts["gram_and_band_ms"] = cuda_ms(
        lambda: qcqp._kkt_band(pre.gt, pre.p_eq, blk, cfg.band_gram), 3)
    band = qcqp._kkt_band(pre.gt, pre.p_eq, blk, cfg.band_gram)
    rho = torch.full((batch, 1, 1), cfg.rho, dtype=torch.float32,
                     device=pre.gt.device)
    parts["band_factor_and_xq_ms"] = cuda_ms(
        lambda: qcqp._stage_factors(band, rho, cfg.sigma, pre.q_flat), 3)
    dblk = band[0] + rho[:, None] * band[2]
    parts["cholesky_inverse_15x15_ms"] = cuda_ms(
        lambda: [linalg.spd_inverse(dblk[:, i]) for i in range(9)], 3)
    outs = qcqp._run_stages(cfg, pre, layout, blk)
    parts["run_stages_total_ms"] = cuda_ms(
        lambda: qcqp._run_stages(cfg, pre, layout, blk), 3)
    parts["post_ms"] = cuda_ms(
        lambda: qcqp._post(sc.free, cfg, sc.d_fixed_free, sc.times, pre,
                           outs[0], outs[2], outs[3], outs[4], outs[5],
                           outs[6]), 3)
    del pre, band, outs, dblk

    emit("main_path", config="K=10 N=10 D=3 min-snap QP+QCQP, radii 0.8, "
         "1 stage x 48 iterations, warm start from vertex values",
         batch=batch, passes=n_pass, ms_per_batch=ms, pass_ms=pass_ms,
         wall_ms_per_batch=wall_ms, solves_per_s=batch / (ms * 1e-3),
         feasible_at_1e_2=feasible, min_feasible=MIN_FEASIBLE,
         median_max_violation=median_viol,
         max_median_violation=MAX_MEDIAN_VIOLATION,
         converged=int(sol.converged.sum()),
         median_cost=float(sol.cost.median()),
         median_warm_start_cost=float(lin.cost.median()),
         peak_device_memory_bytes=peak,
         admm_stage_fused_factored_design=admm_kernel.factored_design(
             135, 512, 9, 15, 128), launches_before=before,
         launches_after=after, launches_per_pass=(after - before) / n_pass,
         spd_inverse_launches_per_pass=spd_launches / n_pass,
         gram_band_launches_per_pass=band_launches / n_pass,
         plain_prefix=prefix,
         phase_ms=parts, gram_and_band_route=band_route,
         nvidia_smi=state.get("nvidia_smi"))
    if not shapes_ok:
        raise RuntimeError("main_path: unexpected output shapes")
    if after - before != cfg.n_stages * n_pass or others:
        raise RuntimeError(f"main_path: {after - before} kernel launches in "
                           f"{n_pass} passes, expected {cfg.n_stages} each; "
                           f"other stage kernels launched: {others}")
    if spd_launches != SPD_INVERSE_LAUNCHES * n_pass:
        raise RuntimeError(f"main_path: {spd_launches} launches of the small "
                           f"SPD inverse in {n_pass} passes, expected "
                           f"{SPD_INVERSE_LAUNCHES} each")
    if band_launches != GRAM_BAND_LAUNCHES * n_pass:
        raise RuntimeError(f"main_path: {band_launches} launches of the Gram "
                           f"band kernel in {n_pass} passes, expected "
                           f"{GRAM_BAND_LAUNCHES} each")
    if feasible < MIN_FEASIBLE or not median_viol <= MAX_MEDIAN_VIOLATION:
        raise RuntimeError(f"main_path quality: {feasible}/{batch} feasible, "
                           f"median violation {median_viol:.3e}")
    if not prefix_ok:
        raise RuntimeError(f"main_path: kernel and plain paths disagree: "
                           f"{prefix}")


def phase_multi_stage(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    cfg = bench_config(mtt, n_stages=2, n_iters=24)
    sc = mtt.make_inputs(10, 512, seed=2)
    before = admm_kernel.launches["admm_stage_fused_factored"]
    kern, cmp, ok = compare_paths(mtt, sc, cfg, None)
    torch.cuda.synchronize()
    launched = admm_kernel.launches["admm_stage_fused_factored"] - before
    feasible = int((kern.max_violation < 1e-2).sum())
    emit("multi_stage", n_stages=2, n_iters=24, batch=512,
         kernel_launches=launched, feasible_at_1e_2=feasible,
         median_max_violation=float(kern.max_violation.median()),
         rho_rebalanced=bool((kern.dual_residual > 0).all()), **cmp)
    if launched != 2:
        raise RuntimeError(f"multi_stage: {launched} launches, expected 2")
    if not torch.isfinite(kern.cost).all():
        raise RuntimeError("multi_stage: non-finite cost")
    if not ok:
        raise RuntimeError(f"multi_stage: kernel and plain paths disagree: "
                           f"{cmp}")


@contextlib.contextmanager
def recorded(module, name, sink):
    """Append (args, kwargs, outputs) of every call of ``module.name`` to
    ``sink`` while the block runs."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append((args, kwargs, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


ADMM_WRAPPERS = ("admm_stage_fused_factored", "admm_stage_fused",
                 "admm_stage", "gram_band", "gram_band_factors",
                 "admm_stage_fused_factored_ew", "gram_band_factors_ew")
IPM_WRAPPERS = ("gt_matvec", "ipm_eval_step", "ipm_pipe_step",
                "ipm_solve_fused")


def kernel_order_plain(ak, name):
    """The plain version of stage wrapper ``name`` that sums, call by call,
    in the order of the design the kernel takes for the call's shapes: the
    twin of a cluster design, the reference order otherwise."""
    twins = {"admm_stage_fused_factored":
             ak.admm_stage_fused_factored_winv_plain,
             "admm_stage_fused": ak.admm_stage_fused_winv_plain,
             "admm_stage_fused_factored_ew":
             ak.admm_stage_fused_factored_ew_winv_plain}
    reference = getattr(ak, name + "_plain")
    if name not in twins:
        return reference

    def plain(*args, **kw):
        if name == "admm_stage_fused":
            design = fused_check_design(ak, args[2], kw["nb_p"])[0]
        elif name == "admm_stage_fused_factored_ew":
            design = ew_stage_design(ak, args, kw["nb_p"])[0]
        else:
            gt, sinv = args[4], args[1]
            design = ak.factored_design(gt.shape[1], gt.shape[2],
                                        sinv.shape[1], sinv.shape[-1],
                                        kw["nb_p"])
        return (twins[name] if design == "cluster" else reference)(*args,
                                                                  **kw)
    return plain


@contextlib.contextmanager
def plain_kernels(only=None, kernel_order=False):
    """Route every kernel wrapper of the port to its plain PyTorch version,
    or with ``only`` just the wrappers so named (used only to compare; the
    port itself never does this): the reference order, or with
    ``kernel_order`` each stage kernel's own (``kernel_order_plain``)."""
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    names = only or ADMM_WRAPPERS + IPM_WRAPPERS
    mods = [admm_kernel if n in ADMM_WRAPPERS else ipm_kernel for n in names]
    kept = [getattr(m, n) for m, n in zip(mods, names)]
    for m, n in zip(mods, names):
        plain = (kernel_order_plain(m, n) if kernel_order and m is admm_kernel
                 else getattr(m, n + "_plain"))
        setattr(m, n, plain)
    try:
        yield
    finally:
        for m, n, fn in zip(mods, names, kept):
            setattr(m, n, fn)


def to_device(call, device):
    """The (args, kwargs) of a recorded call with its tensors on ``device``.
    Recorded calls wait on the host for the `kernels` phase, so that each
    path's peak device memory is its own."""
    import torch
    args, kw = call
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args), kw


def as_tuple(out):
    import torch
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def row_errors(a, b):
    """(B,) worst absolute difference per scenario; equal values (also equal
    infinities) and NaN on both sides count 0, NaN on one side inf."""
    import torch
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return d.amax(dim=1)


def compare_ipm(names, ours, plain, plain64, uncapped=()):
    """The three criteria stated above IPM_ROW_TOL for every output
    (criterion 3 not for the outputs in ``uncapped``); returns the summary
    and whether they hold."""
    import torch
    bsz = ours[0].shape[0]
    slack = max(2, int(IPM_GROSS_SLACK * bsz))
    used = [q for q in IPM_QUANTILES if (1.0 - q) * bsz >= IPM_TAIL_ROWS]
    summary, ok = {}, True

    def quantiles(e):
        e = torch.clamp(e, max=1e30)                       # inf: a NaN row
        return [float(torch.quantile(e, q)) for q in used]

    for name, a, b, c in zip(names, ours, plain, plain64):
        fin = torch.isfinite(c)
        scale = max(1e-30, float(c[fin].abs().max()) if fin.any() else 0.0)
        e_kp = row_errors(a, b) / scale
        e_k = row_errors(a, c) / scale
        e_p = row_errors(b, c) / scale
        q_k, q_p = quantiles(e_k), quantiles(e_p)
        gross_k = int((e_k > IPM_GROSS).sum())
        gross_p = int((e_p > IPM_GROSS).sum())
        capped = name not in uncapped
        good = (a.shape == b.shape
                and all(k <= IPM_DIST_FACTOR * p_ + IPM_FLOOR
                        for k, p_ in zip(q_k, q_p))
                and gross_k <= 2 * gross_p + slack
                and (not capped or gross_k <= IPM_GROSS_CAP * bsz + slack))
        ok = ok and good
        summary[name] = dict(
            scale=scale, quantiles=used, kernel_vs_plain_f64=q_k,
            plain_vs_plain_f64=q_p, gross_rows=gross_k,
            gross_rows_plain_f32=gross_p, gross_rows_capped=capped,
            kernel_vs_plain_max=float(e_kp.max()),
            kernel_vs_plain_f64_max=float(e_k.max()),
            plain_vs_plain_f64_max=float(e_p.max()),
            rows_outside=int((e_kp > IPM_ROW_TOL).sum()), ok=good)
    return summary, ok


def to64(x):
    import torch
    return x.double() if isinstance(x, torch.Tensor) else x


def check_call(fn, fn_plain, names, args, kwargs, ours=None, uncapped=()):
    """Kernel, plain float32 and plain float64 on the same inputs; the kernel
    twice for bit identity.  All errors are shares of the output's scale."""
    import torch
    first = as_tuple(fn(*args, **kwargs)) if ours is None else as_tuple(ours)
    again = as_tuple(fn(*args, **kwargs))
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        for a, b in zip(first, again))
    plain = as_tuple(fn_plain(*args, **kwargs))
    plain64 = as_tuple(fn_plain(*(to64(a) for a in args), **kwargs))
    summary, ok = compare_ipm(names, first, plain, plain64, uncapped)
    worst = max(summary, key=lambda n: summary[n]["kernel_vs_plain_max"])
    res = dict(bit_identical=identical, within_tolerance=ok,
               worst_output=worst,
               worst_scaled_err=summary[worst]["kernel_vs_plain_max"],
               median_scaled_err_vs_plain_f64=max(
                   v["kernel_vs_plain_f64"][0] for v in summary.values()),
               plain_f32_median_scaled_err_vs_plain_f64=max(
                   v["plain_vs_plain_f64"][0] for v in summary.values()),
               gross_rows=max(v["gross_rows"] for v in summary.values()),
               gross_rows_plain_f32=max(v["gross_rows_plain_f32"]
                                        for v in summary.values()),
               rows_outside=max(v["rows_outside"] for v in summary.values()))
    if not ok:
        res["outputs"] = summary
    return res, ok and identical, summary


def fused_uncapped(kw):
    """The outputs of one whole-polish call that criterion 3 does not cap."""
    if kw["n_iters"] > IPM_SHORT_RUN:
        return ("best_merit", "lam_fin", "lam_fin_max")
    return ("best_merit",)


def gram_band_mismatch(gram, hd, hu, blk):
    """Worst difference between the diagonal and super-diagonal blocks of a
    full (B, nfd, nfd) Gram and a band (hd (B, nfd, blk), hu (B, nfd - blk,
    blk)), as a share of the band's largest entry."""
    import torch
    bsz, nfd, _ = gram.shape
    m_blk = nfd // blk
    g5 = gram.reshape(bsz, m_blk, blk, m_blk, blk)
    gd = torch.stack([g5[:, i, :, i, :] for i in range(m_blk)], dim=1)
    gu = torch.stack([g5[:, i, :, i + 1, :] for i in range(m_blk - 1)], dim=1)
    scale = max(float(hd.abs().max()), 1e-30)
    return max(float((gd.reshape(hd.shape) - hd).abs().max()),
               float((gu.reshape(hu.shape) - hu).abs().max())) / scale


def polish_residual(ipm_kernel, args, kw, y):
    """(B,) scaled primal residual max over the active lanes of max(c, 0) at
    y, float32 (what fused_class reads)."""
    import torch
    rb, act = args[2], args[10]
    c = ipm_kernel._c_lanes_k(y.float(), rb, kw["nb_p"], kw["n_ball"])
    return torch.where(act > 0, torch.clamp(c, min=0.0),
                       torch.zeros_like(c)).amax(dim=2)[:, 0]


def fused_class(ipm_kernel, args, kw, ours):
    """Where a whole polish ends, beside the row criteria: the scaled primal
    residual max(c, 0) of the kernel's final point, per scenario, has a
    median and a tail quantile at most 3x the plain float32 version's plus
    5e-5 and 5e-4 (c = 0.5 (|y|^2 - r^2) with |y|^2 of 1e2 to 1e3 in scaled
    space resolves 8e-6 to 6e-5 in float32, so a median of exactly 0 in one
    run and of one such step in the other are the same result), and is
    finite in every row.  The tail quantile is the 99th percentile where
    IPM_TAIL_ROWS rows lie beyond it, else the highest of IPM_QUANTILES that
    has as many beyond it (the 90th at 64 and 256 rows): the rule the row
    criteria follow.  And what the dynamic infeasibility certificate reads,
    the growth lam_fin_max / lam_mid of the largest multiplier over the
    second half of the Newton steps: the scenarios where it exceeds the
    certificate's threshold (IPMConfig.infeas_growth) number at most twice
    the plain float32 version's plus IPM_GROSS_SLACK of the batch (at least
    2).  Reported besides: the rows that start above 5e-4 (the residual of
    y0) and end no lower, in either run."""
    import torch
    plain = ipm_kernel.ipm_solve_fused_plain(*args, **kw)

    def residual(y):
        return polish_residual(ipm_kernel, args, kw, y)

    def growing(outs):
        g = outs[7][:, 0, 0] / torch.clamp(outs[6][:, 0, 0], min=1e-30)
        return int((g > FUSED_INFEAS_GROWTH).sum()) if kw["n_iters"] else 0

    r_k, r_p, r_0 = residual(ours[1]), residual(plain[1]), residual(args[9])
    q = lambda r, p: float(torch.quantile(r.double(), p))
    bsz = r_k.shape[0]
    tail = max([p for p in IPM_QUANTILES
                if (1.0 - p) * bsz >= IPM_TAIL_ROWS] or [0.5])
    stalled = lambda r: int(((r_0 > 5e-4) & (r >= r_0)).sum())
    out = dict(kernel_median=q(r_k, 0.5), plain_median=q(r_p, 0.5),
               tail_quantile=tail, kernel_tail=q(r_k, tail),
               plain_tail=q(r_p, tail),
               kernel_p99=q(r_k, 0.99), plain_p99=q(r_p, 0.99),
               kernel_max=float(r_k.max()), plain_max=float(r_p.max()),
               kernel_rows_stalled=stalled(r_k),
               plain_rows_stalled=stalled(r_p),
               kernel_rows_multiplier_growing=growing(ours),
               plain_rows_multiplier_growing=growing(plain))
    slack = max(2, int(IPM_GROSS_SLACK * bsz))
    ok = (bool(torch.isfinite(r_k).all())
          and out["kernel_median"] <= 3.0 * out["plain_median"] + 5e-5
          and out["kernel_tail"] <= 3.0 * out["plain_tail"] + 5e-4
          and out["kernel_rows_multiplier_growing"]
          <= 2 * out["plain_rows_multiplier_growing"] + slack)
    return out, ok


@contextlib.contextmanager
def counting_floors(ipm_kernel, sink, kw):
    """While the block runs, each call of the plain band factor
    (``ipm_kernel._band_factor_solve``) ORs into ``sink[(dtype, step)]`` the
    (B,) mask of the scenarios in which the floor lifts one of its pivots
    (the shift E it reports is positive, or a pivot of a finite band is
    NaN): the rows where the port's factor solves H + E, not H as the JAX
    kernel's does.  ``step`` is "newton" or "snap": every polish run in the
    block has ``kw``'s schedule, whose first n_iters factors of a dtype are
    its Newton steps and the next snap_iters its snap sweeps."""
    import torch
    keep = ipm_kernel._band_factor_solve
    steps, calls = kw["n_iters"] + kw["snap_iters"], {}

    def spy(gd, gu, pe_d, pe_u, reg, rhs, blk):
        dx, shift = keep(gd, gu, pe_d, pe_u, reg, rhs, blk,
                         return_shift=True)
        dt = str(gd.dtype).replace("torch.", "")
        i = calls.get(dt, 0)
        calls[dt] = i + 1
        step = "newton" if i % steps < kw["n_iters"] else "snap"
        finite = torch.stack([torch.isfinite(t).flatten(1).all(1)
                              for t in (gd, gu, pe_d, pe_u)]).all(0)
        hit = ((shift > 0) | (torch.isnan(shift) & finite[:, None, None])
               ).flatten(1).any(1)
        key = (dt, step)
        sink[key] = sink[key] | hit if key in sink else hit
        return dx

    ipm_kernel._band_factor_solve = spy
    try:
        yield
    finally:
        ipm_kernel._band_factor_solve = keep


def floored_counts(sink):
    """{dtype: {step: rows}} of a counting_floors sink."""
    out = {}
    for (dt, step), v in sorted(sink.items()):
        out.setdefault(dt, {})[step] = int(v.sum())
    return out


# A kernel that is wrong by a little must fail the row criteria.  The
# whole-polish kernel is run for one Newton step with one scalar off (the
# plain versions get the right one): the fraction-to-boundary factor 0.995 ->
# 0.9 shortens every boundary-limited step by a tenth; the centring 0.3 ->
# 0.33 moves the right-hand side by a tenth of its centring term, which is
# above float32's own error only where the system is well conditioned, so
# that control is asked for where plain float32's median error of x_fin is
# under 1e-4 of scale (K=4; at K=10 it is 2e-4 to 3e-4 and the run is
# reported only).  A whole polish has no such control: ten steps and two
# sweeps land at the same optimum whatever the path, which is what the long
# runs are held to.
FUSED_CONTROLS = (("tau", 0.9), ("sigma_min", 0.33))


def fused_controls_rejected(ipm_kernel, args, kw, summary):
    """({scalar: rejected?}, whether every control that must be rejected
    was) for the perturbed one-step kernel runs above; ``summary`` is the
    right kernel's comparison on the same call."""
    out, ok = {}, True
    well_conditioned = summary["x_fin"]["plain_vs_plain_f64"][0] < 1e-4
    for name, value in FUSED_CONTROLS:
        wrong = ipm_kernel.ipm_solve_fused(*args, **dict(kw, **{name: value}))
        res, _, _ = check_call(ipm_kernel.ipm_solve_fused,
                               ipm_kernel.ipm_solve_fused_plain, FUSED_OUT,
                               args, kw, ours=wrong,
                               uncapped=fused_uncapped(kw))
        out[name] = not res["within_tolerance"]
        if name == "tau" or well_conditioned:
            ok = ok and out[name]
    return out, ok


def factor_alone(ipm_kernel, args, kw, ours, defines=()):
    """Which part of the whole polish loses the snap direction, on one
    snap-only call (n_iters 0): the kernel built with IPM_SOLVE_DUMP writes,
    for every scenario, the band its first sweep factors, the right-hand
    side and the direction its factor gives.  That band is held against the
    band #9 forms at the same point and against the plain version's in
    float64 (per scenario, the largest entry difference over the largest
    entry), and the kernel's direction against the same band solved by the
    plain factor in float32 and in float64 (per scenario, |dx - dx64| /
    |dx64|); the float64 direction of the float64 band is the true one.  And
    for each direction, whether the seven-point line search (phi evaluated in
    float64) finds a step that lowers phi = sum cw max(c, 0)^2.  On the rows
    whose two sweeps stall (the residual of the kernel's end point no lower
    than at the start, fused_class's rule), the part at fault is the factor
    if the kernel's own band, solved in float64, gives a step there that the
    kernel's direction does not, else the band if the float64 band's
    direction gives one that the kernel's band solved in float64 does not,
    else neither.  ``ours``: the call's outputs in the design the shape
    takes, which the dump build must repeat bit for bit.  The plain factor
    is the port's (the floored block Cholesky) in both precisions.  Over
    all rows besides: those where the kernel's own band solved in float64
    gives a step and the kernel's direction does not
    (``rows_lost_by_factor``).  ``defines``: more macros of the build (the
    library the wrappers hold must have been built with them too)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch import _build
    gt, b, rb, pe_d, pe_u = args[:5]
    x0, y0, act, cw = args[6], args[9], args[10], args[11]
    nb_p, n_ball, blk, rho = (kw["nb_p"], kw["n_ball"], kw["blk"],
                              kw["snap_rho"])
    bsz, nfd, _ = gt.shape
    m_blk = nfd // blk
    nhd, nband = nfd * blk, (2 * m_blk - 1) * blk * blk
    defines = IPM_SOLVE_DUMP + tuple(defines)
    lib = _build.variant("ipm_solve", defines)
    lib.ipm_solve_dump_set.argtypes = [ctypes.c_void_p]
    lib.ipm_solve_dump_set.restype = ctypes.c_int
    dump = torch.full((bsz, nband + 2 * nfd), float("nan"),
                      dtype=torch.float32, device=gt.device)
    if lib.ipm_solve_dump_set(dump.data_ptr()) != 0:
        raise RuntimeError("factor_alone: cudaMemcpyToSymbol failed")
    with library_variant("ipm_solve", defines):
        again = ipm_kernel.ipm_solve_fused(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, o) for a, o in zip(again, ours))
    cls, _ = fused_class(ipm_kernel, args, kw, again)
    hd_k = dump[:, :nhd].reshape(bsz, m_blk, blk, blk)
    hu_k = dump[:, nhd:nband].reshape(bsz, m_blk - 1, blk, blk)
    rhs_k = dump[:, nband:nband + nfd, None]
    dx_k = dump[:, nband + nfd:, None]

    def point(dt):
        c = ipm_kernel._c_lanes_k(y0.to(dt), rb.to(dt), nb_p, n_ball)
        lam = torch.where((c > -3.0 / rho) & (act > 0),
                          torch.full_like(c, 1e-6), torch.zeros_like(c))
        return (gt.to(dt), b.to(dt), rb.to(dt), x0.to(dt), lam / rho, lam)

    def with_pe(hd, hu, dt):
        eye = torch.eye(blk, dtype=dt, device=gt.device)
        return (hd.reshape(bsz, m_blk, blk, blk) + pe_d.to(dt) + 1e-6 * eye,
                hu.reshape(bsz, m_blk - 1, blk, blk) + pe_u.to(dt))

    ekw = dict(nb_p=nb_p, n_ball=n_ball, w_cap=rho, phr=True, band_block=blk)
    e9 = ipm_kernel.ipm_eval_step(*point(torch.float32), **ekw)
    e64 = ipm_kernel.ipm_eval_step_plain(*point(torch.float64), **ekw)
    band9, band64 = with_pe(*e9[4:], torch.float32), with_pe(
        *e64[4:], torch.float64)

    def solve(hd, hu, rhs):
        zd, zu = torch.zeros_like(hd), torch.zeros_like(hu)
        return ipm_kernel._band_factor_solve(hd, hu, zd, zu, 0.0, rhs, blk)

    d64 = solve(*band64, -e64[2])                     # the true direction
    d64_k = solve(hd_k.double(), hu_k.double(), rhs_k.double())
    d32_k = solve(hd_k, hu_k, rhs_k)

    def band_err(hd, hu):
        a = torch.cat([hd.reshape(bsz, -1), hu.reshape(bsz, -1)], 1).double()
        ref = torch.cat([band64[0].reshape(bsz, -1),
                         band64[1].reshape(bsz, -1)], 1)
        return (a - ref).abs().amax(1) / ref.abs().amax(1)

    def rel(a, ref):
        a, ref = a.double()[:, :, 0], ref.double()[:, :, 0]
        return (a - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-300)

    y64 = y0.double()

    def phi(y):
        c = ipm_kernel._c_lanes_k(y, rb.double(), nb_p, n_ball)
        v = torch.clamp(c, min=0.0)
        return (cw.double() * v * v).sum(dim=2)[:, 0]

    def descends(dx):
        gdx = ipm_kernel.gt_matvec_plain(gt.double(), dx.double())
        p0 = phi(y64)
        best = torch.stack([phi(y64 + a * gdx)
                            for a in ipm_kernel.SNAP_ALPHAS]).amin(0)
        return best < p0

    def residual(y):
        return polish_residual(ipm_kernel, args, kw, y)

    r0 = residual(y0)
    stalled = (r0 > 5e-4) & (residual(again[1]) >= r0)
    errs = dict(band_kernel_vs_f64=band_err(hd_k, hu_k),
                band_9_vs_f64=band_err(*band9),
                dx_kernel_vs_f64_of_kernel_band=rel(dx_k, d64_k),
                dx_plain_f32_vs_f64_of_kernel_band=rel(d32_k, d64_k),
                dx_f64_of_kernel_band_vs_true=rel(d64_k, d64),
                dx_kernel_vs_true=rel(dx_k, d64))
    steps = dict(kernel=descends(dx_k), plain_f32_of_kernel_band=descends(
        d32_k), f64_of_kernel_band=descends(d64_k), true=descends(d64))

    def on(mask):
        if not bool(mask.any()):
            return None
        return dict(rows=int(mask.sum()),
                    median={n: float(e[mask].median()) for n, e in
                            errs.items()},
                    worst={n: float(e[mask].max()) for n, e in errs.items()},
                    rows_where_a_step_lowers_phi={
                        n: int(s[mask].sum()) for n, s in steps.items()})

    s = stalled
    factor = int((s & steps["f64_of_kernel_band"] & ~steps["kernel"]).sum())
    band = int((s & steps["true"] & ~steps["f64_of_kernel_band"]).sum())
    at_fault = ("factor" if factor and factor >= band else
                "band" if band else "neither")
    del dump, e9, e64, band9, band64, d64, d64_k, d32_k
    lost = int((steps["f64_of_kernel_band"] & ~steps["kernel"]).sum())
    return dict(residual_class=cls, kernel_run_bit_identical_with_dump=same,
                stalled_rows=on(stalled), all_rows=on(torch.ones_like(
                    stalled)), stalled_rows_lost_by_factor=factor,
                stalled_rows_lost_by_band=band, part_at_fault=at_fault,
                rows_lost_by_factor=lost)


def wide_fused_report(mtt, label, k):
    """The six whole polishes of ``record_lanes`` at FUSED_WIDE_ROWS rows of
    seed 1, each held to the residual class (its 99th percentile at this
    batch) and the row criteria, reported; on the snap-only polish, the
    factor-alone check, gated: no row where the kernel's own band solved in
    float64 gives a step and the kernel's direction does not (what the
    pivot floor is for; ``ops.ipm_kernel.PIVOT_FLOOR``).  Returns (cases,
    failures)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    fused_calls = record_lanes(mtt, k, FUSED_WIDE_ROWS, seed=1)[3]
    out, bad = [], []
    for args, kw, ours in fused_calls:
        floors = {}
        with counting_floors(ipm_kernel, floors, kw):
            res, ok, summary = check_call(
                ipm_kernel.ipm_solve_fused, ipm_kernel.ipm_solve_fused_plain,
                FUSED_OUT, args, kw, ours=ours, uncapped=fused_uncapped(kw))
            cls, cls_ok = fused_class(ipm_kernel, args, kw, ours)
        # the same tail of the plain version summed in the cluster's order:
        # how far two float32 orders of one polish part there
        r_c = polish_residual(ipm_kernel, args, kw,
                              ipm_kernel.ipm_solve_fused_cluster_plain(
                                  *args, **kw)[1])
        cls["plain_cluster_order_tail"] = float(
            torch.quantile(r_c.double(), cls["tail_quantile"]))
        out.append(dict(
            kernel="ipm_solve_fused", shapes=label, gated=False,
            gt_shape=list(args[0].shape), n_iters=kw["n_iters"],
            snap_iters=kw["snap_iters"], row_criteria_hold=ok,
            plain_rows_flooring_a_pivot=floored_counts(floors),
            outputs_failing_row_criteria=[
                n for n, v in summary.items() if not v["ok"]],
            residual_class_holds=cls_ok, residual_class=cls))
        if (kw["n_iters"], kw["snap_iters"]) == (0, 2):
            alone = factor_alone(ipm_kernel, args, kw, ours)
            out.append(dict(kernel="ipm_solve_fused factor alone",
                            shapes=label, gt_shape=list(args[0].shape),
                            gated=True, **alone))
            if alone["rows_lost_by_factor"]:
                bad.append(f"factor alone {label}: the kernel's direction "
                           f"loses {alone['rows_lost_by_factor']} rows")
    del fused_calls
    torch.cuda.empty_cache()
    return out, bad


def record_lanes(mtt, k, batch, seed, fused=True):
    """Calls of the interior-point kernels recorded from real solves: an
    ADMM tier-0 solve, then pipelined polishes that reach all seven mode
    pairs, a scan polish (eval with phr off and on, matvec) and (``fused``)
    six fused polishes (the default schedule, snap-only, and short ones).
    The ADMM start takes the dense Gram's band ("xla"), named: ``ipm_bits``
    holds the kernels' digests on these calls to the parent tree's, and
    the row checks' bars were set on them; the band kernel #6, the
    default's on the card, moves every start by float32 rounding."""
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    sc = mtt.make_inputs(k, batch, seed=seed)
    pipe_calls, eval_calls, mv_calls, fused_calls = [], [], [], []

    def polish(**cfg):
        return mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=route_config(mtt, band_gram="xla"),
            ipm_config=mtt.IPMConfig(sigma_min=0.3, corrector=False, **cfg),
            warmstart_values=sc.values)

    with recorded(ipm_kernel, "ipm_pipe_step", pipe_calls):
        polish(n_iters=0, snap_iters=2, pipelined=True)
        polish(n_iters=3, snap_iters=1, pipelined=True)
        polish(n_iters=2, snap_iters=0, pipelined=True)
    with recorded(ipm_kernel, "ipm_eval_step", eval_calls), \
            recorded(ipm_kernel, "gt_matvec", mv_calls):
        polish(n_iters=2, snap_iters=1)
    with recorded(ipm_kernel, "ipm_solve_fused", fused_calls):
        for n_iters, snap_iters in ((10, 2), (0, 2), (1, 0), (1, 1), (2, 1),
                                    (3, 0)) if fused else ():
            polish(n_iters=n_iters, snap_iters=snap_iters, fused=True)
    pairs = {}
    for call in pipe_calls:
        key = (call[1]["upd_mode"], call[1]["eval_mode"])
        # keep the LAST call of a pair: the state is furthest from the start
        pairs[key] = call
    return pairs, eval_calls, mv_calls, fused_calls


# dense_path and band_gram: the other KKT routes of solve_qcqp_batch at batch
# 6144, seed 0, on the headline config.  Bars fixed before the first run of
# these phases.  A route against its reference run on the same inputs (the
# default factored route, the "xla" band, or the route with the stage
# kernel's plain version in its place): relative cost gap with a median of
# at most ROUTE_COST_MEDIAN and a 99th percentile of at most ROUTE_COST_P99,
# at most ROUTE_COST_OUTLIER_SHARE of the rows beyond ROUTE_COST_P99; the
# feasible count at 1e-2 within ROUTE_FEASIBLE_SHARE of the batch of the
# reference's (against the plain run: at most that share below it, and a
# median violation of at most ROUTE_VIOLATION_FACTOR x the plain run's +
# 1e-6, the violation taken as max(max_violation, 0): at K=2 every row lies
# strictly inside its corridor, the signed median is -0.41, and a factor on
# a negative number would ask for more than equality).  The K=10 routes also
# meet the headline's bars (MIN_FEASIBLE, MAX_MEDIAN_VIOLATION).
ROUTE_COST_MEDIAN = 1e-3
ROUTE_COST_P99 = 1e-2
ROUTE_COST_OUTLIER_SHARE = 0.0025
ROUTE_FEASIBLE_SHARE = 0.005
ROUTE_VIOLATION_FACTOR = 1.5
DENSE_ROUTES = (("a", 10, dict(kkt_apply="inverse")),
                ("b", 10, dict(kkt_inverse="cholesky")),
                ("c", 2, {}))
# "auto", the default, is "pallas" on the card (float32 G^T).
BAND_MODES = ("xla", "pallas", "pallas_block", "pallas_db", "auto")
ROUTE_PASSES = 3


def route_config(mtt, n_stages=1, **over):
    import dataclasses
    return dataclasses.replace(bench_config(mtt, n_stages=n_stages), **over)


def cost_gap_summary(a, b):
    """Relative cost gap of two solutions of the same scenarios."""
    import torch
    g = ((a.cost - b.cost).abs() / b.cost.abs()).double()
    return dict(median=float(g.median()), p99=float(torch.quantile(g, 0.99)),
                worst=float(g.max()),
                rows_over_p99_limit=int((g > ROUTE_COST_P99).sum()))


def gap_ok(gap, batch):
    return (gap["median"] <= ROUTE_COST_MEDIAN
            and gap["p99"] <= ROUTE_COST_P99
            and gap["rows_over_p99_limit"] <= ROUTE_COST_OUTLIER_SHARE * batch)


def solution_quality(sol):
    import torch
    finite = torch.isfinite(sol.cost) & torch.isfinite(sol.max_violation)
    return dict(feasible_at_1e_2=int((finite & (sol.max_violation < 1e-2))
                                     .sum()),
                median_max_violation=float(sol.max_violation.median()),
                median_positive_violation=float(
                    torch.clamp(sol.max_violation, min=0.0).median()),
                all_finite=bool(finite.all()))


def timed_passes(fn, n_pass):
    """(last result, ms of each pass by CUDA events, launches per kernel in
    the passes, peak device memory); counts set to 0 just before."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_pass + 1)]
    marks[0].record()
    for i in range(n_pass):
        out = fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    launches = {n: v for n, v in ipm_launches().items() if v}
    pass_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n_pass)]
    return out, pass_ms, launches, torch.cuda.max_memory_allocated()


def route_pieces(mtt, sc, cfg, stage_call, stage_kernel="admm_stage_fused"):
    """ms of the pieces of one solve on cfg's route, each run alone: _pre,
    the KKT set-up (once a solve), the KKT inverse with xq (dense inverse
    routes) or the band, its factors and xq (factored routes; once a
    stage), the stage kernel ``stage_kernel`` on ``stage_call``,
    _run_stages as a whole, _post."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    layout = qcqp._flagship_layout(sc.free)
    blk = banded.kkt_tridiag_block(sc.free)
    wp = sc.values[:, 1:-1, 0, :]

    def pre_fn():
        return qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                         sc.radii, cfg, None, layout, warmstart_positions=wp)

    parts = dict(pre_ms=cuda_ms(pre_fn, 3))
    pre = pre_fn()
    gt = None if pre.gt is None else pre.gt.contiguous()
    b = pre.b_pad
    rho = torch.full((b.shape[0], 1, 1), cfg.rho, dtype=b.dtype,
                     device=b.device)
    parts["kkt_setup_ms"] = cuda_ms(lambda: qcqp._kkt_setup(cfg, pre, blk), 3)
    kkt = qcqp._kkt_setup(cfg, pre, blk)

    def inverse():
        w = qcqp._kkt_inverse(kkt, rho, cfg.sigma, gt)
        return w, -(w @ pre.q_flat[:, :, None])

    if kkt.factored:
        parts["kkt_band_factor_and_xq_ms"] = cuda_ms(
            lambda: qcqp._stage_factors(kkt.band, rho, cfg.sigma, pre.q_flat,
                                        gt, kkt.factors), 3)
    else:
        parts["kkt_inverse_and_xq_ms"] = cuda_ms(inverse, 3)
    del kkt
    args, kw = stage_call
    stage_fn = getattr(admm_kernel, stage_kernel)
    parts["stage_kernel_ms"] = cuda_ms(lambda: stage_fn(*args, **kw), 3)
    outs = qcqp._run_stages(cfg, pre, layout, blk)
    parts["run_stages_total_ms"] = cuda_ms(
        lambda: qcqp._run_stages(cfg, pre, layout, blk), 3)
    parts["post_ms"] = cuda_ms(
        lambda: qcqp._post(sc.free, cfg, sc.d_fixed_free, sc.times, pre,
                           outs[0], outs[2], outs[3], outs[4], outs[5],
                           outs[6]), 3)
    return parts


def phase_dense_path(state, mtt):
    """solve_qcqp_batch on the routes that run kernel #2 (admm_stage_fused):
    (a) K=10 kkt_apply="inverse", (b) K=10 kkt_inverse="cholesky", (c) K=2
    with the default config (no block band: its only route); then (a) with
    three stages at batch 512 against its plain-in-place run, and kernel #7
    (admm_stage, no caller) through its public wrapper at the headline
    shapes."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    batch = MAIN_BATCH
    rec = state.setdefault("recorded", {})
    routes, bad = [], []
    for label, k, over in DENSE_ROUTES:
        cfg = route_config(mtt, **over)
        sc = mtt.make_inputs(k, batch, seed=0)
        calls = []
        with recorded(admm_kernel, "admm_stage_fused", calls):
            solve(mtt, sc, cfg)                           # warm-up
        torch.cuda.synchronize()
        stage_call = to_device(calls[0][:2], "cpu")   # off the card
        del calls
        sol, pass_ms, launches, peak = timed_passes(
            lambda: solve(mtt, sc, cfg), ROUTE_PASSES)
        ms = sum(pass_ms) / ROUTE_PASSES
        n2 = launches.get("admm_stage_fused", 0)
        n1 = launches.get("admm_stage_fused_factored", 0)
        state.setdefault("route_launches", {})[label] = n2
        q = solution_quality(sol)
        entry = dict(route=label, k=k, config=over or "default", batch=batch,
                     passes=ROUTE_PASSES, ms_per_batch=ms, pass_ms=pass_ms,
                     solves_per_s=batch / (ms * 1e-3),
                     launches_in_timed_passes=launches,
                     peak_device_memory_bytes=peak, **q)
        ok = (n2 == cfg.n_stages * ROUTE_PASSES and n1 == 0 and q["all_finite"]
              and sol.cost.shape == (batch,))
        if label in ("a", "b"):
            ref = solve(mtt, sc, bench_config(mtt))       # factored route
            rq = solution_quality(ref)
            gap = cost_gap_summary(sol, ref)
            entry.update(reference="default factored route", cost_gap=gap,
                         reference_feasible_at_1e_2=rq["feasible_at_1e_2"])
            ok = (ok and q["feasible_at_1e_2"] >= MIN_FEASIBLE
                  and q["median_max_violation"] <= MAX_MEDIAN_VIOLATION
                  and gap_ok(gap, batch)
                  and abs(q["feasible_at_1e_2"] - rq["feasible_at_1e_2"])
                  <= ROUTE_FEASIBLE_SHARE * batch)
            del ref
        else:
            with plain_kernels(only=("admm_stage_fused",)):
                ref = solve(mtt, sc, cfg)
            rq = solution_quality(ref)
            gap = cost_gap_summary(sol, ref)
            entry.update(reference="the same route with kernel #2's plain "
                         "version in its place", cost_gap=gap,
                         reference_feasible_at_1e_2=rq["feasible_at_1e_2"],
                         reference_median_max_violation=rq[
                             "median_max_violation"],
                         reference_median_positive_violation=rq[
                             "median_positive_violation"])
            ok = (ok and gap_ok(gap, batch)
                  and q["feasible_at_1e_2"] >= rq["feasible_at_1e_2"]
                  - ROUTE_FEASIBLE_SHARE * batch
                  and q["median_positive_violation"]
                  <= ROUTE_VIOLATION_FACTOR
                  * rq["median_positive_violation"] + 1e-6)
            del ref
        entry["phase_ms"] = route_pieces(mtt, sc, cfg, to_device(
            stage_call, "cuda"))
        entry["memory_bytes_by_piece"] = memory_pieces(mtt, sc, cfg)
        entry["ok"] = bool(ok)
        if not ok:
            bad.append(label)
        if label != "b":
            rec[f"admm_stage_fused {label}"] = stage_call
        routes.append(entry)
        del sol, sc, stage_call
        torch.cuda.empty_cache()

    # (a) with three stages at batch 512: init_z=False on the card, the
    # kernel path against the plain version of the same stage kernel.
    cfg3 = route_config(mtt, n_stages=3, kkt_apply="inverse")
    sc = mtt.make_inputs(10, 512, seed=2)
    before = admm_kernel.launches["admm_stage_fused"]
    kern, cmp, ok3 = compare_paths(mtt, sc, cfg3, None,
                                   kernels=("admm_stage_fused",))
    torch.cuda.synchronize()
    launched = admm_kernel.launches["admm_stage_fused"] - before
    multi = dict(n_stages=3, batch=512, kernel_launches=launched,
                 feasible_at_1e_2=int((kern.max_violation < 1e-2).sum()),
                 **cmp)
    if launched != 3 or not ok3 or not torch.isfinite(kern.cost).all():
        bad.append("a, three stages")

    # Kernel #7 has no caller in either package: its path is the public
    # wrapper, driven once at the headline shapes on route (a)'s recorded
    # stage inputs (m1 = W^-1 G^T by torch.bmm, z0/u0 from one plain stage),
    # counts set to 0 just before and read just after.
    args, kw = to_device(rec["admm_stage_fused a"], "cuda")
    rho, winv, gt, b, rb, xq, x0 = args[:7]
    skw = {n: kw[n] for n in ("n_iters", "alpha", "nb_p", "n_ball")}
    _, z1, _, u1 = admm_kernel.admm_stage_fused_plain(*args[:7], **skw)[:4]
    stage_args = (rho, torch.bmm(winv, gt), gt, b, rb, xq, z1.contiguous(),
                  (0.5 * u1).contiguous())
    del args, z1, u1
    design7 = admm_kernel.given_design(*gt.shape[1:], skw["nb_p"])
    reset_launches()
    out7 = admm_kernel.admm_stage(*stage_args, **skw)
    torch.cuda.synchronize()
    state["stage_launches"] = admm_kernel.launches["admm_stage"]
    finite7 = all(bool(torch.isfinite(o).all()) for o in out7)
    rec["admm_stage"] = to_device((stage_args, skw), "cpu")
    del stage_args, out7
    torch.cuda.empty_cache()
    if state["stage_launches"] != 1 or not finite7 or design7 != "cluster":
        bad.append("admm_stage through its wrapper (its cluster design)")

    emit("dense_path", config="headline ADMMConfig (1 stage x 48 "
         "iterations, rho 0.005, tube/half factors 0.125), seed 0, warm "
         "start from vertex values; (a) K=10 kkt_apply='inverse', (b) K=10 "
         "kkt_inverse='cholesky', (c) K=2 default", routes=routes,
         three_stages=multi, admm_stage_wrapper=dict(
             launches=state["stage_launches"], outputs_finite=finite7,
             design=design7),
         limits=dict(cost_gap_median=ROUTE_COST_MEDIAN,
                     cost_gap_p99=ROUTE_COST_P99,
                     rows_over_p99_limit=int(ROUTE_COST_OUTLIER_SHARE
                                             * batch),
                     feasible_within=int(ROUTE_FEASIBLE_SHARE * batch),
                     median_violation_vs_plain=ROUTE_VIOLATION_FACTOR,
                     headline=[MIN_FEASIBLE, MAX_MEDIAN_VIOLATION]),
         nvidia_smi=state.get("nvidia_smi"))
    if bad:
        raise RuntimeError(f"dense_path failed for {bad}")


def phase_band_gram(state, mtt):
    """The headline through the band kernels: band_gram "pallas",
    "pallas_block" and the default "auto" (kernel #6 once a solve) and
    "pallas_db" (kernel #5 once a stage), each with kernel 1, against the
    "xla" run on the same inputs; "pallas_db" against "xla" again on the
    scenarios of seed 1."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    batch = MAIN_BATCH
    sc = mtt.make_inputs(10, batch, seed=0)
    rec = state.setdefault("recorded", {})
    modes, bad, ref = [], [], None
    layout = qcqp._flagship_layout(sc.free)
    blk = banded.kkt_tridiag_block(sc.free)
    for mode in BAND_MODES:
        cfg = route_config(mtt, band_gram=mode)
        calls = {"gram_band_factors": []}
        with recorded(admm_kernel, "gram_band_factors",
                      calls["gram_band_factors"]):
            solve(mtt, sc, cfg)                           # warm-up
        torch.cuda.synchronize()
        # (a comprehension: a loop variable would keep the last call's
        # device tensors alive through the timed passes' peak memory)
        rec.update({name: to_device(c[0][:2], "cpu")
                    for name, c in calls.items() if c and name not in rec})
        del calls
        sol, pass_ms, launches, peak = timed_passes(
            lambda: solve(mtt, sc, cfg), ROUTE_PASSES)
        ms = sum(pass_ms) / ROUTE_PASSES
        want = {"admm_stage_fused_factored": cfg.n_stages * ROUTE_PASSES}
        if mode in ("pallas", "pallas_block", "auto"):
            want["gram_band"] = ROUTE_PASSES
        elif mode == "pallas_db":
            want["gram_band_factors"] = cfg.n_stages * ROUTE_PASSES
        state.setdefault("band_launches", {})[mode] = launches
        q = solution_quality(sol)
        pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                        sc.radii, cfg, None, layout,
                        warmstart_positions=sc.values[:, 1:-1, 0, :])
        rho = torch.full((batch, 1, 1), cfg.rho, dtype=torch.float32,
                         device=pre.gt.device)
        band_ms = cuda_ms(lambda: qcqp._kkt_band(pre.gt, pre.p_eq, blk,
                                                  mode), 3)
        band = qcqp._kkt_band(pre.gt, pre.p_eq, blk, mode)
        band_at_ms = cuda_ms(lambda: qcqp._kkt_band_at(band, rho, cfg.sigma,
                                                        pre.gt), 3)
        del pre, band
        entry = dict(band_gram=mode, ms_per_batch=ms, pass_ms=pass_ms,
                     solves_per_s=batch / (ms * 1e-3),
                     launches_in_timed_passes=launches,
                     expected_launches=want, peak_device_memory_bytes=peak,
                     band_once_a_solve_ms=band_ms,
                     band_at_rho_once_a_stage_ms=band_at_ms,
                     band_piece_ms=band_ms + cfg.n_stages * band_at_ms, **q)
        ok = (launches == want and q["all_finite"]
              and q["feasible_at_1e_2"] >= MIN_FEASIBLE
              and q["median_max_violation"] <= MAX_MEDIAN_VIOLATION)
        if mode == "xla":
            ref, rq = sol, q
        else:
            gap = cost_gap_summary(sol, ref)
            entry["cost_gap_vs_xla"] = gap
            ok = (ok and gap_ok(gap, batch)
                  and abs(q["feasible_at_1e_2"] - rq["feasible_at_1e_2"])
                  <= ROUTE_FEASIBLE_SHARE * batch)
        entry["ok"] = bool(ok)
        if not ok:
            bad.append(mode)
        modes.append(entry)
        torch.cuda.empty_cache()
    del sc, ref
    seed_1 = second_seed_gap(mtt, batch, route_config(mtt, band_gram="xla"),
                             route_config(mtt, band_gram="pallas_db"))
    if not seed_1["ok"]:
        bad.append("pallas_db against xla, seed 1")
    emit("band_gram", config="headline, K=10, batch %d, seed 0" % batch,
         modes=modes, pallas_db_vs_xla_seed_1=seed_1, limits=dict(
             cost_gap_median=ROUTE_COST_MEDIAN, cost_gap_p99=ROUTE_COST_P99,
             rows_over_p99_limit=int(ROUTE_COST_OUTLIER_SHARE * batch),
             feasible_within=int(ROUTE_FEASIBLE_SHARE * batch),
             headline=[MIN_FEASIBLE, MAX_MEDIAN_VIOLATION]),
         nvidia_smi=state.get("nvidia_smi"))
    if bad:
        raise RuntimeError(f"band_gram failed for {bad}")


def second_seed_gap(mtt, batch, ref_cfg, cfg):
    """The relative cost gap of the solve on ``cfg`` to the one on
    ``ref_cfg`` on the scenarios of seed 1 (untimed), gated at the KKT
    routes' limits (``gap_ok``); feasibility reported."""
    import torch
    sc = mtt.make_inputs(10, batch, seed=1)
    ref = solve(mtt, sc, ref_cfg)
    sol = solve(mtt, sc, cfg)
    gap = cost_gap_summary(sol, ref)
    out = dict(seed=1, cost_gap=gap,
               feasible_at_1e_2=solution_quality(sol)["feasible_at_1e_2"],
               reference_feasible_at_1e_2=solution_quality(ref)[
                   "feasible_at_1e_2"], ok=bool(gap_ok(gap, batch)))
    del sc, ref, sol
    torch.cuda.empty_cache()
    return out


# The gt_assembly="kernel" route (G^T kept as its rank-1 row factors e, w):
# kernels #3 and #4, each against its plain version by the rules of #1
# (compare_outputs; #3's cluster design against
# admm_stage_fused_factored_ew_winv_plain, its stream design against the
# reference order) and #5 (band_compare), on real factors at K=4, K=10 and
# K=12 (#3 there past kernel 1's budget, within its own: a block holds
# 198,928 B), #3 also at K=14 (past its own: the stream design), and #4 on
# random factors of K=2's widths and the flagship's (a real assembly's
# super-diagonal band is exactly zero), #4 in the design band_design names
# for the factors (the ring at blk 15, held there).  The negative control of
# both hands the kernel w with its rows in the wrong order: G^T row p*3 + d
# then reads w[(d + 1) % 3], what a wrong row interleave would do; #3 has a
# second, alpha WRONG_ALPHA for the config's 1.6, and #4 in the ring the
# build without the last warp's partial (BAND_SKIP_COMBINE).  The controls
# must be rejected at the flagship shape, at K=14 and on the random
# flagship factors.
# The path is gated as the KKT routes are (ROUTE_*), against the "pallas_db"
# route on the same inputs (kernels #5 and #1 on the assembled G^T, which the
# factors expand to), and at the headline's bars.
EW_KERNELS = ("admm_stage_fused_factored_ew", "gram_band_factors_ew")
# (label, K, batch, the design #3 must take, controls gated, #4 checked too)
EW_SHAPES = (("K=4", 4, 64, "cluster", False, True),
             ("flagship K=10", 10, 256, "cluster", True, True),
             ("K=12", 12, 32, "cluster", False, True),
             ("K=14", 14, 32, "stream", True, False))
# #4 on random factors: (label, nf, m_p, controls gated); K=2's widths (one
# band block, no ub: the ew route itself refuses K=2) and the flagship's.
EW_RANDOM_BANDS = (("random e, w, K=2 widths", 5, 384, False),
                   ("random e, w, flagship shape", 45, 512, True))
EW_STAGES = 3


def ew_inputs(mtt, k, batch, seed, config, route_band=False):
    """Inputs of kernels #3 and #4 from a real assembly on the
    gt_assembly="kernel" route at the config's rho: the factors e, w, the
    objective band, the stage's LDL^T factors and xq, and x, z, u carried
    from one plain stage (u halved, as a rebalancing of rho would) for the
    init_z=False entry.  The stage's factors come from the PyTorch band of
    the expanded G^T (``qcqp._kkt_band``), as ``stage_inputs`` and
    ``route_inputs`` form theirs, so that #3's check does not rest on the
    rounding of #4, a kernel under test; with ``route_band`` from #4's band,
    as the route forms them."""
    import dataclasses
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    cfg = dataclasses.replace(config, gt_assembly="kernel")
    sc = mtt.make_inputs(k, batch, seed=seed)
    layout = qcqp._flagship_layout(sc.free)
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, cfg, None, layout,
                    warmstart_positions=sc.values[:, 1:-1, 0, :])
    blk = banded.kkt_tridiag_block(sc.free)
    kkt = qcqp._kkt_setup(cfg, pre, blk)
    e, w = kkt.factors
    rho = torch.full((batch, 1, 1), cfg.rho, dtype=torch.float32,
                     device=e.device)
    if route_band:
        sinv, t_st, tt_st, xq = qcqp._stage_factors(
            kkt.band, rho, cfg.sigma, pre.q_flat, factors=kkt.factors)
    else:
        sinv, t_st, tt_st, xq = qcqp._stage_factors(
            qcqp._kkt_band(admm_kernel.expand_gt(e, w), pre.p_eq, blk,
                           "xla"), rho, cfg.sigma, pre.q_flat)
    stage = (rho, sinv, t_st, tt_st, e, w, pre.b_pad.contiguous(),
             qcqp._rb_pad(pre.rb, layout), xq)
    x0 = pre.x_flat0[:, :, None].contiguous()
    kw = dict(n_iters=cfg.n_iters, alpha=cfg.alpha, nb_p=layout.nb_p,
              n_ball=layout.n_ball)
    x1, z1, _, u1 = admm_kernel.admm_stage_fused_factored_ew_plain(
        *stage, x0, **kw)[:4]
    return dict(stage=stage, x0=x0, carried=(x1.contiguous(),
                                             z1.contiguous(),
                                             (0.5 * u1).contiguous()),
                kw=kw, e=e, w=w, pb_d=kkt.band[0], pb_u=kkt.band[1],
                rho=rho, sigma=cfg.sigma)


def random_ew_band_inputs(batch=256, nf=45, m_p=512, seed=4):
    """Inputs of kernel #4 with random factors (by default of the flagship
    shape)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    m_blk = 3 * nf // BAND_BLOCK
    return dict(e=rnd(batch, nf, m_p), w=rnd(batch, 3, m_p),
                pb_d=rnd(batch, m_blk, BAND_BLOCK, BAND_BLOCK),
                pb_u=rnd(batch, m_blk - 1, BAND_BLOCK, BAND_BLOCK),
                rho=(0.01 + rnd(batch, 1, 1).abs()).contiguous(), sigma=1e-6)


def ew_stage_design(ak, args, nb_p):
    """(design #3 takes for its stage arguments ``args``, the plain version
    in its order, or None for the reference order)."""
    sinv, e = args[1], args[4]
    design = ak.ew_design(ak.DIMS * e.shape[1], e.shape[2], sinv.shape[1],
                          sinv.shape[-1], nb_p)
    return design, (ak.admm_stage_fused_factored_ew_winv_plain
                    if design == "cluster" else None)


def ew_checks(ak, inp, band=True):
    """The ``check`` entries for kernels #3 (init_z True and False, where
    ``inp`` has stage inputs) and, with ``band``, #4 (in the design
    ``band_design`` names for the factors: the ring at blk 15), each with
    the controls stated above EW_KERNELS and, for #4 in the ring,
    BAND_SKIP_COMBINE."""
    w_bad = inp["w"][:, [1, 2, 0]].contiguous()
    out = []
    if "stage" in inp:
        design, twin = ew_stage_design(ak, inp["stage"], inp["kw"]["nb_p"])
        for init_z in (True, False):
            args = inp["stage"] + ((inp["x0"],) if init_z else inp["carried"])
            kw = dict(inp["kw"], init_z=init_z)
            out.append(check(EW_KERNELS[0], f"init_z={init_z}",
                             ak.admm_stage_fused_factored_ew,
                             ak.admm_stage_fused_factored_ew_plain, args, kw,
                             "stage", (args[:5] + (w_bad,) + args[6:], kw),
                             (args, dict(kw, alpha=WRONG_ALPHA)), twin=twin,
                             design=design))
    if not band:
        return out
    band_args = (inp["e"], inp["w"], inp["pb_d"], inp["pb_u"], inp["rho"])
    band_kw = dict(blk=BAND_BLOCK, sigma=inp["sigma"])
    _, nf, m_p = inp["e"].shape
    design = ak.band_design(ak.DIMS * nf, m_p, BAND_BLOCK, "factors").design
    ring = ((band_args, band_kw, BAND_SKIP_COMBINE),) if design == "ring" \
        else ()
    out.append(check(EW_KERNELS[1], "", ak.gram_band_factors_ew,
                     ak.gram_band_factors_ew_plain, band_args, band_kw,
                     "band", ((inp["e"], w_bad) + band_args[2:], band_kw),
                     *ring, design=design, want="ring"))
    return out


def same_bits_as_gt_kernels(ak, inp):
    """Whether #3 and #4 give the bits of #1 and #5 on the G^T their factors
    expand to.  #3 does not (reported): its cluster design sums in another
    order than kernel 1's.  #4 does: it runs #5's ring on slab entries
    rounded as ``expand_gt`` rounds them, so the ew route's band is the bits
    of "pallas_db"'s; the caller gates it."""
    import torch
    gt = ak.expand_gt(inp["e"], inp["w"])
    st = inp["stage"]
    kw = dict(inp["kw"], init_z=True)
    ew = ak.admm_stage_fused_factored_ew(*st, inp["x0"], **kw)
    ref = ak.admm_stage_fused_factored(*st[:4], gt, *st[6:], inp["x0"], **kw)
    band = (inp["pb_d"], inp["pb_u"], inp["rho"])
    bkw = dict(blk=BAND_BLOCK, sigma=inp["sigma"])
    ew_b = ak.gram_band_factors_ew(inp["e"], inp["w"], *band, **bkw)
    ref_b = ak.gram_band_factors(gt, *band, **bkw)
    torch.cuda.synchronize()
    return {EW_KERNELS[0]: all(torch.equal(a, b) for a, b in zip(ew, ref)),
            EW_KERNELS[1]: all(torch.equal(a, b) for a, b in zip(ew_b, ref_b))}


# Reported beside kernel_check_ew: criterion 2's margin (kernel vs plain
# float64 over its bar, the largest over the outputs: above 1 the criterion
# fails) of #3 entered with init_z, on seed 1's stage factors from the
# PyTorch band (the check's inputs) and from #4's band (the route's), and the
# margin of the reference order's float32 run on the host judged by the same
# criterion as if it were the kernel: how far the criterion, whose floor is
# one float32 run, separates the kernel from float32's own spread.
EW_CALIBRATION_SHAPES = (("K=12", 12, 32), ("K=14", 14, 32))


def criterion_2_margin(res):
    """The largest over the outputs of compare_outputs' criterion-2 ratio."""
    return max(res["kernel_vs_plain_f64"][n]
               / (3.0 * res["plain_vs_plain_f64"][n] + 1e-6 * res["scale"])
               for n in res["kernel_vs_plain_f64"])


def criterion_2_calibration(mtt, ak):
    """The report stated above EW_CALIBRATION_SHAPES."""
    out = {}
    for label, k, batch in EW_CALIBRATION_SHAPES:
        for source, route_band in (("pytorch band", False),
                                   ("#4's band", True)):
            inp = ew_inputs(mtt, k, batch, seed=1, config=bench_config(mtt),
                            route_band=route_band)
            args = inp["stage"] + (inp["x0"],)
            kw = dict(inp["kw"], init_z=True)
            design, twin = ew_stage_design(ak, args, kw["nb_p"])
            ours, ref32, plain64, _ = triple(
                ak.admm_stage_fused_factored_ew,
                ak.admm_stage_fused_factored_ew_plain, args, kw)
            plain = ref32 if twin is None else twin(*args, **kw)
            host = ak.admm_stage_fused_factored_ew_plain(
                *(a.cpu() for a in args), **kw)
            host = tuple(h.to(ours[0].device) for h in host)
            out[f"{label} {source}"] = dict(
                design=design,
                kernel_margin=criterion_2_margin(
                    compare_outputs(ours, plain, plain64, ref32)[0]),
                host_float32_reference_margin=criterion_2_margin(
                    compare_outputs(host, plain, plain64, ref32)[0]))
            del inp, ours, ref32, plain64, plain, host
    return out


def ew_kernel_check(mtt):
    """#3 and #4 against their plain versions in float32 and float64, with
    their controls; whether they give #1's and #5's bits."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    cases, bad, bits = [], [], {}
    for label, k, batch, want, gated, band in EW_SHAPES:
        inp = ew_inputs(mtt, k, batch, seed=1, config=bench_config(mtt))
        run_checks(label, inp["e"].shape, ew_checks(admm_kernel, inp, band),
                   gated, cases, bad, want_design=want)
        if band:
            bits[label] = same_bits_as_gt_kernels(admm_kernel, inp)
            if not bits[label][EW_KERNELS[1]]:
                bad.append(f"{EW_KERNELS[1]} {label}: not #5's bits on the "
                           f"expanded G^T")
        del inp
    for label, nf, m_p, gated in EW_RANDOM_BANDS:
        inp = random_ew_band_inputs(nf=nf, m_p=m_p)
        run_checks(label, inp["e"].shape, ew_checks(admm_kernel, inp),
                   gated, cases, bad)
        del inp
    calibration = criterion_2_calibration(mtt, admm_kernel)
    torch.cuda.empty_cache()
    emit("kernel_check_ew", tolerance_is=dict(
        stage="as kernel_check (KERNEL_TOL, both criteria; the cluster "
        "design against admm_stage_fused_factored_ew_winv_plain)",
        band="as kernel_check_routes' band criterion"),
        control=f"w's rows in the order (1, 2, 0); #3 also alpha "
        f"{WRONG_ALPHA}; #4 in the ring also built with {BAND_SKIP_COMBINE}",
        controls_gated_at=[r[0] for r in EW_SHAPES if r[4]]
        + [r[0] for r in EW_RANDOM_BANDS if r[3]], cases=cases,
        same_bits_as_gt_kernels_on_the_expanded_gt=bits,
        same_bits_note="#3: reported, expected False (its cluster design "
        "and kernel 1's sum in different orders); #4: gated, True (the same "
        "ring as #5 on the same slab entries)",
        criterion_2_calibration=calibration)
    if bad:
        raise RuntimeError(f"kernel_check (ew) failed for {bad}")


def memory_pieces(mtt, sc, cfg):
    """Device memory of one solve on cfg's route, in bytes above what was
    allocated before it: the peak of the whole solve through its entry
    point, the _pre bundle, the peak while _pre runs, and the peak while
    _run_stages runs with the bundle alive."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    layout = qcqp._flagship_layout(sc.free)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    solve(mtt, sc, cfg)
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, cfg, None, layout,
                    warmstart_positions=sc.values[:, 1:-1, 0, :])
    torch.cuda.synchronize()
    out = dict(peak_in_solve=whole,
               pre_bundle=torch.cuda.memory_allocated() - base,
               peak_in_pre=torch.cuda.max_memory_allocated() - base)
    torch.cuda.reset_peak_memory_stats()
    outs = qcqp._run_stages(cfg, pre, layout,
                            banded.kkt_tridiag_block(sc.free))
    torch.cuda.synchronize()
    out["peak_in_run_stages"] = torch.cuda.max_memory_allocated() - base
    del pre, outs
    return out


def phase_ew_path(state, mtt):
    """The headline with gt_assembly="kernel": kernels #4 and #3 once a
    stage, no G^T tensor; against the "pallas_db" route (#5 and #1 on the
    assembled G^T) and the "xla" headline on the same inputs; three stages
    at batch 512 against the same route with the two kernels' plain
    versions in their place; #3 and #4 against their plain versions; the
    route against "pallas_db" again on the scenarios of seed 1."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as ak
    ew_kernel_check(mtt)
    batch = MAIN_BATCH
    sc = mtt.make_inputs(10, batch, seed=0)
    cfg = route_config(mtt, gt_assembly="kernel")
    rec = state.setdefault("recorded", {})
    calls = {n: [] for n in EW_KERNELS}
    with recorded(ak, EW_KERNELS[0], calls[EW_KERNELS[0]]), \
            recorded(ak, EW_KERNELS[1], calls[EW_KERNELS[1]]):
        solve(mtt, sc, cfg)                               # warm-up
    torch.cuda.synchronize()
    rec.update({name: to_device(c[0][:2], "cpu")
                for name, c in calls.items()})
    del calls
    sol, pass_ms, launches, peak = timed_passes(
        lambda: solve(mtt, sc, cfg), ROUTE_PASSES)
    ms = sum(pass_ms) / ROUTE_PASSES
    want = {n: cfg.n_stages * ROUTE_PASSES for n in EW_KERNELS}
    state["ew_launches"] = launches
    q = solution_quality(sol)
    db_cfg = route_config(mtt, band_gram="pallas_db")
    db, db_pass_ms, db_launches, db_peak = timed_passes(
        lambda: solve(mtt, sc, db_cfg), ROUTE_PASSES)
    dq = solution_quality(db)
    xla = solve(mtt, sc, bench_config(mtt))

    def against(ref):
        out = {}
        for name, a, b in (("x", sol.d_free, ref.d_free),
                           ("cost", sol.cost, ref.cost),
                           ("max_violation", sol.max_violation,
                            ref.max_violation)):
            out[name] = dict(bit_identical=bool(torch.equal(a, b)),
                             max_abs_diff=float((a - b).abs().max()))
        out["cost_gap"] = cost_gap_summary(sol, ref)
        out["feasible_at_1e_2"] = solution_quality(ref)["feasible_at_1e_2"]
        return out

    vs_db, vs_xla = against(db), against(xla)
    shape_ok = sol.cost.shape == (batch,)
    del sol, db, xla
    torch.cuda.empty_cache()
    seed_1 = second_seed_gap(mtt, batch, db_cfg, cfg)
    ok = (launches == want and q["all_finite"] and shape_ok
          and q["feasible_at_1e_2"] >= MIN_FEASIBLE
          and q["median_max_violation"] <= MAX_MEDIAN_VIOLATION
          and gap_ok(vs_db["cost_gap"], batch)
          and abs(q["feasible_at_1e_2"] - dq["feasible_at_1e_2"])
          <= ROUTE_FEASIBLE_SHARE * batch and seed_1["ok"])
    memory = {name: memory_pieces(mtt, sc, c) for name, c in (
        ("ew", cfg), ("pallas_db", db_cfg), ("xla", bench_config(mtt)))}
    parts = route_pieces(mtt, sc, cfg, to_device(rec[EW_KERNELS[0]], "cuda"),
                         stage_kernel=EW_KERNELS[0])
    args, kw = to_device(rec[EW_KERNELS[1]], "cuda")
    parts["band_kernel_ms"] = cuda_ms(
        lambda: ak.gram_band_factors_ew(*args, **kw), 3)
    del args, sc
    torch.cuda.empty_cache()

    # EW_STAGES stages at batch 512: the init_z=False entry on the card,
    # the path against the same route with #3's and #4's plain versions.
    cfg3 = route_config(mtt, n_stages=EW_STAGES, gt_assembly="kernel")
    sc3 = mtt.make_inputs(10, 512, seed=2)
    before = {n: ak.launches[n] for n in EW_KERNELS}
    stage_calls = []
    with recorded(ak, EW_KERNELS[0], stage_calls):
        kern, cmp, ok3 = compare_paths(mtt, sc3, cfg3, None,
                                       kernels=EW_KERNELS)
    torch.cuda.synchronize()
    launched = {n: ak.launches[n] - before[n] for n in EW_KERNELS}
    s_args, s_kw = stage_calls[1][:2]
    ours, ref32, plain64, same = triple(
        ak.admm_stage_fused_factored_ew, ak.admm_stage_fused_factored_ew_plain,
        s_args, s_kw)
    design, twin = ew_stage_design(ak, s_args, s_kw["nb_p"])
    plain = ref32 if twin is None else twin(*s_args, **s_kw)
    later, later_ok = compare_outputs(ours, plain, plain64, ref32)
    multi = dict(n_stages=EW_STAGES, batch=512, kernel_launches=launched,
                 feasible_at_1e_2=int((kern.max_violation < 1e-2).sum()),
                 stage_1_entry=dict(init_z=s_kw["init_z"], design=design,
                                    ok=later_ok, bit_identical=same,
                                    errors=later), **cmp)
    ok3 = (ok3 and later_ok and same and not s_kw["init_z"]
           and all(v == EW_STAGES for v in launched.values())
           and bool(torch.isfinite(kern.cost).all()))
    del stage_calls, s_args, ours, plain, ref32, plain64, kern
    torch.cuda.empty_cache()

    emit("ew_path", config="headline ADMMConfig (K=10, 1 stage x 48 "
         "iterations, rho 0.005, tube/half factors 0.125, radii 0.8, warm "
         "start from vertex values) with gt_assembly='kernel', seed 0",
         source="benchmarks/headline_variants.py, variant 'ew'", batch=batch,
         passes=ROUTE_PASSES, ms_per_batch=ms, pass_ms=pass_ms,
         solves_per_s=batch / (ms * 1e-3), launches_in_timed_passes=launches,
         expected_launches=want, peak_device_memory_bytes=peak,
         headline_peak_device_memory_bytes=state.get("headline_peak"), **q,
         pallas_db=dict(ms_per_batch=sum(db_pass_ms) / ROUTE_PASSES,
                        pass_ms=db_pass_ms, launches_in_timed_passes=
                        db_launches, peak_device_memory_bytes=db_peak),
         vs_pallas_db=vs_db, vs_pallas_db_seed_1=seed_1,
         vs_xla_headline=vs_xla, phase_ms=parts,
         memory_bytes_by_piece=memory,
         three_stages=multi, limits=dict(
             cost_gap_median=ROUTE_COST_MEDIAN, cost_gap_p99=ROUTE_COST_P99,
             rows_over_p99_limit=int(ROUTE_COST_OUTLIER_SHARE * batch),
             feasible_within=int(ROUTE_FEASIBLE_SHARE * batch),
             headline=[MIN_FEASIBLE, MAX_MEDIAN_VIOLATION]),
         ok=bool(ok), three_stages_ok=bool(ok3),
         nvidia_smi=state.get("nvidia_smi"))
    if not (ok and ok3):
        raise RuntimeError(f"ew_path failed: path ok {ok}, three stages ok "
                           f"{ok3}")


# The linear planner path (no kernel of the JAX package runs on it: PyTorch
# on the card).  bench.py's K sweep, "linear K=2,10,50,100" with the
# standard mask, batch 2048, seed 1, and its banded solve at K >= 10.
# float32 on the card is held to float64 of the same function on the card,
# per row as a share of the row's scale: the banded solve's coefficient
# error at the median and the worst row at most LINEAR_FACTOR x the dense
# float32 solve's own + LINEAR_FLOOR; the fixed endpoint derivatives
# recovered from the coefficients the same way in float32 (monomial
# coefficients in float32 lose ~4e-3 of scale in that recovery, dense and
# banded alike) and to LINEAR_F64_TOL in float64; float64 banded against
# float64 dense to LINEAR_F64_TOL.  Negative control: one interior
# coupling block zeroed must fail the coefficient gate.
LINEAR_KS = (2, 10, 50, 100)
BANDED_KS = (10, 50, 100)
LINEAR_BATCH = 2048
LINEAR_FACTOR = 3.0
LINEAR_FLOOR = 1e-6
LINEAR_F64_TOL = 1e-8

# bench.py's "solve+extrema feasibility" (BASELINE config 5): K=10, batch
# 6144, seed 0, standard mask; vmax, amax by max_magnitude(n_grid=64);
# feasible where vmax <= 7.5 and amax <= 12.5 (2.5x the heuristic's 3, 5).
# The JAX package's own values, float32 on the host CPU, from bench.py's
# solve_and_check (jax.jit(jax.vmap(...)) of bench.make_inputs(10, 6144)),
# run as `JAX_PLATFORMS=cpu python -c` over that function: np.median of
# vmax and amax, and the feasible count.
EXTREMA_BATCH = 6144
EXTREMA_GRID = 64
V_LIMIT, A_LIMIT = 3.0 * 2.5, 5.0 * 2.5
JAX_MEDIAN_VMAX = 1.7815536260604858
JAX_MEDIAN_AMAX = 1.2223074436187744
JAX_FEASIBLE = 6144
MEDIAN_RTOL = 1e-3
FEASIBLE_SLACK = 6
# (a) the extrema in float32 against the same call in float64 on the same
# trajectory (the float32 solve's coefficients): relative value error at the
# p99 row.  The whole call's float32 against float64 (the solve included)
# is reported: the float32 solve alone moves vmax by ~4e-4 at p99.
EXTREMA_P99_RTOL = 1e-4
# (b) no maximum missed: float64 analytic >= float64 sampled (every segment
# at SAMPLES_A_SEGMENT points) - SAMPLED_RTOL relative, in every row.
SAMPLES_A_SEGMENT = 2048
SAMPLED_RTOL = 1e-6
SAMPLE_ROWS = 256


def row_share(a, b):
    """Per row: ``row_errors(a, b)`` as a share of max |b| of the row."""
    return row_errors(a, b) / b.double().flatten(1).abs().amax(dim=1)


def median_and_worst(e):
    return dict(median=float(e.median()), worst=float(e.max()),
                worst_row=int(e.argmax()))


def fixed_recovery_error(mtt, std, sol):
    """The fixed endpoint derivatives read back from the coefficients
    (float64 arithmetic on the solution's coefficients and times; interior
    vertices averaged over their two segments) against d_fixed, per row as a
    share of the row's scale."""
    from mav_tube_trajectory_generation_tpu_torch.ops import qmatrix
    d_seg = qmatrix.endpoint_derivatives_from_coefficients(
        sol.coefficients.double(), sol.times.double())
    back = mtt.compact_from_segment_derivatives(std, d_seg)[:, :std.n_fixed]
    return row_share(back, sol.d_fixed.expand_as(back))


def linear_gate(e_band, e_dense):
    """The float32 gate: the banded error at the median and the worst row
    within LINEAR_FACTOR x the dense solve's + LINEAR_FLOOR."""
    return (float(e_band.median()) <= LINEAR_FACTOR * float(e_dense.median())
            + LINEAR_FLOOR
            and float(e_band.max()) <= LINEAR_FACTOR * float(e_dense.max())
            + LINEAR_FLOOR)


def timed_call(fn, reps=5):
    """(ms a call by CUDA events after a warm-up, peak device memory of one
    call above what was allocated before it)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return cuda_ms(fn, reps), peak


@contextlib.contextmanager
def broken_coupling(banded):
    """Inside, ``solve_linear_banded`` solves with its middle interior
    coupling block zeroed (the negative control)."""
    orig = banded.block_tridiag_solve

    def solve(d, u, rhs):
        u = u.clone()
        u[..., u.shape[-3] // 2, :, :] = 0
        return orig(d, u, rhs)
    banded.block_tridiag_solve = solve
    try:
        yield
    finally:
        banded.block_tridiag_solve = orig


def sweep_row(mtt, banded, k, failures):
    """One K of the sweep: its JSON row; failed gates appended to
    ``failures``.  Every tensor it makes is freed when it returns."""
    import torch
    sc = mtt.make_inputs(k, LINEAR_BATCH, seed=1)
    std, df, t = sc.std, sc.d_fixed_std, sc.times
    df64, t64 = df.double(), t.double()
    row = dict(k=k, batch=LINEAR_BATCH)
    ms, peak = timed_call(lambda: mtt.solve_linear(std, df, t))
    row["dense"] = dict(ms=ms, solves_per_s=LINEAR_BATCH / ms * 1e3,
                        peak_bytes=peak)
    d32 = mtt.solve_linear(std, df, t)
    d64 = mtt.solve_linear(std, df64, t64)
    e_dense = row_share(d32.coefficients, d64.coefficients)
    fix_dense = fixed_recovery_error(mtt, std, d32)
    row["dense"].update(f32_vs_f64=median_and_worst(e_dense),
                        fixed_recovered_f32=median_and_worst(fix_dense),
                        profile=device_time_of(
                            lambda: mtt.solve_linear(std, df, t)))
    if not bool(torch.isfinite(d32.coefficients).all()) or \
            d32.coefficients.shape != (LINEAR_BATCH, k, 10, 3):
        failures.append(f"K={k}: dense output not finite or misshapen")
    if k not in BANDED_KS:
        return row
    ms, peak = timed_call(lambda: mtt.solve_linear_banded(std, df, t))
    b32 = mtt.solve_linear_banded(std, df, t)
    b64 = mtt.solve_linear_banded(std, df64, t64)
    e_band = row_share(b32.coefficients, b64.coefficients)
    e_64 = row_share(b64.coefficients, d64.coefficients)
    fix_band = fixed_recovery_error(mtt, std, b32)
    fix_64 = fixed_recovery_error(mtt, std, b64)
    with broken_coupling(banded):
        ctl = mtt.solve_linear_banded(std, df, t)
    e_ctl = row_share(ctl.coefficients, b64.coefficients)
    gates = dict(
        coefficients=linear_gate(e_band, e_dense),
        fixed_recovered_f32=linear_gate(fix_band, fix_dense),
        f64_vs_dense=float(e_64.max()) <= LINEAR_F64_TOL,
        fixed_recovered_f64=float(fix_64.max()) <= LINEAR_F64_TOL)
    control_rejected = not linear_gate(e_ctl, e_dense)
    row["banded"] = dict(
        ms=ms, solves_per_s=LINEAR_BATCH / ms * 1e3, peak_bytes=peak,
        f32_vs_f64=median_and_worst(e_band),
        f64_vs_dense_f64=median_and_worst(e_64),
        fixed_recovered_f32=median_and_worst(fix_band),
        fixed_recovered_f64=median_and_worst(fix_64),
        control_f32_vs_f64=median_and_worst(e_ctl),
        gates=gates, control_rejected=control_rejected,
        profile=device_time_of(lambda: mtt.solve_linear_banded(std, df, t)))
    if not all(gates.values()):
        failures.append(f"K={k} banded gates {gates}")
    if not control_rejected:
        failures.append(f"K={k}: the zeroed coupling block passed")
    return row


@contextlib.contextmanager
def device_as_found():
    """On the way out, drop the package's cached constants made inside and
    empty the allocator's cache, so that the phases after find the memory
    pool as the phases before left it: the `kernels` phase reads a
    wrapper's scratch from the peak of allocated blocks, and a cached
    constant left behind (K=100's one-hot map is 2-4 MB) pins a segment
    whose free remainder a later output may take unsplit, counted whole."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch import _tensors
    before = set(_tensors._CONST_CACHE)
    try:
        yield
    finally:
        for key in set(_tensors._CONST_CACHE) - before:
            del _tensors._CONST_CACHE[key]
        torch.cuda.empty_cache()


def phase_linear_sweep(state, mtt):
    """bench.py's linear K sweep: ``solve_linear`` at K=2, 10, 50, 100 and
    ``solve_linear_banded`` at K=10, 50, 100, batch 2048, timed and gated
    against float64 on the card, with a negative control."""
    from mav_tube_trajectory_generation_tpu_torch.solver import banded
    rows, failures = [], []
    for k in LINEAR_KS:
        with device_as_found():
            rows.append(sweep_row(mtt, banded, k, failures))
    emit("linear_sweep", config="standard mask (interior positions fixed, "
         "ends at rest), N=10, D=3, seed 1, float32; bench.py:115-129",
         rows=rows, gate=dict(factor=LINEAR_FACTOR, floor=LINEAR_FLOOR,
                              f64_tol=LINEAR_F64_TOL),
         ok=not failures, failures=failures)
    if failures:
        raise RuntimeError(f"linear_sweep: {failures}")


def segment_samples(times, per_segment):
    """(B, K * per_segment) global times: each segment's [start, end] at
    ``per_segment`` evenly spaced points."""
    import torch
    start = torch.cumsum(times, dim=-1) - times
    tau = torch.linspace(0.0, 1.0, per_segment, dtype=times.dtype,
                         device=times.device)
    ts = start[..., None] + times[..., None] * tau
    return ts.flatten(-2)


def sampled_max(mtt, traj, derivative, rows=SAMPLE_ROWS):
    """Per row, the largest ||x^(d)|| over SAMPLES_A_SEGMENT points of every
    segment (``evaluate_range``), ``rows`` rows at a time."""
    import torch
    out = []
    for i in range(0, traj.times.shape[0], rows):
        part = mtt.Trajectory(traj.coefficients[i:i + rows],
                              traj.times[i:i + rows])
        ts = segment_samples(part.times, SAMPLES_A_SEGMENT)
        vals = mtt.evaluate_range(part, ts, derivative)
        out.append(torch.linalg.vector_norm(vals, dim=-1).max(dim=-1).values)
    return torch.cat(out)


def endpoints_only_max(traj, derivative):
    """The negative control of gate (b): the largest ||x^(d)|| over the
    segments' endpoints alone, no roots."""
    from mav_tube_trajectory_generation_tpu_torch.ops import basis
    import torch
    ends = torch.stack([torch.zeros_like(traj.times), traj.times], dim=-1)
    vals = basis.polyval(traj.coefficients.transpose(-1, -2)[..., None, :, :],
                         ends[..., None], derivative)     # (B, K, 2, D)
    return torch.linalg.vector_norm(vals, dim=-1).flatten(1).max(dim=1).values


def extrema_fields(mtt):
    """The `extrema` line's fields and whether its checks passed; every
    tensor it makes is freed when it returns."""
    import numpy as np
    import torch
    sc = mtt.make_inputs(10, EXTREMA_BATCH, seed=0)
    std, df, t = sc.std, sc.d_fixed_std, sc.times
    del sc

    def check(df, t):
        sol = mtt.solve_linear(std, df, t)
        traj = mtt.Trajectory(sol.coefficients, sol.times)
        vmax = mtt.max_magnitude(traj, 1, n_grid=EXTREMA_GRID).value
        amax = mtt.max_magnitude(traj, 2, n_grid=EXTREMA_GRID).value
        return vmax, amax, (vmax <= V_LIMIT) & (amax <= A_LIMIT)

    ms, peak = timed_call(lambda: check(df, t))
    sol = mtt.solve_linear(std, df, t)
    traj = mtt.Trajectory(sol.coefficients, sol.times)
    ext_ms, ext_peak = timed_call(lambda: (
        mtt.max_magnitude(traj, 1, n_grid=EXTREMA_GRID),
        mtt.max_magnitude(traj, 2, n_grid=EXTREMA_GRID)))
    solve_ms = cuda_ms(lambda: mtt.solve_linear(std, df, t), 5)
    profile = device_time_of(
        lambda: mtt.max_magnitude(traj, 1, n_grid=EXTREMA_GRID))
    vmax, amax, ok = check(df, t)
    v_np, a_np = vmax.cpu().numpy(), amax.cpu().numpy()
    med_v, med_a = float(np.median(v_np)), float(np.median(a_np))
    feasible = int(ok.sum())

    # (a) the extrema in float32 against float64 on the same trajectory;
    # the whole call against float64 reported beside
    traj64 = mtt.Trajectory(traj.coefficients.double(), traj.times.double())
    sol64 = mtt.solve_linear(std, df.double(), t.double())
    full64 = mtt.Trajectory(sol64.coefficients, sol64.times)
    gate_a, whole, maxes64 = {}, {}, {}
    for name, d, ours in (("vmax", 1, vmax), ("amax", 2, amax)):
        ref = mtt.max_magnitude(traj64, d, n_grid=EXTREMA_GRID).value
        e = (ours.double() - ref).abs() / ref.abs()
        gate_a[name] = dict(p99=float(e.quantile(0.99)),
                            worst=float(e.max()), worst_row=int(e.argmax()))
        m64 = mtt.max_magnitude(full64, d, n_grid=EXTREMA_GRID).value
        maxes64[name] = (d, m64)
        w = (ours.double() - m64).abs() / m64.abs()
        whole[name] = dict(p99=float(w.quantile(0.99)), worst=float(w.max()))
    ok_a = all(g["p99"] <= EXTREMA_P99_RTOL for g in gate_a.values())

    # (b) no maximum missed, float64; the endpoints-only control must fail
    gate_b, control_b = {}, {}
    for name, (d, m64) in maxes64.items():
        sampled = sampled_max(mtt, full64, d)
        short = (sampled - m64) / sampled
        ctl = (sampled - endpoints_only_max(full64, d)) / sampled
        gate_b[name] = dict(largest_shortfall=float(short.max()),
                            row=int(short.argmax()),
                            rows_short=int((short > SAMPLED_RTOL).sum()))
        control_b[name] = dict(largest_shortfall=float(ctl.max()),
                               rows_short=int((ctl > SAMPLED_RTOL).sum()))
    ok_b = all(g["rows_short"] == 0 for g in gate_b.values())
    control_rejected = any(c["rows_short"] > 0 for c in control_b.values())

    # (c) the JAX package's values
    gap_v = abs(med_v - JAX_MEDIAN_VMAX) / JAX_MEDIAN_VMAX
    gap_a = abs(med_a - JAX_MEDIAN_AMAX) / JAX_MEDIAN_AMAX
    ok_c = (gap_v <= MEDIAN_RTOL and gap_a <= MEDIAN_RTOL
            and abs(feasible - JAX_FEASIBLE) <= FEASIBLE_SLACK)
    shapes_ok = vmax.shape == (EXTREMA_BATCH,) and bool(
        torch.isfinite(vmax).all() & torch.isfinite(amax).all())
    checks = dict(outputs=shapes_ok, a=ok_a, b=ok_b, c=ok_c,
                  control_rejected=control_rejected)
    return dict(config="K=10 N=10 D=3 standard mask, seed 0, float32; "
        "max_magnitude(n_grid=64) of velocity and acceleration; feasible "
        "at vmax <= 7.5 and amax <= 12.5 (bench.py:131-149)",
        batch=EXTREMA_BATCH, ms_per_batch=ms,
        scenarios_per_s=EXTREMA_BATCH / ms * 1e3, peak_bytes=peak,
        solve_ms=solve_ms, extrema_ms=ext_ms, extrema_peak_bytes=ext_peak,
        median_vmax=med_v, median_amax=med_a, feasible=feasible,
        jax=dict(median_vmax=JAX_MEDIAN_VMAX, median_amax=JAX_MEDIAN_AMAX,
                 feasible=JAX_FEASIBLE),
        gate_a_extrema_f32_vs_f64=gate_a, gate_a_ok=ok_a,
        whole_call_f32_vs_f64=whole,
        gate_b_analytic_vs_sampled=gate_b, gate_b_ok=ok_b,
        samples_a_segment=SAMPLES_A_SEGMENT,
        control_endpoints_only=control_b, control_rejected=control_rejected,
        gate_c_median_gap=dict(vmax=gap_v, amax=gap_a), gate_c_ok=ok_c,
        max_magnitude_profile=profile,
        profile_is="one max_magnitude(traj, 1, n_grid=64) call by "
        "torch.profiler: its kernel launches and device time"), checks


def phase_extrema(state, mtt):
    """bench.py's "solve+extrema feasibility" (BASELINE config 5):
    ``solve_linear`` -> ``Trajectory`` -> ``max_magnitude`` of velocity and
    acceleration at n_grid 64, timed, with gates (a)-(c) and a negative
    control."""
    with device_as_found():
        fields, checks = extrema_fields(mtt)
    emit("extrema", **fields, checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"extrema: checks {checks}")


# ---------------------------------------------------------------------------
# The nonlinear slice: the distance field, the demo's collision objective and
# the TIME objective's four optimizers (no kernel; nothing is built).
# ---------------------------------------------------------------------------

DEMO_PATH = "examples/demo_main_torch.py"
# esdf: the demo's forest map (100 x 100 x 50 at 0.1 m, seed 12345678)
ESDF_TOL = 1e-5             # meters: xla vs native, each vs brute force
ESDF_QUERY_POINTS = 1_000_000
ESDF_CROP = 20              # voxels a side of the brute-force crop
ESDF_REPS = 3
# nonlinear_collision: examples/demo_main_torch.py's composition
COLLISION_BATCH = 1024
COLLISION_MEDIAN_RTOL = 0.02
COLLISION_CLEAR_SLACK = 0.01          # of the batch
BOX_BATCH = 256
BOX_NOISE = 0.01
# The rows of tests/test_nonlinear.py's box case (w_c = 1000, batch 256)
# whose clearance the JAX package leaves at or below the robot radius,
# float64 on the host, on the exact inputs or in any of 8 copies whose
# fixed derivatives are scaled by 1 + 1e-15 N(0, 1)
# (tests/torch_nonlinear_witness.py box): 8-14 rows a run, 13 on the exact
# inputs, 19 in all.  Every other row
# must clear on the card; with w_c = 0 some other row must not.
JAX_BOX_ROWS_MISSED = (11, 25, 32, 54, 62, 85, 99, 106, 112, 121, 133, 154,
                       157, 158, 178, 198, 210, 219, 232)
# nonlinear_time: benchmarks/nonlinear_bench.py (BASELINE config 3): K=10,
# standard mask, batch 1024, seed 0, 30 iterations, penalty 500, float32.
TIME_BATCH = 1024
TIME_ITERS = 30
TIME_ROWS = 64
TIME_JAX_RTOL = 0.03
TIME_NM_FACTOR = 1.05
# The JAX package's medians of (initial, final) cost over the batch's first
# 64 rows (the same RandomState stream), float32 on the host CPU, as
# tests/torch_nonlinear_witness.py time prints them: nonlinear_bench.py's
# generator and functions, jax.jit(jax.vmap(...)), the final cost as the
# bench reads it (Nelder-Mead's cost.total, the gradient lines' last history
# entry).
JAX_TIME_MEDIANS_64 = {
    "nelder_mead": (389827.0, 321741.5625),
    "zoom": (389845.5, 42224.6796875),
    "backtracking": (389845.5, 43037.59375),
    "hybrid4": (389845.5, 42804.47265625),
}
# docs/PERF.md:299-305,494-501: the JAX package's medians of the final cost
# on a TPU, batch 1024 (reported beside ours, not compared).
TPU_TIME_MEDIANS = {"nelder_mead": 3.19e5, "zoom": 4.157e4,
                    "backtracking": 4.260e4, "hybrid4": 4.225e4}
CONSTRAINT_BATCH = 64
AL_BOUND = 0.8             # of each row's unconstrained max speed
# The rows in which the JAX package itself misses the augmented-Lagrangian
# bar (max speed within inequality_constraint_tolerance of the bound) on
# these 64 inputs, float64 on the host, on the exact inputs or in any of 16
# copies whose fixed derivatives are scaled by 1 + 1e-15 N(0, 1)
# (tests/torch_nonlinear_witness.py al): row 49, in 6 of the 17 runs, worst
# 0.8875 against 0.88.  Every other row must meet the bar on the card.
JAX_AL_ROWS_MISSED = (49,)


def card():
    """The CUDA device the port's entry points take by default."""
    from mav_tube_trajectory_generation_tpu_torch import _tensors
    return _tensors.resolve_device(None)


def load_demo():
    """examples/demo_main_torch.py as a module (its map, problem and
    parameters are the phases' configuration)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEMO_PATH)
    spec = importlib.util.spec_from_file_location("demo_main_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_median(t):
    """The median as NumPy (and jnp.median) take it: the mean of the two
    middle values of an even count."""
    import numpy as np
    return float(np.median(t.double().cpu().numpy()))


def device_launches_of(fn):
    """Device time and count of what ``fn()`` runs on the card, as
    ``device_time_of`` gives them, read from the raw trace of a profile with
    CUDA activity only: for the nonlinear phases' calls of ~300k launches,
    whose key_averages() takes minutes (172 s for one).  The kernel rows keep
    ``device_time_of``: in a fresh process the raw trace of ten of #7's
    cluster launches has held nine where key_averages() held ten
    (profiler_probe.py).  None where the profiler shows nothing."""
    import torch
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ns, counts = 0, {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                device_ns += e.duration_ns()
                counts[e.name()] = counts.get(e.name(), 0) + 1
    except Exception as e:          # the profiler is optional here
        print(f"note: profiler unavailable: {e}", file=sys.stderr)
        return None
    if not counts:
        return None
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms=device_ns / 1e6, wall_ms_under_profiler=wall_ms,
                launches=sum(counts.values()),
                most_launched=[dict(name=k[:80], count=v) for k, v in top])


def idle_share(profile, ms):
    """1 - device time of the profiled call / time of the timed call (None
    without a profile)."""
    if not profile:
        return None
    return 1.0 - profile["device_ms"] / ms


def brute_crop(occ, lo, size, res, device):
    """Signed distances of the voxels of occ[lo:lo+size]^3 by brute force in
    float64 on the card: to the nearest occupied voxel of the whole map for
    free voxels; minus the distance to the nearest free voxel for occupied
    ones (searched in the crop widened by a margin, and checked to lie
    inside it)."""
    import numpy as np
    import torch
    grid = np.stack(np.meshgrid(*[np.arange(l, l + size) for l in lo],
                                indexing="ij"), -1).reshape(-1, 3)
    centers = torch.as_tensor(grid, dtype=torch.float64, device=device)
    occ_c = occ[tuple(grid.T)]

    def nearest(points, targets):
        t = torch.as_tensor(targets, dtype=torch.float64, device=device)
        best = torch.full((points.shape[0],), float("inf"),
                          dtype=torch.float64, device=device)
        for i in range(0, t.shape[0], 8192):
            best = torch.minimum(best, torch.cdist(
                points, t[i:i + 8192]).amin(dim=1))
        return best

    out = nearest(centers, np.argwhere(occ))
    margin = 8
    w_lo = [max(l - margin, 0) for l in lo]
    w_hi = [min(l + size + margin, s) for l, s in zip(lo, occ.shape)]
    window = ~occ[w_lo[0]:w_hi[0], w_lo[1]:w_hi[1], w_lo[2]:w_hi[2]]
    free = np.argwhere(window) + np.asarray(w_lo)
    inside = torch.as_tensor(occ_c, device=device)
    if bool(inside.any()):
        d_in = nearest(centers[inside], free)
        if float(d_in.max()) >= margin:
            raise RuntimeError("esdf: the brute-force window is too small")
        out[inside] = -d_in
    return (out * res).reshape(size, size, size)


def esdf_fields(mtt):
    import numpy as np
    import torch
    demo = load_demo()
    occ, origin, res = demo.forest_occupancy()
    dev = card()

    def build(method, dtype=torch.float32, grid=occ):
        return mtt.esdf_from_occupancy(grid, origin, res, dtype=dtype,
                                       method=method)

    xla_ms, xla_peak = timed_call(lambda: build("xla"), reps=ESDF_REPS)
    t0 = time.perf_counter()
    native = build("native")        # the first call builds csrc/edt.cpp
    native_first_s = time.perf_counter() - t0
    native_ms = cuda_ms(lambda: build("native"), ESDF_REPS, warmup=0)
    auto = build("auto")
    xla = build("xla")
    if xla.method != "xla" or native.method != "native":
        raise RuntimeError(f"esdf: methods {xla.method}, {native.method}")
    gap = float((xla.distance - native.distance).abs().max())

    # brute force on a 20^3 crop around the tree nearest the map's middle
    trees = np.argwhere(occ)
    mid = np.asarray(occ.shape) / 2
    t0 = trees[np.argmin(np.linalg.norm(trees - mid, axis=1))]
    lo = [int(np.clip(c - ESDF_CROP // 2, 0, s - ESDF_CROP))
          for c, s in zip(t0, occ.shape)]
    ref = brute_crop(occ, lo, ESDF_CROP, res, dev)
    sl = tuple(slice(l, l + ESDF_CROP) for l in lo)
    crop = dict(lo=lo, occupied=int(occ[sl].sum()),
                xla=float((xla.distance[sl].double() - ref).abs().max()),
                native=float((native.distance[sl].double() - ref).abs()
                             .max()))

    # 10^6 queries: float32 field and points against float64
    x64 = build("xla", torch.float64)
    g = torch.Generator(device=dev).manual_seed(0)
    span = torch.tensor([(s - 1) * res for s in occ.shape],
                        dtype=torch.float64, device=dev)
    pts = (torch.tensor(origin, dtype=torch.float64, device=dev)
           + torch.rand((ESDF_QUERY_POINTS, 3), generator=g,
                        dtype=torch.float64, device=dev) * span)
    q32 = mtt.distance_at(xla, pts.float())
    q64 = mtt.distance_at(x64, pts)
    query_gap = float((q32.double() - q64).abs().max())
    query_ms = cuda_ms(lambda: mtt.distance_at(xla, pts.float()), 5)
    del x64, q32, q64, pts

    # negative control: one voxel flipped in the grid given to one side
    flip = occ.copy()
    flip[tuple(t0)] = False
    ctl_gap = float((build("native", grid=flip).distance
                     - xla.distance).abs().max())
    checks = dict(xla_vs_native=gap <= ESDF_TOL,
                  brute_force=max(crop["xla"], crop["native"]) <= ESDF_TOL,
                  query_f32_vs_f64=query_gap <= ESDF_TOL,
                  control_rejected=ctl_gap > ESDF_TOL,
                  auto_took_native=auto.method == "native")
    return dict(
        config="examples/demo_main_torch.py's forest: 100 x 100 x 50 voxels "
        "at 0.1 m, seed 12345678, signed, float32",
        voxels=int(occ.size), occupied=int(occ.sum()),
        xla_ms=xla_ms, xla_peak_bytes=xla_peak, native_ms=native_ms,
        native_first_call_s=native_first_s,
        native_is="host C++ transform (two passes, signed) and the copy to "
        "the card, wall time", auto_method=auto.method,
        xla_vs_native_max_m=gap, brute_force_crop=crop,
        query=dict(points=ESDF_QUERY_POINTS, f32_vs_f64_max_m=query_gap,
                   ms=query_ms),
        control_one_voxel_flipped_max_m=ctl_gap, tol_m=ESDF_TOL), checks


def phase_esdf(state, mtt):
    """The distance field of the demo's map: the min-plus transform on the
    card against the C++ one on the host and a brute force, the query in
    float32 against float64, with a negative control."""
    t0 = time.perf_counter()
    with device_as_found():
        fields, checks = esdf_fields(mtt)
    emit("esdf", **fields, checks=checks,
         seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise RuntimeError(f"esdf: checks {checks}")


def box_case(mtt, w_c, demo):
    """tests/test_nonlinear.py:108-141's box obstacle at batch 256 (the
    fixed derivatives jittered by 0.01 N(0, 1), seed 1), float64: the rows
    whose 200-sample clearance does not exceed the robot radius."""
    import numpy as np
    import torch
    n, h = 10, 5
    std = mtt.make_structure(mtt.standard_mask(3, n), 3, n)
    values = np.zeros((3, h, 3))
    values[0, 0] = [0.2, 1.0, 1.0]
    values[1, 0] = [1.0, 1.0, 1.0]
    values[2, 0] = [1.8, 1.0, 1.0]
    dev = card()
    df = mtt.extract_fixed_values(std, torch.as_tensor(values, device=dev))
    rng = np.random.RandomState(1)
    dfb = df[None] + BOX_NOISE * torch.as_tensor(
        rng.randn(BOX_BATCH, *df.shape), device=dev)
    occ = mtt.make_obstacle_grid((20, 20, 20), (0, 0, 0), 0.1,
                                 boxes=[((1.15, 0.9, 0.85),
                                         (1.45, 1.35, 1.3))])
    field = mtt.esdf_from_occupancy(occ, (0, 0, 0), 0.1,
                                    dtype=torch.float64)
    p = mtt.NonlinearParameters(
        objective=mtt.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=100, use_soft_constraints=False, robot_radius=0.1,
        epsilon=0.3, collision_samples_per_segment=64,
        weights=mtt.CostWeights(w_d=0.1, w_c=w_c))
    res = mtt.optimize(std, dfb, torch.tensor([3.0, 3.0], dtype=torch.float64,
                                              device=dev), p, field=field)
    clear = demo.min_clearance(field, res) > p.robot_radius
    return torch.nonzero(~clear).flatten().tolist()


def collision_fields(mtt):
    import torch
    demo = load_demo()
    dev = card()
    steps, t_step = {}, time.perf_counter()
    field = demo.build_map()
    structure, d_fixed, times, _ = demo.demo_problem(device=dev)
    params = demo.demo_params()

    one = mtt.optimize(structure, d_fixed, times, params, field=field)
    one_clear = float(demo.min_clearance(field, one))
    single = dict(initial_total=float(one.initial_cost.total),
                  final_total=float(one.cost.total),
                  final_collision=float(one.cost.collision),
                  min_clearance_m=one_clear,
                  n_iterations=int(one.n_iterations))

    d_b, t_b = demo.perturbed_batch(d_fixed, times, COLLISION_BATCH)
    steps["single"] = time.perf_counter() - t_step
    mtt.optimize(structure, d_b[:8], t_b[:8],                 # warm-up
                 demo.demo_params(max_iterations=2), field=field)
    holder = {}

    def run():
        holder["res"] = mtt.optimize(structure, d_b, t_b, params,
                                     field=field)
    t_step = time.perf_counter()
    ms = cuda_ms(run, reps=1, warmup=0)
    res = holder.pop("res")
    steps["batch_timed"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    profile = device_launches_of(lambda: mtt.optimize(
        structure, d_b, t_b, params, field=field))
    steps["batch_profiled"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    clear = demo.min_clearance(field, res) > params.robot_radius
    finite = bool(torch.isfinite(res.cost.total).all()
                  & torch.isfinite(res.coefficients).all())

    field64 = demo.build_map(dtype=torch.float64)
    res64 = mtt.optimize(structure, d_b.double(), t_b.double(), params,
                         field=field64)
    clear64 = demo.min_clearance(field64, res64) > params.robot_radius
    med = np_median(res.cost.total)
    med64 = np_median(res64.cost.total)
    gap = abs(med - med64) / abs(med64)
    n_clear, n_clear64 = int(clear.sum()), int(clear64.sum())
    steps["batch_f64"] = time.perf_counter() - t_step

    t_step = time.perf_counter()
    box_on = box_case(mtt, 1000.0, demo)
    steps["box_w_c_1000"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    box_off = box_case(mtt, 0.0, demo)
    steps["box_w_c_0"] = time.perf_counter() - t_step

    def medians(c):
        return dict(total=np_median(c.total), j_d=np_median(c.trajectory),
                    j_c=np_median(c.collision),
                    mean_j_c=float(c.collision.double().mean()))
    checks = dict(
        single_decreases=single["final_total"] <= single["initial_total"],
        single_clears=one_clear > params.robot_radius,
        batch_finite=finite,
        median_vs_f64=gap <= COLLISION_MEDIAN_RTOL,
        clear_vs_f64=n_clear >= n_clear64
        - COLLISION_CLEAR_SLACK * COLLISION_BATCH,
        box_w_c_1000_clears=set(box_on) <= set(JAX_BOX_ROWS_MISSED),
        control_box_w_c_0_rejected=not set(box_off) <= set(
            JAX_BOX_ROWS_MISSED))
    return dict(
        config="examples/demo_main_torch.py (main.cpp:15-126): "
        "FREE_CONSTRAINTS_AND_COLLISION, K=4, 25 iterations, zoom L-BFGS, "
        "forest ESDF by " + repr(field.method) + ", float32; batch 1024 of "
        "d_fixed + 0.05 N(0,1), seed 0",
        single=single, batch=COLLISION_BATCH, ms_per_batch=ms,
        scenarios_per_s=COLLISION_BATCH / ms * 1e3,
        launches_a_call=profile["launches"] if profile else None,
        device_ms_a_call=profile["device_ms"] if profile else None,
        idle_share=idle_share(profile, ms), profile=profile,
        initial=medians(res.initial_cost), final=medians(res.cost),
        clear=n_clear, f64=dict(median_total=med64, clear=n_clear64),
        median_gap_vs_f64=gap,
        box=dict(batch=BOX_BATCH, rows_not_clear_w_c_1000=box_on,
                 rows_not_clear_w_c_0=len(box_off),
                 rows_the_jax_package_misses=list(JAX_BOX_ROWS_MISSED)),
        step_seconds=steps), checks


def phase_nonlinear_collision(state, mtt):
    """The demo's collision objective on the card: one scenario, then 1024
    at once in float32 against float64, and tests/test_nonlinear.py's box
    obstacle with and without the collision weight."""
    t0 = time.perf_counter()
    with device_as_found():
        fields, checks = collision_fields(mtt)
    emit("nonlinear_collision", **fields, checks=checks,
         seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise RuntimeError(f"nonlinear_collision: checks {checks}")


def time_inputs(mtt):
    """benchmarks/nonlinear_bench.py's scenarios: (std, d_fixed, times)
    float32 on the card."""
    import numpy as np
    import torch
    k = 10
    std = mtt.make_structure(mtt.standard_mask(k + 1, 10), 3, 10)
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(TIME_BATCH, k + 1, 3)),
                          axis=1).astype(np.float32)
    values = np.zeros((TIME_BATCH, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    dev = card()
    times = torch.as_tensor(np.asarray(mtt.segment_times_nfabian(
        waypoints, 3.0, 5.0), dtype=np.float32), device=dev)
    d_fixed = mtt.extract_fixed_values(std, torch.as_tensor(values,
                                                            device=dev))
    return std, d_fixed, times


def constraint_cases(mtt):
    """tests/test_nonlinear.py's soft-constraint (:208-235) and
    augmented-Lagrangian (:86-106) cases at batch 64, float64: the
    scenarios of its build() at seeds 0..63; for the hard case each
    scenario scaled so that its unconstrained max speed is 1, the bound
    0.8 (the test's 0.8 vmax0 in every row)."""
    import numpy as np
    import torch
    dev = card()
    vals, ts = [], []
    for seed in range(CONSTRAINT_BATCH):
        verts = mtt.create_random_vertices(4, 4, np.zeros(3),
                                           6 * np.ones(3), seed)
        st, v = mtt.structure_from_vertices(verts, 10, mtt.SNAP)
        vals.append(v)
        ts.append(np.asarray(mtt.estimate_segment_times(verts, 2.0, 2.0)))
    df = mtt.extract_fixed_values(st, torch.as_tensor(np.stack(vals),
                                                      device=dev))
    t = torch.as_tensor(np.stack(ts), device=dev)
    nl = mtt.solver.nonlinear
    # the unconstrained optimum: the linear solve (the minimizer the test's
    # 40-iteration L-BFGS run approaches)
    sol0 = mtt.solve_linear(st, df, t)
    v0 = nl.max_magnitude_from_d(st, df, sol0.d_free, t, 1)

    # soft: FREE_CONSTRAINTS_AND_TIME, 60 iterations, |v| <= 1.5
    limit = 1.5
    p = mtt.NonlinearParameters(
        objective=mtt.Objective.FREE_CONSTRAINTS_AND_TIME,
        max_iterations=60, time_penalty=0.0, use_soft_constraints=True,
        soft_constraint_weight=10.0, weights=mtt.CostWeights(w_d=0.1,
                                                             w_sc=10.0))
    t0 = time.perf_counter()
    r = mtt.optimize(st, df, t, p,
                     constraints=[mtt.MagnitudeConstraint(1, limit)])
    soft_s = time.perf_counter() - t0
    v1 = nl.max_magnitude_from_d(st, df, r.d_free, r.times, 1)
    soft_ok = (torch.where(v0 > limit, v1 < v0 * 1.001,
                           torch.ones_like(v1, dtype=torch.bool))
               & (v1 <= 1.5 * limit) & torch.isfinite(r.cost.total))

    # hard: FREE_CONSTRAINTS, 40 iterations, augmented Lagrangian
    dfs = df / v0[:, None, None]
    free0 = nl.derivative_cost(st, dfs, sol0.d_free / v0[:, None, None], t)
    p0 = mtt.NonlinearParameters(objective=mtt.Objective.FREE_CONSTRAINTS,
                                 max_iterations=40,
                                 use_soft_constraints=False)
    bound = AL_BOUND
    t0 = time.perf_counter()
    res = mtt.optimize(st, dfs, t, p0,
                       constraints=[mtt.MagnitudeConstraint(1, bound)])
    hard_s = time.perf_counter() - t0
    vmax = nl.max_magnitude_from_d(st, dfs, res.d_free, t, 1)
    over = vmax > bound * (1.0 + p0.inequality_constraint_tolerance)
    missed = torch.zeros_like(over)
    missed[list(JAX_AL_ROWS_MISSED)] = True
    hard_ok = ((~over | missed) & (res.cost.trajectory >= free0 - 1e-6)
               & torch.isfinite(res.cost.total))
    return dict(
        batch=CONSTRAINT_BATCH,
        soft=dict(rows_passing=int(soft_ok.sum()), seconds=soft_s,
                  median_vmax_before=np_median(v0),
                  median_vmax_after=np_median(v1)),
        augmented_lagrangian=dict(
            rows_passing=int(hard_ok.sum()), seconds=hard_s, bound=bound,
            worst_vmax=float(vmax.max()),
            rows_over=[dict(row=int(i), vmax=float(vmax[i]))
                       for i in torch.nonzero(over).flatten().tolist()],
            rows_the_jax_package_misses=list(JAX_AL_ROWS_MISSED))), dict(
        soft_bars=bool(soft_ok.all()),
        augmented_lagrangian_bars=bool(hard_ok.all()))


def time_fields(mtt):
    import numpy as np
    import torch
    std, d_fixed, times = time_inputs(mtt)
    base = dict(objective=mtt.Objective.TIME, max_iterations=TIME_ITERS,
                time_penalty=500.0, use_soft_constraints=False)
    lines = {
        "nelder_mead": mtt.NonlinearParameters(**base),
        "zoom": mtt.NonlinearParameters(**base),
        "backtracking": mtt.NonlinearParameters(
            **base, lbfgs_linesearch="backtracking"),
        "hybrid4": mtt.NonlinearParameters(
            **base, lbfgs_linesearch="hybrid", hybrid_zoom_iters=4),
    }

    def call(name, df, t):
        """(initial cost, final cost) per row, as the bench reads them."""
        if name == "nelder_mead":
            r = mtt.optimize(std, df, t, lines[name])
            return r.initial_cost.total, r.cost.total
        _, hist = mtt.optimize_time_gradient(std, df, t, lines[name],
                                             n_iters=TIME_ITERS)
        return hist[:, 0], hist[:, -1]

    out, checks, steps = {}, {}, {}
    mtt.optimize_time_gradient(std, d_fixed[:8], times[:8], lines["zoom"],
                               n_iters=2)                    # warm-up
    for name in lines:
        holder = {}
        t_step = time.perf_counter()
        ms = cuda_ms(lambda: holder.update(r=call(name, d_fixed, times)),
                     reps=1, warmup=0)
        init, final = holder["r"]
        steps[name + "_timed"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        profile = device_launches_of(lambda: call(name, d_fixed, times))
        steps[name + "_profiled"] = time.perf_counter() - t_step
        med0, med1 = np_median(init), np_median(final)
        # the JAX package's rows: its batch's first 64 (np.median)
        f64 = final[:TIME_ROWS].double().cpu().numpy()
        i64 = init[:TIME_ROWS].double().cpu().numpy()
        j0, j1 = JAX_TIME_MEDIANS_64[name]
        gap = abs(float(np.median(f64)) - j1) / j1
        out[name] = dict(
            ms_per_batch=ms, scenarios_per_s=TIME_BATCH / ms * 1e3,
            launches_a_call=profile["launches"] if profile else None,
            device_ms_a_call=profile["device_ms"] if profile else None,
            idle_share=idle_share(profile, ms),
            wall_ms_under_profiler=(profile["wall_ms_under_profiler"]
                                    if profile else None),
            median_initial=med0, median_final=med1,
            finite_rows=int(torch.isfinite(final).sum()),
            rows_64=dict(median_initial=float(np.median(i64)),
                         median_final=float(np.median(f64)),
                         jax_median_initial=j0, jax_median_final=j1,
                         gap=gap),
            tpu_median_final_reported=TPU_TIME_MEDIANS[name],
            most_launched=profile["most_launched"][:4] if profile else None)
        checks[f"{name}_decreases"] = med1 < med0
        checks[f"{name}_vs_jax_64"] = gap <= TIME_JAX_RTOL
    checks["zoom_vs_nelder_mead"] = (out["zoom"]["median_final"]
                                     <= TIME_NM_FACTOR
                                     * out["nelder_mead"]["median_final"])
    t_step = time.perf_counter()
    cons, cons_checks = constraint_cases(mtt)
    steps["constraints"] = time.perf_counter() - t_step
    checks.update(cons_checks)
    return dict(
        config="benchmarks/nonlinear_bench.py (BASELINE config 3): TIME "
        "objective, K=10 N=10 D=3 standard mask, batch 1024, seed 0, 30 "
        "iterations, penalty 500, float32", lines=out,
        jax_rtol=TIME_JAX_RTOL, constraints=cons,
        step_seconds=steps), checks


def phase_nonlinear_time(state, mtt):
    """The TIME objective on the card: Nelder-Mead and L-BFGS through the
    inner solve with the zoom, backtracking and hybrid line searches, held
    to the JAX package's medians; and the soft and hard magnitude
    constraints at batch 64."""
    t0 = time.perf_counter()
    with device_as_found():
        fields, checks = time_fields(mtt)
    emit("nonlinear_time", **fields, checks=checks,
         seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise RuntimeError(f"nonlinear_time: checks {checks}")


# The sharded phase: the port's scenario-parallel layer over torch.distributed
# at the strict line's full width, in child processes (never a process group
# in this process).  (a) A world of 1 under NCCL: the sharded router against
# the unsharded one with the same schedule, row by row, beside
# solve_qcqp_sharded and solve_linear_sharded.  (b) A world of 2 under gloo
# with both ranks on the one card (NCCL refuses two ranks on one device),
# SHARDED_BATCH / 2 rows each of the same batch; (c) the same world on
# SHARDED_TIGHT_BATCH rows, tight corridors on rank 0's rows only, so that
# the ranks do unequal work before the one reduction.  A world of 2 on one
# card is a correctness run: its times are not a scaling measurement.
SHARDED_BATCH = 6144
SHARDED_TIGHT_BATCH = 512
SHARDED_PASSES = 3
SHARDED_CHILD_TIMEOUT = 240          # seconds, each child (~30 s used)
SHARDED_KERNELS = ("admm_stage_fused_factored", "ipm_pipe_step",
                   "ipm_eval_step", "gt_matvec")       # #1, #8, #9, #12


def sharded_router_run(mtt, mesh, sc, radii, passes, warm_up=True):
    """``solve_qcqp_strict_sharded`` on this rank's rows of ``sc``: one
    measured call (launch counts set to 0 just before and read just after,
    the peak of allocated memory, the float64 tier's rows and time), then
    ``passes`` calls timed by CUDA events.  Returns (fields, arrays)."""
    import numpy as np
    from mav_tube_trajectory_generation_tpu_torch.parallel import mesh as pm
    rows = [pm.local_rows(a, mesh) for a in (
        sc.d_fixed_free, sc.times, sc.waypoints, radii, sc.values)]

    def call():
        return mtt.solve_qcqp_strict_sharded(
            sc.free, *rows[:4], mesh=mesh, warmstart_values=rows[4])

    if warm_up:
        call()
    tier2 = []
    t0 = time.perf_counter()
    with tier2_observed(tier2):
        (res, n_strict), _, launches, peak = timed_passes(call, 1)
    seconds = time.perf_counter() - t0
    pass_ms = timed_passes(call, passes)[1] if passes else []
    viol = res.solution.max_violation.cpu().numpy()
    return dict(
        rows=int(viol.size), n_strict=float(n_strict),
        host_n_strict=int((viol < STRICT_GATE).sum()),
        n_escalated=int(res.n_escalated),
        rows_by_last_tier=np.bincount(res.tier, minlength=5).tolist(),
        pass_ms=pass_ms, measured_call_seconds=seconds, launches=launches,
        peak_device_memory_bytes=peak, tier2=tier2,
        summary=strict_summary(mtt, res, int(viol.size))), dict(
        verdict=res.verdict, max_violation=viol)


def sharded_linear(mtt, mesh, sc):
    """``solve_linear_sharded`` on this rank's rows: the reduced metrics and
    this rank's costs."""
    from mav_tube_trajectory_generation_tpu_torch.parallel import mesh as pm
    sol, m = pm.solve_linear_sharded(sc.std, mesh,
                                     pm.local_rows(sc.d_fixed_std, mesh),
                                     pm.local_rows(sc.times, mesh))
    return [float(v) for v in m], sol.cost.cpu().numpy()


def sharded_world1(mtt, mesh):
    import numpy as np
    from mav_tube_trajectory_generation_tpu_torch.parallel import mesh as pm
    sc = mtt.make_inputs(10, SHARDED_BATCH, seed=0)
    fields, arrays = sharded_router_run(mtt, mesh, sc, sc.radii,
                                        SHARDED_PASSES)
    single, single_ms, _, _ = timed_passes(lambda: mtt.solve_qcqp_auto(
        sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
        warmstart_values=sc.values, gate=1e-4, strict_gate=1e-4,
        tier0_snap=2, tier1_spec=0,
        ipm_config=mtt.IPMConfig(n_iters=10, sigma_min=0.3, corrector=False),
        tier2_f64=True, device=mesh.device), SHARDED_PASSES)
    arrays.update(single_verdict=single.verdict)
    fields.update(unsharded_pass_ms=single_ms)
    x0 = mtt.position_constrained_warmstart(sc.free, sc.values, sc.times)
    sol, n_ok = pm.solve_qcqp_sharded(sc.free, mesh, sc.d_fixed_free,
                                      sc.times, sc.waypoints, sc.radii,
                                      config=bench_config(mtt), x0=x0)
    viol = sol.max_violation.cpu().numpy()
    metrics, costs = sharded_linear(mtt, mesh, sc)
    arrays.update(linear_cost=costs)
    fields.update(qcqp=dict(n_ok=float(n_ok), host_n_ok=int(
        (viol < 1e-2).sum()), median_violation=float(np.median(viol))),
        linear_metrics=metrics)
    return fields, arrays


def sharded_world2(mtt, mesh):
    sc = mtt.make_inputs(10, SHARDED_BATCH, seed=0)
    fields, arrays = sharded_router_run(mtt, mesh, sc, sc.radii,
                                        SHARDED_PASSES)
    metrics, costs = sharded_linear(mtt, mesh, sc)
    arrays.update(linear_cost=costs)
    fields.update(linear_metrics=metrics)
    # (c): tight corridors in rank 0's rows only
    n = SHARDED_TIGHT_BATCH
    tight = mtt.make_inputs(10, n, seed=0)
    radii = tight.radii.clone()
    radii[:n // 2] = mtt.tight_radii(10, n)[:n // 2]
    c_fields, c_arrays = sharded_router_run(mtt, mesh, tight, radii, 0,
                                            warm_up=False)
    fields["tight_on_rank_0"] = c_fields
    arrays.update({f"tight_{k}": v for k, v in c_arrays.items()})
    return fields, arrays


def sharded_child(rank, world, store, out):
    """One rank of the sharded phase (started by ``phase_sharded``): joins
    the group (NCCL for a world of 1, gloo for more), runs its world's body
    on the card and writes ``out``.json and ``out``.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch.parallel import mesh as pm
    torch.cuda.set_device(0)
    backend = "nccl" if world == 1 else "gloo"
    pm.initialize_distributed(backend=backend, init_method=f"file://{store}",
                              rank=rank, world_size=world)
    try:
        mesh = pm.make_mesh()
        body = sharded_world1 if world == 1 else sharded_world2
        fields, arrays = body(mtt, mesh)
        fields.update(rank=rank, world=world,
                      backend=dist.get_backend(mesh.group),
                      device=str(mesh.device))
        with open(out + ".json", "w") as fh:
            json.dump(fields, fh)
        np.savez(out + ".npz", **arrays)
    finally:
        dist.destroy_process_group()
    return 0


def run_world(tmp, world):
    """Starts the ranks of one world as child processes and waits for them,
    each with its own timeout; a rank that fails or times out fails the
    phase (every child is killed first)."""
    import os
    import numpy as np
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               NCCL_DEBUG="WARN")
    store = os.path.join(tmp, f"store{world}")
    outs = [os.path.join(tmp, f"world{world}_rank{r}") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-child",
         str(r), str(world), store, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    t0 = time.perf_counter()
    failed = []
    try:
        for r, p in enumerate(procs):
            left = SHARDED_CHILD_TIMEOUT - (time.perf_counter() - t0)
            try:
                log, _ = p.communicate(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} of {world}: no end within "
                              f"{SHARDED_CHILD_TIMEOUT} s")
                break
            if p.returncode != 0:
                failed.append(f"rank {r} of {world} exited "
                              f"{p.returncode}:\n{log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError("sharded: " + "\n".join(failed))
    seconds = time.perf_counter() - t0
    ranks = []
    for o in outs:
        with open(o + ".json") as fh:
            fields = json.load(fh)
        with np.load(o + ".npz") as f:
            ranks.append((fields, dict(f)))
    return ranks, seconds


def linear_metrics_gate(metrics, costs):
    """The reduced linear metrics against the host's reductions of the
    concatenated costs (float32 costs; the sum within 1e-6 relative, the
    order of sums differs)."""
    import numpy as np
    finite = np.isfinite(costs)
    n, n_finite, total, top = metrics
    host_total = float(costs[finite].astype(np.float64).sum())
    return dict(
        n_scenarios=n == costs.size, n_finite=n_finite == finite.sum(),
        total_cost=abs(total - host_total) <= 1e-6 * abs(host_total),
        max_cost=top == float(costs[finite].max()))


def phase_sharded(state, mtt):
    import tempfile
    import numpy as np
    import torch
    from mav_tube_trajectory_generation_tpu_torch import _build
    _build.prebuild()                   # the children load these libraries
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        w1, w1_seconds = run_world(tmp, 1)
        w2, w2_seconds = run_world(tmp, 2)
    gates = {}

    # (a) a world of 1 under NCCL
    f1, a1 = w1[0]
    v1, viol1 = a1["verdict"], a1["max_violation"]
    gates["a_backend_nccl"] = f1["backend"] == "nccl"
    gates["a_verdicts_equal_unsharded"] = bool(
        (v1 == a1["single_verdict"]).all())
    gates["a_all_determinate"] = bool((v1 != 0).all()) and v1.size == \
        SHARDED_BATCH
    gates["a_no_false_feasible"] = f1["summary"]["false_feasible"] == 0
    gates["a_n_strict_is_host_count"] = f1["n_strict"] == f1["host_n_strict"]
    gates["a_n_ok_is_host_count"] = (f1["qcqp"]["n_ok"]
                                     == f1["qcqp"]["host_n_ok"])
    gates["a_linear_metrics"] = all(linear_metrics_gate(
        f1["linear_metrics"], a1["linear_cost"]).values())
    gates["a_kernels_launched"] = all(
        f1["launches"].get(n, 0) > 0 for n in SHARDED_KERNELS)

    # (b) a world of 2 under gloo, both ranks on the card
    (f20, a20), (f21, a21) = w2
    v2 = np.concatenate([a20["verdict"], a21["verdict"]])
    viol2 = np.concatenate([a20["max_violation"], a21["max_violation"]])
    costs2 = np.concatenate([a20["linear_cost"], a21["linear_cost"]])
    gates["b_backend_gloo"] = f20["backend"] == f21["backend"] == "gloo"
    gates["b_n_strict_same_and_host"] = (
        f20["n_strict"] == f21["n_strict"]
        == float((viol2 < STRICT_GATE).sum()))
    gates["b_linear_metrics_same_and_host"] = (
        f20["linear_metrics"] == f21["linear_metrics"]
        and all(linear_metrics_gate(f20["linear_metrics"], costs2).values()))
    gates["b_all_determinate"] = bool((v2 != 0).all()) and v2.size == \
        SHARDED_BATCH
    gates["b_no_false_feasible"] = not (
        (v2 == mtt.FEASIBLE) & ~(viol2 < STRICT_GATE)).any()
    clear = ~(((viol1 > STRICT_GATE / 2) & (viol1 < STRICT_GATE * 2))
              | ((viol2 > STRICT_GATE / 2) & (viol2 < STRICT_GATE * 2)))
    differ = v1 != v2
    gates["b_verdicts_equal_world1_where_clear"] = not (differ & clear).any()

    # (c) tight corridors on rank 0 only
    c0, c1 = f20["tight_on_rank_0"], f21["tight_on_rank_0"]
    vc = np.concatenate([a20["tight_verdict"], a21["tight_verdict"]])
    violc = np.concatenate([a20["tight_max_violation"],
                            a21["tight_max_violation"]])
    gates["c_all_determinate"] = bool((vc != 0).all()) and vc.size == \
        SHARDED_TIGHT_BATCH
    gates["c_no_false_feasible"] = not (
        (vc == mtt.FEASIBLE) & ~(violc < STRICT_GATE)).any()
    gates["c_n_strict_same_and_host"] = (
        c0["n_strict"] == c1["n_strict"]
        == float((violc < STRICT_GATE).sum()))

    def per_rank(fields):
        return dict({k: fields[k] for k in (
            "rank", "backend", "device", "rows", "n_escalated",
            "rows_by_last_tier", "pass_ms", "measured_call_seconds",
            "tier2", "launches", "peak_device_memory_bytes", "n_strict")
            if k in fields},
            ms_per_batch=(statistics.mean(fields["pass_ms"])
                          if fields["pass_ms"] else None))

    emit("sharded", config="K=10 N=10 D=3, make_inputs(10, 6144, seed=0), "
         "radii 0.8: solve_qcqp_strict_sharded with its defaults (the JAX "
         "mesh router's: tier 1 it10, no speculative restart, 2 snap "
         "sweeps, tier 2 float64 on the card), routed per rank",
         note="world 2 runs both ranks on the one card under gloo: a "
         "correctness run; its times are per rank on a shared card and are "
         "not a scaling measurement (one card cannot measure scaling)",
         world1=dict(per_rank(f1), unsharded_router_same_schedule=dict(
             verdicts_equal=int((v1 == a1["single_verdict"]).sum()),
             pass_ms=f1["unsharded_pass_ms"],
             ms_per_batch=statistics.mean(f1["unsharded_pass_ms"])),
             qcqp_sharded=f1["qcqp"], linear_metrics=f1["linear_metrics"],
             summary=f1["summary"], child_seconds=w1_seconds),
         world2=dict(ranks=[per_rank(f20), per_rank(f21)],
                     linear_metrics=[f20["linear_metrics"],
                                     f21["linear_metrics"]],
                     verdicts_differing_from_world1=int(differ.sum()),
                     verdicts_differing_where_clear=int((differ & clear).sum()),
                     rows_clear_of_gate=int(clear.sum()),
                     child_seconds=w2_seconds),
         tight_on_rank_0=dict(
             batch=SHARDED_TIGHT_BATCH,
             ranks=[per_rank(c0), per_rank(c1)],
             undetermined=int((vc == 0).sum()),
             infeasible=int((vc == mtt.INFEASIBLE).sum())),
         gates=gates, seconds=time.perf_counter() - t0,
         nvidia_smi=state.get("nvidia_smi"))
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"sharded: gates failed: {failed}")


@contextlib.contextmanager
def library_variant(name, defines):
    """While the block runs the wrappers launch the kernels of ``name``'s
    library built with the macros ``defines`` (a negative control; the
    port itself never does this)."""
    from mav_tube_trajectory_generation_tpu_torch import _build
    kept = _build.load(name)
    _build._LIBS[name] = _build.variant(name, defines)
    try:
        yield
    finally:
        _build._LIBS[name] = kept


# #8 and #9 wrong must fail the row criteria, at the flagship shape and
# K=4 (both gated): each with rank 0's band partial left out of the cluster's
# sum (IPM_DROP_RANK0: every entry of hd and hu is then rank 1's partial),
# and #8's Newton step with the fraction-to-boundary factor 0.995 ->
# IPM_WRONG_TAU (every boundary-limited step a tenth shorter; the plain
# versions get the right inputs).  Rank 0 is the block the split loads: it
# holds balls j < ceil(nb_p / 2), so every real ball at K=4 (n_ball 35 of
# nb_p 128) and 64 of 89 at the flagship, and the band entries rank 0
# finishes (the first half of [hd | hu]) hold nearly all of the band's mass;
# a control that drops or doubles rank 1's partial changes too little to be
# told from float32 (at K=4 nothing: rank 1's partial is zero there).
IPM_WRONG_TAU = 0.9


def lanes_by_rank(ipm_kernel, args, kw):
    """The cluster split's load in one recorded call: per rank, the balls
    j < n_ball it holds and the lanes whose G^T column is nonzero (mean
    over the scenarios)."""
    gt = args[0]
    live = (gt != 0).any(dim=1).float().mean(dim=0)        # (m_p,)
    split = ipm_kernel.cluster_band_parts(gt.shape[2], kw["nb_p"],
                                          kw["n_ball"])
    return [dict(rank=rank, lanes=len(lanes), balls=len(balls),
                 lanes_with_nonzero_columns=float(live[lanes].sum()))
            for rank, lanes, balls in split]


def ipm_controls(ipm_kernel, pairs, eval_call, fused_call):
    """{control: {rejected, errors}} for the negative controls above on one
    case's recorded calls (``fused_call``: one Newton step of the whole
    polish)."""
    out = {}

    def judge(name, fn, fn_plain, names, call, wrong_kw=None, variant=None,
              uncapped=()):
        args, kw, _ = call
        with (library_variant(variant, IPM_DROP_RANK0) if variant
              else contextlib.nullcontext()):
            wrong = fn(*args, **dict(kw, **(wrong_kw or {})))
        res, _, _ = check_call(fn, fn_plain, names, args, kw, ours=wrong,
                               uncapped=uncapped)
        out[name] = dict(
            rejected=not res["within_tolerance"],
            worst_output=res["worst_output"],
            worst_scaled_err=res["worst_scaled_err"],
            median_scaled_err_vs_plain_f64=res[
                "median_scaled_err_vs_plain_f64"],
            plain_f32_median_scaled_err_vs_plain_f64=res[
                "plain_f32_median_scaled_err_vs_plain_f64"],
            gross_rows=res["gross_rows"])

    ev = (ipm_kernel.ipm_eval_step, ipm_kernel.ipm_eval_step_plain, EVAL_OUT)
    pipe = (ipm_kernel.ipm_pipe_step, ipm_kernel.ipm_pipe_step_plain,
            PIPE_OUT)
    judge("eval_step without rank 0's band partial", *ev, eval_call,
          variant="ipm_eval")
    for upd, ev_mode in (("snap", "snap"), ("newton", "newton")):
        judge(f"pipe_step {upd}/{ev_mode} without rank 0's band partial",
              *pipe, pairs[(upd, ev_mode)], variant="ipm_pipe",
              uncapped=("bm",))
    judge(f"pipe_step newton/newton tau {IPM_WRONG_TAU}", *pipe,
          pairs[("newton", "newton")], uncapped=("bm",),
          wrong_kw=dict(tau=IPM_WRONG_TAU))
    args, kw, _ = eval_call
    judge("eval_step(band_block=0) without rank 0's Gram partial",
          ipm_kernel.ipm_eval_step, ipm_kernel.ipm_eval_step_plain, GRAM_OUT,
          (args, dict(kw, band_block=0), None), variant="ipm_eval")
    judge("solve_fused (1 Newton step) without rank 0's band partial",
          ipm_kernel.ipm_solve_fused, ipm_kernel.ipm_solve_fused_plain,
          FUSED_OUT, fused_call, variant="ipm_solve",
          uncapped=fused_uncapped(fused_call[1]))
    return out


def ipm_design_of(ipm_kernel, kernel, args, kw):
    """The design ``kernel`` (a name of ``ipm_kernel.CLUSTER_KERNELS``)
    takes for a recorded call's shapes."""
    _, nfd, m_p = args[0].shape
    blk = (ipm_kernel.gram_row_block(nfd) if kernel == "ipm_eval_step_gram"
           else kw.get("blk") or kw["band_block"])
    return ipm_kernel.ipm_design(kernel, nfd, m_p, blk, kw["nb_p"])


# stage_bits: kernel 1's and #7's outputs on fixed inputs (seed 1; kernel 1
# on the headline's stage inputs at the flagship (batch 256) and K=4 (64) in
# its cluster design and K=12 (32) in its stream design, entered with init_z
# and again with its own z, u carried in; #7 on route (a)'s stage inputs at
# the three shapes, in the design it takes there, named in its key), one
# SHA-256 digest of their bytes per kernel and shape.  Their arithmetic is
# not to change when the stage body they share with #2 and #3 does: with
# --bits-of-parent (a file holding this phase's line run on another
# checkout, this script copied there; the phase uses only the public entry
# points) it fails unless every digest is the same as the parent's, but for
# those of a kernel this tree redesigned (STAGE_BITS_REPORTED: #7's cluster
# of four), which are reported beside the parent's.
STAGE_BITS_SHAPES = (("flagship K=10", 10, 256), ("K=4", 4, 64),
                     ("K=12", 12, 32))
STAGE_BITS_REPORTED = ("admm_stage ",)


def sha256_of(*outputs):
    """One SHA-256 digest of the bytes of every tensor of ``outputs`` (each
    a tuple of tensors), in order."""
    import hashlib
    h = hashlib.sha256()
    for out in outputs:
        for o in as_tuple(out):
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def parent_line(parent_file, phase):
    """The digests of ``phase``'s line in ``parent_file`` (its ``digests``
    and any ``ungated_digests`` it printed beside them), or None."""
    if not parent_file:
        return None
    with open(parent_file) as fh:
        for line in fh:
            if line.startswith("{") and f'"{phase}"' in line:
                fields = json.loads(line)
                return {**fields.get("ungated_digests", {}),
                        **fields["digests"]}
    return None


def against_parent(digests, parent, reported, renamed=lambda key: key):
    """(gated keys whose digest differs from the parent's or that the
    parent lacks, {reported key: whether it equals the parent's}) for
    ``digests`` against ``parent`` (``parent_line``): keys starting with a
    prefix in ``reported`` are only reported, under the parent's key
    ``renamed(key)``."""
    differ, report = [], {}
    for key, digest in digests.items():
        if key.startswith(reported):
            report[key] = parent.get(renamed(key)) == digest
        elif parent.get(key) != digest:
            differ.append(key)
    return differ, report


def phase_stage_bits(state, mtt, parent_file=None):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as ak
    digests = {}
    for label, k, batch in STAGE_BITS_SHAPES:
        cfg = bench_config(mtt)
        # the dense Gram's band ("xla"), named: the digests are held to
        # the parent's on the same inputs, which #6's band would move
        args, kw = stage_inputs(mtt, k, batch, seed=1, config=cfg,
                                band_gram="xla")
        first = ak.admm_stage_fused_factored(*args, init_z=True, **kw)
        carried = ak.admm_stage_fused_factored(
            *args[:8], first[0].contiguous(), first[1].contiguous(),
            (0.5 * first[3]).contiguous(), init_z=False, **kw)
        torch.cuda.synchronize()
        digests[f"admm_stage_fused_factored {label}"] = sha256_of(first,
                                                                  carried)
        del args, first, carried
        inp = route_inputs(mtt, k, batch, seed=1, config=cfg)
        _, nfd, m_p = inp["gt"].shape
        design = ak.given_design(nfd, m_p, inp["kw"]["nb_p"])
        out = ak.admm_stage(*inp["stage"], **inp["kw"])
        torch.cuda.synchronize()
        digests[f"admm_stage {design} {label}"] = sha256_of(out)
        del inp, out
        torch.cuda.empty_cache()
    differ, reported = (None, None) if parent_file is None else \
        against_parent(digests, parent_line(parent_file, "stage_bits"),
                       STAGE_BITS_REPORTED,
                       lambda key: "admm_stage " + key.split(" ", 2)[2])
    emit("stage_bits", digests=digests, parent_file=parent_file,
         same_bits_as_parent=None if differ is None else not differ,
         gated_digests_differing=differ, reported_vs_parent=reported,
         reported_are=f"keys starting with {STAGE_BITS_REPORTED}: a design "
         "this tree changed; the parent's key has no design")
    if differ:
        raise RuntimeError(f"stage_bits: kernel 1's outputs differ from the "
                           f"parent's ({parent_file}): {differ}")


# ipm_bits: #8's and #9's outputs on the calls real polishes make (seed 1,
# batch 256 at the flagship shape and 64 at K=4, every mode pair and both
# phr), as one SHA-256 digest of their bytes per kernel and shape.  The calls
# chain kernel 1 and #8 / #9 through the solver, so a digest moves if either
# kernel gives other bits.  With --bits-of-parent (the --out file of this
# phase run on another checkout, this script copied there; the phase uses
# only the public entry points) it fails unless every digest is the same.
IPM_BITS_SHAPES = (("flagship K=10", 10, 256), ("K=4", 4, 64))


def phase_ipm_bits(state, mtt, parent_file=None):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    digests = {}
    for label, k, batch in IPM_BITS_SHAPES:
        pairs, eval_calls, _, _ = record_lanes(mtt, k, batch, seed=1,
                                               fused=False)
        torch.cuda.synchronize()
        for name, calls in (("ipm_pipe_step", [pairs[p]
                                               for p in sorted(pairs)]),
                            ("ipm_eval_step", eval_calls)):
            digests[f"{name} {label}"] = dict(
                calls=len(calls), sha256=sha256_of(*(c[2] for c in calls)))
        del pairs, eval_calls
    parent = parent_line(parent_file, "ipm_bits")
    same = None if parent_file is None else parent == digests
    emit("ipm_bits", digests=digests, parent_file=parent_file,
         same_bits_as_parent=same, launches=dict(ipm_kernel.launches))
    if parent_file and not same:
        raise RuntimeError(f"ipm_bits: #8 / #9 outputs differ from the "
                           f"parent's ({parent_file}): {parent}")


# band_bits: #4's, #5's and #6's outputs on the ew route's inputs (seed 1:
# the flagship at batch 256 and K=4 at 64; #5 and #6 on the G^T they expand
# to) and on random factors of the flagship shape, as one SHA-256 digest per
# kernel and case.  It fails unless #4's digest equals #5's in every case
# (the same ring on the same slab entries), and with --bits-of-parent (the
# --out file of this phase run on another checkout, this script copied
# there; the phase uses only the public entry points) unless every digest is
# the parent's, but for those of a kernel this tree redesigned
# (BAND_BITS_REPORTED: #4, which moved from the window body to the ring),
# reported beside the parent's.
BAND_BITS_SHAPES = (("flagship K=10", 10, 256), ("K=4", 4, 64))
BAND_BITS_REPORTED = ("gram_band_factors_ew ",)


def phase_band_bits(state, mtt, parent_file=None):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as ak
    digests = {}
    cases = [(label, ew_inputs(mtt, k, batch, seed=1,
                               config=bench_config(mtt)))
             for label, k, batch in BAND_BITS_SHAPES]
    cases.append(("random e, w, flagship shape", random_ew_band_inputs()))
    for label, inp in cases:
        bkw = dict(blk=BAND_BLOCK, sigma=inp["sigma"])
        band = (inp["pb_d"], inp["pb_u"], inp["rho"])
        digests[f"gram_band_factors_ew {label}"] = sha256_of(
            ak.gram_band_factors_ew(inp["e"], inp["w"], *band, **bkw))
        gt = ak.expand_gt(inp["e"], inp["w"])
        digests[f"gram_band_factors {label}"] = sha256_of(
            ak.gram_band_factors(gt, *band, **bkw))
        digests[f"gram_band {label}"] = sha256_of(
            ak.gram_band(gt, blk=BAND_BLOCK))
        torch.cuda.synchronize()
        del gt
    del cases
    torch.cuda.empty_cache()
    not_five = [label for label, _, _ in BAND_BITS_SHAPES
                + (("random e, w, flagship shape", 0, 0),)
                if digests[f"gram_band_factors_ew {label}"]
                != digests[f"gram_band_factors {label}"]]
    differ, reported = (None, None) if parent_file is None else \
        against_parent(digests, parent_line(parent_file, "band_bits"),
                       BAND_BITS_REPORTED)
    emit("band_bits", digests=digests, parent_file=parent_file,
         same_bits_as_parent=None if differ is None else not differ,
         gated_digests_differing=differ, reported_vs_parent=reported,
         ew_same_bits_as_gram_band_factors=not not_five)
    if not_five or differ:
        raise RuntimeError(f"band_bits: #4 not #5's bits in {not_five}, or "
                           f"digests differing from the parent's "
                           f"({parent_file}): {differ}")


def fused_call_checks(ipm_kernel, label, fused_calls, full, want,
                      rerun=False):
    """``ipm_kernel_check``'s cases of #11 on one shape's recorded
    whole-polish calls (``record_lanes``): each held to the row criteria and
    the residual class in the design ``want``, with the rows in which the
    plain version floors a pivot; with ``full`` the one-step controls and
    the one-sweep control (gated at the flagship).  ``rerun``: the kernel is
    run again on each call (the library in use may differ from the one the
    calls were recorded with).  Returns (cases, failures)."""
    cases, bad = [], []
    for args, kw, out in fused_calls:
        if rerun:
            out = ipm_kernel.ipm_solve_fused(*args, **kw)
        floors = {}
        with counting_floors(ipm_kernel, floors, kw):
            res, ok, summary = check_call(
                ipm_kernel.ipm_solve_fused,
                ipm_kernel.ipm_solve_fused_plain, FUSED_OUT, args, kw,
                ours=out, uncapped=fused_uncapped(kw))
            cls, cls_ok = fused_class(ipm_kernel, args, kw, out)
        design = ipm_design_of(ipm_kernel, "ipm_solve_fused", args, kw)
        cases.append(dict(kernel="ipm_solve_fused", shapes=label,
                          gt_shape=list(args[0].shape),
                          n_iters=kw["n_iters"],
                          snap_iters=kw["snap_iters"], design=design,
                          plain_rows_flooring_a_pivot=floored_counts(
                              floors),
                          **res, residual_class=cls))
        if not (ok and cls_ok) or design != want:
            bad.append(f"fused {label} n_iters={kw['n_iters']} "
                       f"({design})")
        if full and (kw["n_iters"], kw["snap_iters"]) == (1, 0):
            rejected, rej_ok = fused_controls_rejected(
                ipm_kernel, args, kw, summary)
            cases.append(dict(
                kernel="ipm_solve_fused", shapes=label, n_iters=1,
                snap_iters=0, kernel_with_one_scalar_off_rejected=rejected))
            if not rej_ok:
                bad.append(f"fused {label}: a wrong kernel passes")
        if full and (kw["n_iters"], kw["snap_iters"]) == (0, 2):
            wrong = ipm_kernel.ipm_solve_fused(*args,
                                               **dict(kw, snap_iters=1))
            w_cls, w_ok = fused_class(ipm_kernel, args, kw, wrong)
            cases.append(dict(
                kernel="ipm_solve_fused", shapes=label, n_iters=0,
                snap_iters=2, kernel_with_one_sweep_rejected=not w_ok,
                control_gated=label.startswith("flagship"),
                residual_class=w_cls))
            if w_ok and label.startswith("flagship"):
                bad.append(f"fused {label}: a kernel with one snap "
                           f"sweep passes the residual class")
            del wrong
    return cases, bad


def phase_ipm_kernel_check(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    cases, bad = [], []
    # (label, K, batch, the design #8-#11 must take, the controls, the NaN
    # rows and the 512-row report too?)
    shapes = (("flagship K=10", 10, 256, "cluster", True),
              ("K=4", 4, 64, "cluster", True),
              ("K=12", 12, 32, "stream", False))
    for label, k, batch, want, full in shapes:
        pairs, eval_calls, mv_calls, fused_calls = record_lanes(
            mtt, k, batch, seed=1)
        if len(pairs) != 7:
            raise RuntimeError(f"ipm_kernel_check: reached mode pairs "
                               f"{sorted(pairs)}, expected all seven")
        gt_shape = list(eval_calls[0][0][0].shape)
        for (upd, ev), (args, kw, out) in sorted(pairs.items()):
            res, ok, _ = check_call(ipm_kernel.ipm_pipe_step,
                                    ipm_kernel.ipm_pipe_step_plain, PIPE_OUT,
                                    args, kw, ours=out, uncapped=("bm",))
            design = ipm_design_of(ipm_kernel, "ipm_pipe_step", args, kw)
            cases.append(dict(kernel="ipm_pipe_step", shapes=label,
                              gt_shape=gt_shape, upd_mode=upd, eval_mode=ev,
                              design=design, **res))
            if not ok or design != want:
                bad.append(f"pipe {label} {upd}/{ev} ({design})")
        seen = set()
        for args, kw, out in eval_calls:
            if kw["phr"] in seen:
                continue
            seen.add(kw["phr"])
            res, ok, _ = check_call(ipm_kernel.ipm_eval_step,
                                    ipm_kernel.ipm_eval_step_plain, EVAL_OUT,
                                    args, kw, ours=out)
            design = ipm_design_of(ipm_kernel, "ipm_eval_step", args, kw)
            cases.append(dict(kernel="ipm_eval_step", shapes=label,
                              gt_shape=gt_shape, phr=kw["phr"],
                              design=design, **res))
            if not ok or design != want:
                bad.append(f"eval {label} phr={kw['phr']} ({design})")
            # the same point with the whole Gram out; its band blocks
            # must be what the band kernel gave (the two sum in different
            # orders: the value is reported)
            gkw = dict(kw, band_block=0)
            gout = ipm_kernel.ipm_eval_step(*args, **gkw)
            res, ok, _ = check_call(ipm_kernel.ipm_eval_step,
                                    ipm_kernel.ipm_eval_step_plain, GRAM_OUT,
                                    args, gkw, ours=gout)
            band_err = gram_band_mismatch(gout[4], out[4], out[5],
                                          kw["band_block"])
            design = ipm_design_of(ipm_kernel, "ipm_eval_step_gram", args,
                                   gkw)
            cases.append(dict(kernel="ipm_eval_step band_block=0",
                              shapes=label, gt_shape=gt_shape, phr=kw["phr"],
                              design=design,
                              band_vs_band_kernel_scaled_err=band_err, **res))
            if not ok or not band_err <= IPM_ROW_TOL or design != want:
                bad.append(f"eval gram {label} phr={kw['phr']} ({design})")
            del gout
        more, more_bad = fused_call_checks(ipm_kernel, label, fused_calls,
                                           full, want)
        cases += more
        bad += more_bad
        if not full:               # the kept one-block bodies
            del pairs, eval_calls, mv_calls, fused_calls
            torch.cuda.empty_cache()
            continue
        eval_call = next(c for c in eval_calls if not c[1]["phr"])
        one_step = next(c for c in fused_calls
                        if (c[1]["n_iters"], c[1]["snap_iters"]) == (1, 0))
        rejected = ipm_controls(ipm_kernel, pairs, eval_call, one_step)
        cases.append(dict(kernel="ipm_pipe_step, ipm_eval_step, "
                          "ipm_solve_fused",
                          shapes=label, control_gated=True,
                          wrong_kernel_rejected=rejected,
                          cluster_load=lanes_by_rank(ipm_kernel,
                                                     *eval_call[:2])))
        if not all(v["rejected"] for v in rejected.values()):
            bad.append(f"{label}: a wrong #8-#11 passes: {rejected}")
        args, kw, out = mv_calls[-1]
        res, ok, _ = check_call(ipm_kernel.gt_matvec,
                                ipm_kernel.gt_matvec_plain, ("y",), args, kw,
                                ours=out)
        cases.append(dict(kernel="gt_matvec", shapes=label,
                          gt_shape=gt_shape, **res))
        if not ok:
            bad.append(f"matvec {label}")

        # One scenario with a NaN right-hand side: its direction is NaN, so
        # the update must leave that scenario's state as it was (and the
        # evaluation then sees the unmoved point), exactly as the plain
        # version does, and touch no other scenario.
        row = 5
        for key in (("newton", "newton"), ("snap", "snap")):
            args, kw, out = pairs[key]
            rhs = args[17].clone()
            rhs[row] = float("nan")
            nan_args = args[:17] + (rhs,) + args[18:]
            ours = ipm_kernel.ipm_pipe_step(*nan_args, **kw)
            plain = ipm_kernel.ipm_pipe_step_plain(*nan_args, **kw)
            torch.cuda.synchronize()
            x_in, bx_in = args[6], args[10]
            frozen = bool(torch.equal(ours[0][row], x_in[row])
                          and torch.equal(ours[4][row], bx_in[row]))
            finite = all(bool(torch.isfinite(o[row]).all())
                         for o in ours[:6] + ours[8:])
            same_pattern = all(bool(
                (torch.isfinite(o) == torch.isfinite(p)).all())
                for o, p in zip(ours, plain))
            others = [i for i in range(ours[0].shape[0]) if i != row]
            untouched = all(torch.equal(o[others], q[others])
                            for o, q in zip(ours, as_tuple(out)))
            res = dict(kernel="ipm_pipe_step", shapes=label, nan_rhs_row=row,
                       upd_mode=key[0], eval_mode=key[1], row_frozen=frozen,
                       row_outputs_finite=finite,
                       same_finite_pattern_as_plain=same_pattern,
                       other_rows_bit_identical=untouched)
            cases.append(res)
            if not (frozen and finite and same_pattern and untouched):
                bad.append(f"nan row {label} {key}")
        # The whole-polish kernel with a NaN linear term in one scenario:
        # every Newton direction of that scenario is NaN, so its running
        # point must stay where it started (the snap sweeps, which do not
        # read q, may still move the best iterate), all its outputs stay
        # finite, and no other scenario changes a bit.
        args, kw, out = fused_calls[0]
        q = args[5].clone()
        q[row] = float("nan")
        nan_args = args[:5] + (q,) + args[6:]
        ours = ipm_kernel.ipm_solve_fused(*nan_args, **kw)
        plain = ipm_kernel.ipm_solve_fused_plain(*nan_args, **kw)
        torch.cuda.synchronize()
        frozen = bool(torch.equal(ours[4][row], args[9][row])
                      and torch.equal(ours[3][row], args[8][row]))
        finite = all(bool(torch.isfinite(o[row]).all()) for o in ours)
        same_pattern = all(bool(
            (torch.isfinite(o) == torch.isfinite(p)).all())
            for o, p in zip(ours, plain))
        others = [i for i in range(ours[0].shape[0]) if i != row]
        untouched = all(torch.equal(o[others], q_[others])
                        for o, q_ in zip(ours, as_tuple(out)))
        cases.append(dict(kernel="ipm_solve_fused", shapes=label,
                          nan_q_row=row, row_frozen=frozen,
                          row_outputs_finite=finite,
                          same_finite_pattern_as_plain=same_pattern,
                          other_rows_bit_identical=untouched))
        if not (frozen and finite and same_pattern and untouched):
            bad.append(f"fused nan row {label}")
        del pairs, eval_calls, mv_calls, fused_calls
        torch.cuda.empty_cache()
        more, more_bad = wide_fused_report(mtt, label, k)
        cases += more
        bad += more_bad
    emit("ipm_kernel_check", tolerance_is="per output, errors per scenario "
         "as a share of max|plain f64 output|, e_k = kernel vs plain f64, "
         "e_p = plain f32 vs plain f64: (1) at each listed quantile over the "
         "scenarios e_k <= dist_factor * e_p + floor; (2) scenarios with e_k "
         "> gross number at most 2x those with e_p > gross + gross_slack of "
         "the batch (at least 2); (3) and at most gross_cap of the batch + "
         "the same slack whatever plain f32 does (not the merit; not the "
         "endgame's lam_fin, lam_fin_max after more than short_run Newton "
         "steps); two kernel runs bit-identical",
         quantiles=IPM_QUANTILES, quantile_needs_rows_beyond=IPM_TAIL_ROWS,
         dist_factor=IPM_DIST_FACTOR, floor=IPM_FLOOR, gross=IPM_GROSS,
         gross_slack=IPM_GROSS_SLACK, gross_cap=IPM_GROSS_CAP,
         short_run=IPM_SHORT_RUN, reported_row_tolerance=IPM_ROW_TOL,
         controls=f"#9 and #8 (snap/snap, newton/newton) without rank 0's "
         f"band partial, #8 newton/newton with tau {IPM_WRONG_TAU}, #10 "
         f"without rank 0's Gram partial, #11 (one Newton step) without rank "
         f"0's band partial: each must be rejected at the flagship and at "
         f"K=4; K=12 runs #8-#11 in their one-block bodies, without "
         f"controls",
         factor_alone_gate="on the snap-only polish of FUSED_WIDE_ROWS rows "
         "at the flagship and K=4: rows_lost_by_factor must be 0",
         pivot_floor=ipm_kernel.PIVOT_FLOOR, cases=cases)
    if bad:
        raise RuntimeError(f"ipm_kernel_check failed for {bad}")


def device_time_of(fn):
    """Device time and count of the kernels ``fn()`` launches, by
    ``torch.profiler`` (kernel events only: an operator's row repeats the
    time of the kernels it launched), with the five largest by time and the
    eight most launched by name; None where the profiler shows no device
    time."""
    import torch
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us:
                rows.append((us / 1e3, e.key, e.count))
    except Exception as e:          # the profiler is optional here
        print(f"note: profiler unavailable: {e}", file=sys.stderr)
        return None
    if not rows:
        return None
    rows.sort(reverse=True)

    def named(sel):
        return [dict(ms=r[0], name=r[1][:80], count=r[2]) for r in sel]

    return dict(device_ms=sum(r[0] for r in rows),
                wall_ms_under_profiler=wall_ms, kernels=len(rows),
                launches=sum(r[2] for r in rows), largest=named(rows[:5]),
                most_launched=named(sorted(rows, key=lambda r: -r[2])[:8]))


def under_gate(sol):
    """Rows of a solution under the strict gate."""
    return int((sol.max_violation < STRICT_GATE).sum())


def p99_violation(sol):
    import torch
    return float(torch.quantile(sol.max_violation.double(), 0.99))


def fused_cost_gap(a, b):
    """The relative cost gap of two solutions of one batch, row by row."""
    import torch
    g = ((a.cost - b.cost).abs() / b.cost.abs()).double()
    return dict(median=float(g.median()),
                p99=float(torch.quantile(g, 0.99)), worst=float(g.max()),
                rows_over_1e_2=int((g > FUSED_COST_P99).sum()),
                converged=[int(a.converged.sum()), int(b.converged.sum())])


def fused_gate(kern, plain, seed):
    """The fused path's gate on one seed (the bars above FUSED_COST_MEDIAN):
    the polish with #11 (``kern``) against the same polish with #11's plain
    version in its place, each bar read as a margin, the reading over its
    limit (at most 1 passes)."""
    batch = kern.cost.shape[0]
    slack = max(2, int(IPM_GROSS_SLACK * batch))
    gap = fused_cost_gap(kern, plain)
    entry = dict(seed=seed, cost_gap=gap,
                 under_gate=[under_gate(kern), under_gate(plain)],
                 infeasible=[int(kern.infeasible.sum()),
                             int(plain.infeasible.sum())],
                 p99_violation=[p99_violation(kern), p99_violation(plain)],
                 order="[kernel, plain]")
    entry["margins"] = dict(
        cost_gap_median=gap["median"] / FUSED_COST_MEDIAN,
        cost_gap_p99=gap["p99"] / FUSED_COST_P99,
        rows_over_1e_2=gap["rows_over_1e_2"]
        / (FUSED_COST_OUTLIER_SHARE * batch),
        under_gate_below_plain=(entry["under_gate"][1]
                                - entry["under_gate"][0])
        / (FUSED_UNDER_GATE_SHARE * batch),
        p99_violation=entry["p99_violation"][0]
        / (3.0 * entry["p99_violation"][1] + 1e-6),
        infeasible=entry["infeasible"][0]
        / (2 * entry["infeasible"][1] + slack))
    entry["ok"] = all(v <= 1.0 for v in entry["margins"].values())
    return entry


def margins_vs_scan(sol, scan):
    """The fused polish's ends against the scan polish's, as margins (at
    most 1 passes): the cost gap's median and 99th percentile, rows under
    the strict gate at least 0.98 of the scan's, the 99th-percentile
    violation at most 3x the scan's + 1e-6."""
    gap = fused_cost_gap(sol, scan)
    return dict(cost_gap_median=gap["median"] / FUSED_COST_MEDIAN,
                cost_gap_p99=gap["p99"] / FUSED_COST_P99,
                under_gate=0.98 * under_gate(scan) / max(under_gate(sol), 1),
                p99_violation=p99_violation(sol)
                / (3.0 * p99_violation(scan) + 1e-6))


def phase_fused_path(state, mtt):
    """The polish with the whole interior-point method in one launch, at
    full width, and the fused polish beside the step-by-step one at the row
    counts the strict router gives its tiers."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    k, batch, n_pass = 10, MAIN_BATCH, 3
    sc = mtt.make_inputs(k, batch, seed=0)
    cfg = dict(n_iters=10, sigma_min=0.3, corrector=False)
    fused_cfg = mtt.IPMConfig(fused=True, **cfg)
    scan_cfg = mtt.IPMConfig(**cfg)

    def polished(ipm_cfg, inputs=sc):
        return mtt.solve_qcqp_polished_batch(
            inputs.free, inputs.d_fixed_free, inputs.times, inputs.waypoints,
            inputs.radii, admm_config=bench_config(mtt), ipm_config=ipm_cfg,
            warmstart_values=inputs.values)

    calls = []
    with recorded(ipm_kernel, "ipm_solve_fused", calls):
        polished(fused_cfg)                               # warm-up
    torch.cuda.synchronize()
    fused_args, fused_kw = calls[0][:2]
    state.setdefault("recorded", {})["ipm_solve_fused"] = to_device(
        calls[0][:2], "cpu")
    del calls
    # The rows in which the plain factor floors a pivot, Newton steps and
    # snap sweeps apart: in float32 on each seed's plain polish below, in
    # float64 on this call.
    floors = {seed: {} for seed in FUSED_SEEDS}
    with counting_floors(ipm_kernel, floors[0], fused_kw):
        ipm_kernel.ipm_solve_fused_plain(*(to64(a) for a in fused_args),
                                         **fused_kw)
    del fused_args
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_pass + 1)]
    marks[0].record()
    for i in range(n_pass):
        sol = polished(fused_cfg)
        marks[i + 1].record()
    torch.cuda.synchronize()
    launches = ipm_launches()
    state["fused_launches"] = launches["ipm_solve_fused"]
    pass_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n_pass)]
    ms = sum(pass_ms) / n_pass
    peak = torch.cuda.max_memory_allocated()
    scan_ms = cuda_ms(lambda: polished(scan_cfg), reps=2)
    scan = polished(scan_cfg)

    viol = sol.max_violation
    finite = bool(torch.isfinite(sol.cost).all()
                  and torch.isfinite(viol).all())

    # The gate: the kernel against its own plain version, nothing else
    # changed, on two seeds.
    against_plain = []
    for seed in FUSED_SEEDS:
        inputs = sc if seed == 0 else mtt.make_inputs(k, batch, seed=seed)
        kern = sol if seed == 0 else polished(fused_cfg, inputs)
        with plain_kernels(only=("ipm_solve_fused",)), \
                counting_floors(ipm_kernel, floors[seed], fused_kw):
            plain = polished(fused_cfg, inputs)
        against_plain.append(fused_gate(kern, plain, seed))
        del kern, plain, inputs
    plain_ok = all(e["ok"] for e in against_plain)

    # Reported only: the scan polish's worst rows, beside how far two other
    # float32 schedules of the same polish (pipelined against scan) part.
    pipelined = polished(mtt.IPMConfig(pipelined=True, **cfg))
    vs_scan = fused_cost_gap(sol, scan)
    spread = fused_cost_gap(pipelined, scan)
    del pipelined
    scan_margins = margins_vs_scan(sol, scan)
    quality = dict(
        under_gate=under_gate(sol), scan_under_gate=under_gate(scan),
        median_violation=float(viol.median()),
        p99_violation=p99_violation(sol),
        scan_median_violation=float(scan.max_violation.median()),
        scan_p99_violation=p99_violation(scan),
        converged=int(sol.converged.sum()),
        scan_converged=int(scan.converged.sum()),
        infeasible=int(sol.infeasible.sum()),
        scan_infeasible=int(scan.infeasible.sum()),
        kernel_vs_own_plain=against_plain,
        cost_gap_vs_scan=vs_scan, margins_vs_scan=scan_margins,
        cost_gap_pipelined_vs_scan=spread)
    shapes_ok = (sol.coefficients.shape == (batch, k, 10, 3)
                 and sol.infeasible.shape == (batch,))

    # The two polishes on the worst rows of the ADMM solve, as the router
    # gathers them: time and kernel launches of one polish each.
    admm = mtt.solve_qcqp_batch(
        sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
        config=bench_config(mtt), warmstart_values=sc.values)
    by_rows = []
    for rows in (645, 128, 1):
        rows = min(rows, batch)
        ip = torch.topk(admm.max_violation, rows).indices

        def lanes(ipm_cfg):
            return mtt.solve_qcqp_ipm_lanes(
                sc.free, sc.d_fixed_free[ip], sc.times[ip], sc.waypoints[ip],
                sc.radii[ip], config=ipm_cfg, x0=admm.d_free[ip],
                lam0_ball=admm.dual_ball[ip], lam0_half=admm.dual_half[ip])

        entry = dict(rows=rows)
        for label, ipm_cfg in (("scan", scan_cfg), ("fused", fused_cfg)):
            reset_launches()
            out = lanes(ipm_cfg)
            torch.cuda.synchronize()
            entry[label + "_kernel_launches"] = {
                n: v for n, v in ipm_launches().items() if v}
            entry[label + "_under_gate"] = int(
                (out.max_violation < STRICT_GATE).sum())
        # scan, fused, fused, scan: one card, in turns
        t = [cuda_ms(lambda c=c: lanes(c), reps=3, warmup=0)
             for c in (scan_cfg, fused_cfg, fused_cfg, scan_cfg)]
        entry.update(scan_ms=[t[0], t[3]], fused_ms=[t[1], t[2]],
                     scan_over_fused=(t[0] + t[3]) / (t[1] + t[2]))
        by_rows.append(entry)

    emit("fused_path", config="K=10 N=10 D=3, radii 0.8, seed 0: ADMM 48 it, "
         "then the lanes polish it10 sigma 0.3 corrector off + 2 snap sweeps "
         "as one kernel launch (IPMConfig.fused)", batch=batch,
         passes=n_pass, ms_per_batch=ms, pass_ms=pass_ms,
         solves_per_s=batch / (ms * 1e-3), scan_path_ms_per_batch=scan_ms,
         launches_in_timed_passes=launches,
         peak_device_memory_bytes=peak, **quality,
         limits=dict(cost_gap_median=FUSED_COST_MEDIAN,
                     cost_gap_p99=FUSED_COST_P99,
                     rows_over_p99_limit_vs_plain=int(
                         FUSED_COST_OUTLIER_SHARE * batch),
                     under_gate_below_plain=int(
                         FUSED_UNDER_GATE_SHARE * batch),
                     infeasible="2x plain + %d" % max(
                         2, int(IPM_GROSS_SLACK * batch))),
         polish_alone_by_rows=by_rows,
         pivot_floor=ipm_kernel.PIVOT_FLOOR,
         plain_rows_flooring_a_pivot={
             f"seed {seed}": floored_counts(f) for seed, f in floors.items()},
         plain_rows_flooring_a_pivot_are="rows of the batch in which the "
         "plain factor lifts a pivot to the floor in some Newton step or in "
         "some snap sweep: float32 in each seed's plain polish, float64 in "
         "the plain polish of seed 0's call run in float64",
         nvidia_smi=state.get("nvidia_smi"))
    if not shapes_ok or not finite:
        raise RuntimeError("fused_path: bad shapes or non-finite outputs")
    if launches["ipm_solve_fused"] != n_pass:
        raise RuntimeError(f"fused_path: {launches['ipm_solve_fused']} "
                           f"launches of the fused kernel in {n_pass} passes")
    if not plain_ok:
        raise RuntimeError(f"fused_path: the kernel's polish is off its "
                           f"plain version's: {against_plain}")
    if not all(v <= 1.0 for v in scan_margins.values()):
        raise RuntimeError(f"fused_path: cost or violations off the scan "
                           f"path's class: {quality}")


def strict_call(mtt, sc, radii=None, n=None, **kw):
    sl = slice(None) if n is None else slice(0, n)
    radii = sc.radii if radii is None else radii
    return mtt.solve_qcqp_strict(
        sc.free, sc.d_fixed_free[sl], sc.times[sl], sc.waypoints[sl],
        radii[sl], warmstart_values=sc.values[sl], **kw)


def strict_summary(mtt, res, batch):
    """Counts and quality of one router result; raises on a false FEASIBLE."""
    import numpy as np
    viol = res.solution.max_violation.cpu().numpy()
    feas = res.verdict == mtt.FEASIBLE
    false_feasible = int((feas & ~(viol < STRICT_GATE)).sum())
    out = dict(
        batch=batch, under_gate=int((viol < STRICT_GATE).sum()),
        feasible=int(feas.sum()),
        infeasible=int((res.verdict == mtt.INFEASIBLE).sum()),
        undetermined=int((res.verdict == mtt.UNDETERMINED).sum()),
        false_feasible=false_feasible, n_escalated=int(res.n_escalated),
        rows_by_last_tier=np.bincount(res.tier, minlength=5).tolist(),
        p99_violation_of_feasible=float(np.percentile(viol[feas], 99))
        if feas.any() else None,
        max_violation_of_feasible=float(viol[feas].max()) if feas.any()
        else None,
        finite_cost=bool(np.isfinite(
            res.solution.cost.cpu().numpy()[feas]).all()))
    return out


def ipm_launches():
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    return dict(**admm_kernel.launches, **ipm_kernel.launches)


def reset_launches():
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel,
                                                              linalg)
    for name in admm_kernel.launches:
        admm_kernel.launches[name] = 0
    for name in ipm_kernel.launches:
        ipm_kernel.launches[name] = 0
    linalg.launches = 0


def tier2_state_copy(args, kwargs):
    """The arguments of one ``_run_tier2_f64`` call with everything the call
    mutates copied: the per-row violation, certificate and tier arrays
    (NumPy) and the list of merged fields (its tensors are replaced, never
    written in place)."""
    args = list(args)
    args[6], args[7], args[8] = args[6].copy(), args[7].copy(), list(args[8])
    kwargs = dict(kwargs)
    if kwargs.get("tier_mark") is not None:
        kwargs["tier_mark"] = kwargs["tier_mark"].copy()
    return args, kwargs


@contextlib.contextmanager
def tier2_observed(log, keep_args=None):
    """While the block runs, the router's float64 last tier appends to
    ``log`` one entry per call: the rows entering each stage that ran, and
    its time with a device synchronisation around it.  With ``keep_args`` (a
    list) the call's arguments are copied into it first, so that the same
    tier can be run again from the same state."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.solver import auto
    fn = auto._run_tier2_f64

    def wrapper(*args, **kwargs):
        if keep_args is not None:
            keep_args.append(tier2_state_copy(args, kwargs))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        n_stages = len(auto.TIER2_STAGE_ITERS)
        stage_rows = out[1] + [0] * (n_stages - len(out[1]))  # stages not run
        log.append(dict(rows_entering_stage=stage_rows,
                        stage_iters=list(auto.TIER2_STAGE_ITERS),
                        ms=(time.perf_counter() - t) * 1e3))
        return out

    auto._run_tier2_f64 = wrapper
    try:
        yield
    finally:
        auto._run_tier2_f64 = fn


def phase_strict_path(state, mtt):
    import numpy as np
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes
    k, batch, n_pass = 10, MAIN_BATCH, 3
    sc = mtt.make_inputs(k, batch, seed=0)

    # Warm-up; it also records one call of each interior-point kernel at the
    # shapes this path gives it, for the `kernels` phase.
    pipe_calls, eval_calls, mv_calls = [], [], []
    with recorded(ipm_kernel, "ipm_pipe_step", pipe_calls), \
            recorded(ipm_kernel, "ipm_eval_step", eval_calls), \
            recorded(ipm_kernel, "gt_matvec", mv_calls):
        strict_call(mtt, sc)
    torch.cuda.synchronize()
    g_args, g_kw = eval_calls[0][:2]
    state.setdefault("recorded", {}).update(
        ipm_pipe_step=to_device(next(
            c for c in pipe_calls if c[1]["upd_mode"] == "snap"
            and c[1]["eval_mode"] == "snap")[:2], "cpu"),
        ipm_eval_step=to_device((g_args, g_kw), "cpu"),
        gt_matvec=to_device(mv_calls[0][:2], "cpu"))
    del pipe_calls, eval_calls, mv_calls

    # The full-Gram evaluation has no caller inside the package (in the JAX
    # package only a test calls it): its path is the public wrapper, driven
    # here once at the shape tier 1 gives the band form, counts set to 0
    # just before and read just after.
    reset_launches()
    gram_out = ipm_kernel.ipm_eval_step(*g_args, **dict(g_kw, band_block=0))
    torch.cuda.synchronize()
    state["gram_launches"] = ipm_kernel.launches["ipm_eval_step_gram"]
    if state["gram_launches"] != 1 or not torch.isfinite(gram_out[4]).all():
        raise RuntimeError("strict_path: the full-Gram evaluation did not "
                           "launch once or gave non-finite values")
    del gram_out, g_args
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_pass + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(n_pass):
        res = strict_call(mtt, sc)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_pass
    launches = ipm_launches()
    state["strict_launches"] = launches
    pass_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n_pass)]
    ms = sum(pass_ms) / n_pass
    peak = torch.cuda.max_memory_allocated()
    summary = strict_summary(mtt, res, batch)
    shapes_ok = (res.solution.coefficients.shape == (batch, k, 10, 3)
                 and res.verdict.shape == (batch,)
                 and res.tier.shape == (batch,))

    # SPLIT_PASSES more passes with a device synchronisation around every
    # tier, to split the time (they are not among the timed passes).  Tier 0
    # at batch 6144 swings by 10-30 ms from pass to pass with the host; to
    # compare two commits, alternate them (this script copied into the other
    # checkout: the phase needs only the package's public entry points).
    tiers = []

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            cfg = kwargs.get("config") or kwargs.get("ipm_config")
            tiers.append(dict(
                call=label, rows=int(args[1].shape[0]),
                n_iters=cfg.n_iters, snap_iters=cfg.snap_iters,
                corrector=cfg.corrector,
                ms=(time.perf_counter() - t) * 1e3))
            return out
        return wrapper

    keep = (ipm_lanes.solve_qcqp_polished_batch,
            ipm_lanes.solve_qcqp_ipm_lanes)
    # (tier 0's own lanes call is inside its polished_batch entry)
    ipm_lanes.solve_qcqp_polished_batch = timed(
        keep[0], "tier 0 whole: ADMM + snap sweeps")
    ipm_lanes.solve_qcqp_ipm_lanes = timed(keep[1], "lanes IPM")
    tier2_log, split_passes = [], []
    try:
        with tier2_observed(tier2_log):
            for _ in range(SPLIT_PASSES):
                tiers.clear()
                t_all = time.perf_counter()
                strict_call(mtt, sc)
                torch.cuda.synchronize()
                split_passes.append(dict(
                    total_ms=(time.perf_counter() - t_all) * 1e3,
                    calls=list(tiers)))
    finally:
        (ipm_lanes.solve_qcqp_polished_batch,
         ipm_lanes.solve_qcqp_ipm_lanes) = keep
    tier0_ms = [sum(c["ms"] for c in p["calls"]
                    if c["call"].startswith("tier 0")) for p in split_passes]

    # And one pass under the profiler: time the device spends in kernels,
    # against the pass time measured above without the profiler.
    busy = device_time_of(lambda: strict_call(mtt, sc))
    if busy is not None:
        busy["busy_share_of_mean_pass"] = busy["device_ms"] / ms

    # The same call on a 512-row prefix through the plain versions.
    n_pre = min(512, batch)
    kern = strict_call(mtt, sc, n=n_pre)
    with plain_kernels():
        plain = strict_call(mtt, sc, n=n_pre)
    agree = int((kern.verdict == plain.verdict).sum())
    plain_summary = strict_summary(mtt, plain, n_pre)

    emit("strict_path", config="K=10 N=10 D=3 strict router with its "
         "defaults, radii 0.8: tier 0 ADMM 48 it + 2 snap sweeps, tier 1 it6 "
         "+ 2 snaps with a 128-row speculative restart, tier 1.5 restart "
         "chain, tier 2 float64 rows IPM on the card", passes=n_pass,
         ms_per_batch=ms, pass_ms=pass_ms,
         best_ms=min(pass_ms), worst_ms=max(pass_ms),
         wall_ms_per_batch=wall_ms, solves_per_s=batch / (ms * 1e-3),
         **summary, launches_in_timed_passes=launches,
         launches_per_pass={n: v / n_pass for n, v in launches.items()},
         peak_device_memory_bytes=peak,
         tier_split_ms=split_passes[0]["calls"],
         tier_split_total_ms=split_passes[0]["total_ms"],
         tier_split_passes=split_passes, tier0_split_ms=tier0_ms,
         tier0_split_median_ms=statistics.median(tier0_ms),
         tier2=tier2_log,
         profiler=busy if busy is not None else "not measured",
         plain_prefix=dict(n=n_pre, verdicts_agree=agree,
                           kernel=strict_summary(mtt, kern, n_pre),
                           plain=plain_summary),
         nvidia_smi=state.get("nvidia_smi"))
    if not shapes_ok:
        raise RuntimeError("strict_path: unexpected output shapes")
    if summary["false_feasible"] or plain_summary["false_feasible"]:
        raise RuntimeError("strict_path: a FEASIBLE verdict at a violation "
                           f">= {STRICT_GATE}")
    if summary["undetermined"]:
        raise RuntimeError(f"strict_path: {summary['undetermined']} of "
                           f"{batch} rows UNDETERMINED with tier 2 on")
    if not summary["finite_cost"]:
        raise RuntimeError("strict_path: non-finite cost on a feasible row")
    idle = [n for n in STRICT_KERNELS if launches[n] == 0]
    if idle:
        raise RuntimeError(f"strict_path: kernels never launched: {idle}")
    if agree < 0.97 * n_pre:
        raise RuntimeError(f"strict_path: kernel and plain routers agree on "
                           f"{agree}/{n_pre} verdicts")


def verdicts_of(mtt, viol, inf):
    import numpy as np
    return np.where(viol < STRICT_GATE, mtt.FEASIBLE,
                    np.where(inf, mtt.INFEASIBLE, mtt.UNDETERMINED))


def phase_strict_tight(state, mtt):
    import numpy as np
    import torch
    from mav_tube_trajectory_generation_tpu_torch.solver import auto
    k, batch = 10, 512
    sc = mtt.make_inputs(k, batch, seed=0)
    radii = mtt.tight_radii(k, batch)
    reset_launches()
    tier2_log, tier2_args = [], []
    t0 = time.perf_counter()
    with tier2_observed(tier2_log, keep_args=tier2_args):
        res = strict_call(mtt, sc, radii=radii)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    summary = strict_summary(mtt, res, batch)

    # The float64 tier again from the state the router handed it: once more
    # on the card (it must repeat itself) and once on the CPU.
    def rerun(device):
        args, kwargs = tier2_state_copy(*tier2_args[0])
        args[8] = [f.to(device) for f in args[8]]         # merged fields
        kwargs["device"] = device
        t = time.perf_counter()
        merged, _ = auto._run_tier2_f64(*args, **kwargs)
        torch.cuda.synchronize()
        pos = auto._sel_positions(args[9])["max_violation"]
        idx = args[5]
        return dict(viol=args[6], inf=args[7],
                    merged_viol=merged[pos].cpu().numpy()[idx],
                    seconds=time.perf_counter() - t)

    compare = None
    if tier2_args:
        card = rerun(res.solution.cost.device)
        host = rerun("cpu")
        v_card = verdicts_of(mtt, card["viol"], card["inf"])
        v_host = verdicts_of(mtt, host["viol"], host["inf"])
        both = (v_card == mtt.FEASIBLE) & (v_host == mtt.FEASIBLE)
        compare = dict(
            rows=int(v_card.size), verdicts_agree=int((v_card == v_host).sum()),
            card_verdicts=np.bincount(v_card.astype(int) + 1,
                                      minlength=3).tolist(),
            host_verdicts=np.bincount(v_host.astype(int) + 1,
                                      minlength=3).tolist(),
            verdict_order="[infeasible, undetermined, feasible]",
            max_violation_diff_where_both_feasible=float(np.abs(
                card["merged_viol"][both] - host["merged_viol"][both]).max())
            if both.any() else None,
            card_seconds=card["seconds"], host_seconds=host["seconds"])
    emit("strict_tight", config="K=10 strict router with its defaults, one "
         "radius per scenario log-uniform in [0.05, 0.3]; correctness only",
         seconds_first_call=seconds, launches=ipm_launches(), tier2=tier2_log,
         tier2_card_vs_host=compare,
         max_undetermined=MAX_TIGHT_UNDETERMINED, **summary)
    if summary["false_feasible"]:
        raise RuntimeError("strict_tight: a FEASIBLE verdict at a violation "
                           f">= {STRICT_GATE}")
    if summary["undetermined"] > MAX_TIGHT_UNDETERMINED:
        raise RuntimeError(f"strict_tight: {summary['undetermined']} rows "
                           f"UNDETERMINED, more than without tier 2")
    if not summary["finite_cost"]:
        raise RuntimeError("strict_tight: non-finite cost on a feasible row")
    if summary["n_escalated"] == 0 or not tier2_log:
        raise RuntimeError("strict_tight: nothing escalated, or tier 2 did "
                           "not run")
    if compare["verdicts_agree"] < 0.97 * compare["rows"]:
        raise RuntimeError(f"strict_tight: tier 2 on the card and on the "
                           f"host disagree: {compare}")


def ipm_kernel_rows(state, mtt):
    """Rows of the `kernels` line for the five interior-point kernels, each
    timed on a call its path itself made (recorded in the path's warm-up;
    the full-Gram evaluation on tier 1's recorded inputs)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    if not have_recorded(state, ("ipm_eval_step", "ipm_solve_fused"),
                         "the interior-point kernels (fused_path and "
                         "strict_path)"):
        return []
    rec = state["recorded"]
    launches = dict(state["strict_launches"],
                    ipm_solve_fused=state["fused_launches"],
                    ipm_eval_step_gram=state["gram_launches"])
    rows = []

    def finish(name, source, replaces, fn, fn_plain, names, args, kw, flops,
               library=None, note=None, count=None, extra_check=None,
               uncapped=(), design=None, design_flops=None):
        ms = cuda_ms(lambda: fn(*args, **kw), reps=5)
        dev_ms = device_ms_each(lambda: fn(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: fn_plain(*args, **kw), reps=2)
        lib_ms = cuda_ms(library, reps=5) if library else None
        res, ok, summary = check_call(fn, fn_plain, names, args, kw,
                                      uncapped=uncapped)
        outs = as_tuple(fn(*args, **kw))
        if extra_check is not None:
            more, more_ok = extra_check(outs)
            res.update(more)
            ok = ok and more_ok
        if not ok:
            raise RuntimeError(f"kernels: {name} disagrees with its plain "
                               f"version at its path's shapes: {res}")
        total = nbytes(args) + nbytes(outs)
        bytes_ms = total / PEAK_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_F32_FLOPS * 1e3
        bound = dict(bound_ms=max(bytes_ms, flops_ms),
                     bound_by="operations" if flops_ms >= bytes_ms
                     else "bytes")
        if design_flops is not None:
            d_ms = design_flops / PEAK_F32_FLOPS * 1e3
            bound.update(design_flops=design_flops,
                         design_bound_ms=max(bytes_ms, d_ms))
            if ms < bound["bound_ms"]:
                # faster than the dense work allows: the kernel skips the
                # exact zeros of this data, so the bound counts only the
                # terms this run's lanes need
                bound.update(bound_ms=max(bytes_ms, d_ms),
                             bound_by="operations" if d_ms >= bytes_ms
                             else "bytes",
                             bound_is="the work this run's data needs "
                             "(design_flops): the kernel ran under the dense "
                             "operation count's bound")
        rows.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{source}",
            replaces=replaces, launches=launches[count or name],
            max_abs_err=res["worst_scaled_err"],
            max_abs_err_is="worst output and worst row of ALL rows, kernel "
            "vs plain float32, as a share of max|plain float64 output|",
            max_abs_err_by_output={n: v["kernel_vs_plain_max"]
                                   for n, v in summary.items()},
            median_err_vs_plain_f64_by_output={
                n: [v["kernel_vs_plain_f64"][0], v["plain_vs_plain_f64"][0]]
                for n, v in summary.items()},
            median_err_order="[kernel, plain float32]",
            gross_rows=res["gross_rows"],
            gross_rows_plain_f32=res["gross_rows_plain_f32"],
            rows_beyond_2e_4=res["rows_outside"],
            tolerance="the three criteria of the ipm_kernel_check line",
            ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
            device_ms_is="device time of one call by torch.profiler (mean "
            "of 10), the kernels alone", design=design, **bound,
            library_ms=lib_ms, shapes=dict(gt=list(args[0].shape), note=note),
            flops=flops, bytes=total, bound_flops_ms=flops_ms,
            bound_bytes_ms=bytes_ms,
            **{k_: v for k_, v in res.items()
               if k_ in ("residual_class", "short_runs",
                         "plain_rows_flooring_a_pivot",
                         "band_vs_band_kernel_scaled_err")}))

    def eval_flops(bsz, nfd, m_p, blk, n_ball):
        # band blocks over the m_p lanes and the n_ball Jacobian rows (one
        # multiply by the weight and one multiply-add per term), forming the
        # Jacobian rows, and the three matvecs y, J^T (w r2), J^T (1/s)
        m_blk = nfd // blk
        return bsz * ((2 * m_blk - 1) * 2 * blk * blk * (m_p + n_ball)
                      + 5 * nfd * n_ball + 3 * 2 * nfd * m_p)

    dev = torch.device("cuda")
    args, kw = to_device(rec["ipm_pipe_step"], dev)
    bsz, nfd, m_p = args[0].shape
    blk = kw["blk"]
    m_blk = nfd // blk
    # snap update: column solve (3 m - 2 block matvecs), G dx, eight line
    # search sums; snap evaluation as above
    flops = (eval_flops(bsz, nfd, m_p, blk, kw["n_ball"])
             + bsz * ((3 * m_blk - 2) * 2 * blk * blk + 2 * nfd * m_p
                      + 8 * 8 * m_p))
    finish("ipm_pipe_step", "ipm_pipe.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:365",
           ipm_kernel.ipm_pipe_step, ipm_kernel.ipm_pipe_step_plain,
           PIPE_OUT, args, kw, flops,
           note="tier 0, upd_mode=snap, eval_mode=snap", uncapped=("bm",),
           design=ipm_design_of(ipm_kernel, "ipm_pipe_step", args, kw))

    args, kw = to_device(rec["ipm_eval_step"], dev)
    bsz, nfd, m_p = args[0].shape
    finish("ipm_eval_step", "ipm_eval.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:426",
           ipm_kernel.ipm_eval_step, ipm_kernel.ipm_eval_step_plain,
           EVAL_OUT, args, kw,
           eval_flops(bsz, nfd, m_p, kw["band_block"], kw["n_ball"]),
           note="tier 1 (the escalated rows), band output, phr=False",
           design=ipm_design_of(ipm_kernel, "ipm_eval_step", args, kw))

    # the same inputs with the whole Gram out.  The Gram is symmetric: the
    # work the function needs is its upper triangle, nfd (nfd + 1) / 2
    # entries over the m_p lanes and the n_ball Jacobian rows (the kernel
    # computes every block pair, twice that).
    gkw = dict(kw, band_block=0)
    band = ipm_kernel.ipm_eval_step(*args, **kw)
    y_, c_, _, _, lam_ball, aj, w_aj = ipm_kernel._eval_core(
        *args, nb_p=kw["nb_p"], n_ball=kw["n_ball"], w_cap=kw["w_cap"],
        phr=kw["phr"])
    gl, aw = (args[0] * lam_ball).contiguous(), (aj * w_aj).contiguous()
    gt_t = args[0].transpose(1, 2).contiguous()
    aj_t = aj.transpose(1, 2).contiguous()
    del y_, c_, lam_ball, w_aj

    def band_blocks_agree(outs):
        err = gram_band_mismatch(outs[4], band[4], band[5], kw["band_block"])
        return (dict(band_vs_band_kernel_scaled_err=err), err <= IPM_ROW_TOL)

    # the terms the cluster design sums on these inputs: every lane and
    # Jacobian row into the block pairs (i, j >= i) it reaches (a ball's row
    # reaches what its three lanes do), a multiply by the weight and blk^2
    # multiply-adds a term, besides the three matvecs
    gblk = ipm_kernel.gram_row_block(nfd)
    nb_p, n_ball = kw["nb_p"], kw["n_ball"]
    reach = (args[0].reshape(bsz, nfd // gblk, gblk, m_p) != 0).any(2)
    ball = reach[:, :, :nb_p] | reach[:, :, nb_p:2 * nb_p] | \
        reach[:, :, 2 * nb_p:3 * nb_p]
    n_l, n_b = reach.sum(1).double(), ball[:, :, :n_ball].sum(1).double()
    pairs = float((n_l * (n_l + 1) / 2).sum() + (n_b * (n_b + 1) / 2).sum())
    gram_design_flops = (pairs * (2 * gblk * gblk + gblk)
                         + bsz * (5 * nfd * n_ball + 3 * 2 * nfd * m_p))
    del reach, ball

    finish("ipm_eval_step(band_block=0)", "ipm_eval.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:426 "
           "(pallas_call at :480)",
           ipm_kernel.ipm_eval_step, ipm_kernel.ipm_eval_step_plain,
           GRAM_OUT, args, gkw,
           bsz * (nfd * (nfd + 1) * (m_p + kw["n_ball"])
                  + 5 * nfd * kw["n_ball"] + 3 * 2 * nfd * m_p),
           library=lambda: torch.baddbmm(torch.bmm(gl, gt_t), aw, aj_t),
           note="tier 1's rows through the public wrapper, phr=False; "
           "library call: two torch.bmm products on the weighted operands, "
           "which are prepared outside the timed call",
           count="ipm_eval_step_gram", extra_check=band_blocks_agree,
           design=ipm_design_of(ipm_kernel, "ipm_eval_step_gram", args, gkw),
           design_flops=gram_design_flops)
    del gl, aw, gt_t, aj_t, aj, band

    args, kw = to_device(rec["ipm_solve_fused"], dev)
    bsz, nfd, m_p = args[0].shape
    blk = kw["blk"]
    m_blk = nfd // blk
    steps = kw["n_iters"] + kw["snap_iters"]
    # per step: one evaluation, the band factor (for each block the Schur
    # complement, C^T C, and the elimination of [S | I | U | v], about
    # blk^2 (3 blk + 1) multiply-adds), the back-substitution, G dx, and the
    # update's lane sums
    flops = steps * (eval_flops(bsz, nfd, m_p, blk, kw["n_ball"])
                     + bsz * (m_blk * (2 * blk ** 3
                                       + 2 * blk * blk * (3 * blk + 1))
                              + m_blk * 4 * blk * blk
                              + 2 * nfd * m_p + 8 * 8 * m_p))

    def in_solution_class(outs):
        """The whole polish in its solution class, and short runs from the
        same start state (one Newton step, one step and a sweep, three
        steps: lam_mid is then taken one step before lam_fin_max) held to
        the row criteria in every output.  Reported: the rows in which
        the plain version floors a pivot of its band factor, in float32
        and in float64."""
        floors = {}
        with counting_floors(ipm_kernel, floors, kw):
            cls, cls_ok = fused_class(ipm_kernel, args, kw, outs)
            ipm_kernel.ipm_solve_fused_plain(*(to64(a) for a in args), **kw)
        short = []
        for n_it, n_snap in ((1, 0), (1, 1), (3, 0)):
            skw = dict(kw, n_iters=n_it, snap_iters=n_snap)
            res, ok, summary = check_call(
                ipm_kernel.ipm_solve_fused, ipm_kernel.ipm_solve_fused_plain,
                FUSED_OUT, args, skw, uncapped=fused_uncapped(skw))
            entry = dict(n_iters=n_it, snap_iters=n_snap, ok=ok,
                         max_abs_err_by_output={
                             n: v["kernel_vs_plain_max"]
                             for n, v in summary.items()},
                         median_err_vs_plain_f64_by_output={
                             n: [v["kernel_vs_plain_f64"][0],
                                 v["plain_vs_plain_f64"][0]]
                             for n, v in summary.items()},
                         gross_rows_by_output={
                             n: [v["gross_rows"], v["gross_rows_plain_f32"]]
                             for n, v in summary.items()})
            if (n_it, n_snap) == (1, 0):
                entry["kernel_with_one_scalar_off_rejected"], rej_ok = \
                    fused_controls_rejected(ipm_kernel, args, skw, summary)
                ok = ok and rej_ok
            if not ok:
                entry["outputs"] = summary
            short.append(entry)
            cls_ok = cls_ok and ok
        return dict(residual_class=cls, short_runs=short,
                    plain_rows_flooring_a_pivot=floored_counts(floors)), cls_ok

    finish("ipm_solve_fused", "ipm_solve.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:841",
           ipm_kernel.ipm_solve_fused, ipm_kernel.ipm_solve_fused_plain,
           FUSED_OUT, args, kw, flops,
           note=f"fused_path, {kw['n_iters']} Newton steps + "
           f"{kw['snap_iters']} snap sweeps in one launch",
           extra_check=in_solution_class, uncapped=fused_uncapped(kw),
           design=ipm_design_of(ipm_kernel, "ipm_solve_fused", args, kw))
    del args
    torch.cuda.empty_cache()

    args, kw = to_device(rec["gt_matvec"], dev)
    bsz, nfd, m_p = args[0].shape
    gt, v = args
    finish("gt_matvec", "gt_matvec.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:901",
           ipm_kernel.gt_matvec, ipm_kernel.gt_matvec_plain, ("y",), args,
           kw, 2 * bsz * nfd * m_p,
           library=lambda: torch.bmm(v.transpose(1, 2), gt),
           note="tier 1 (the escalated rows); library call: torch.bmm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_rows = {}
    # The restart's and the chain's row counts: the first rows of the same
    # call, each beside torch.bmm in this call.
    # Each output held to the float32 summation bound of any order, nfd
    # 2^-24 sum_r |gt[r, l] v[r]| from the exact sum, and run to run.
    for n in (bsz, 128, 1):
        g_n, v_n = gt[:n].contiguous(), v[:n].contiguous()
        y = ipm_kernel.gt_matvec(g_n, v_n)
        again = ipm_kernel.gt_matvec(g_n, v_n)
        exact = ipm_kernel.gt_matvec_plain(g_n.double(), v_n.double())
        mags = ipm_kernel.gt_matvec_plain(g_n.double().abs(),
                                          v_n.double().abs())
        err = (y.double() - exact).abs()
        if not (torch.equal(y, again)
                and bool((err <= nfd * 2.0 ** -24 * mags).all())):
            raise RuntimeError(f"kernels: gt_matvec outside the float32 "
                               f"summation bound at {n} rows")
        by_rows[n] = dict(
            ms=cuda_ms(lambda: ipm_kernel.gt_matvec(g_n, v_n), reps=20),
            bmm_ms=cuda_ms(lambda: torch.bmm(v_n.transpose(1, 2), g_n),
                           reps=20),
            device_ms=device_ms_each(
                lambda: ipm_kernel.gt_matvec(g_n, v_n), 20),
            bmm_device_ms=device_ms_each(
                lambda: torch.bmm(v_n.transpose(1, 2), g_n), 20),
            bound_ms=(nbytes((g_n, v_n)) + n * m_p * 4)
            / PEAK_BYTES_PER_S * 1e3,
            chunk=ipm_kernel.matvec_chunk(n, m_p, sms),
            max_err_share_of_bound=float((err / (nfd * 2.0 ** -24 * mags)
                                          ).nan_to_num(0.0).max()))
    # At 128 and 1 rows a call takes less device time than its wrapper
    # takes on the host, so CUDA events over back-to-back calls time the
    # host: the row's ms and library_ms stay the event times (as in every
    # earlier row), the device times of one call stand beside them.
    row = rows[-1]
    row.update(device_ms=by_rows[bsz]["device_ms"],
               library_device_ms=by_rows[bsz]["bmm_device_ms"],
               device_ms_is="device time of one call by torch.profiler "
               "(mean of 20), the kernels alone")
    # The roofline share from the CUDA-event time (torch.profiler's device
    # times read below the events on the H100 machine, so a share from them
    # would be overstated); a share above 1 would be a wrong bound.
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if not 0.0 < r["bound_share"] <= 1.0:
            raise RuntimeError(f"kernels: {r['name']} ran in {r['ms']} ms, "
                               f"below its bound of {r['bound_ms']} ms")
    row["by_rows"] = by_rows
    row["by_rows_is"] = (
        "rows of tier 1's call (about 650), the speculative restart's 128, "
        "the chain's 1; ms and bmm_ms by CUDA events over 20 calls (host time "
        "of a call included where it exceeds the kernel's), device_ms and "
        "bmm_device_ms by torch.profiler, the kernels alone")
    return rows


def device_ms_each(fn, reps):
    """Device time of one ``fn()`` (the mean of ``reps`` under
    torch.profiler, ``device_time_of``).  A trace of a few launches late in
    a long process has come back without device events once: it is taken
    again with four times the launches, then raises."""
    fn()
    for n in (reps, 4 * reps):
        res = device_time_of(lambda: [fn() for _ in range(n)])
        if res is not None:
            return res["device_ms"] / n
    raise RuntimeError("kernels: torch.profiler shows no device time")


def phase_kernels(state, mtt):
    """The summary line: each kernel's time at the main path's shapes beside
    its plain version's and its bound."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    cfg = bench_config(mtt)
    batch = MAIN_BATCH
    args, kw = stage_inputs(mtt, 10, batch, seed=0, config=cfg)
    _, nfd, m_p = args[4].shape
    m_blk, bsz = args[1].shape[1], args[1].shape[-1]
    design = admm_kernel.factored_design(nfd, m_p, m_blk, bsz, kw["nb_p"])

    def kernel():
        return admm_kernel.admm_stage_fused_factored(*args, init_z=True, **kw)

    kernel_ms = cuda_ms(kernel, reps=5)
    plain_ms = cuda_ms(lambda: admm_kernel.admm_stage_fused_factored_plain(
        *args, init_z=True, **kw), reps=2)
    winv_plain_ms = cuda_ms(
        lambda: admm_kernel.admm_stage_fused_factored_winv_plain(
            *args, init_z=True, **kw), reps=2)
    # Device memory the wrapper takes beyond its seven outputs (the stream
    # design's m1 scratch; none on the cluster design).
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = kernel()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - nbytes(outs)
    del outs
    ours, plain, plain64, ref32 = run_three(admm_kernel, args, kw)
    cmp, ok = compare_outputs(ours, plain, plain64, ref32)
    del plain, plain64, ref32
    if not ok:
        raise RuntimeError(f"kernels: disagreement at batch {batch}: {cmp}")
    if design == "cluster" and scratch > 0:
        raise RuntimeError(f"kernels: kernel 1's cluster design took "
                           f"{scratch} bytes of scratch")
    diffs = cmp["kernel_vs_plain"]

    # Bound from this run's shapes: every input read once, every output
    # written once; the work of ``stage_flops`` (the reference order's, so
    # that rows compare across designs), and beside it the work of the
    # design's own order.
    in_bytes = nbytes(args)
    out_bytes = nbytes(ours)
    flops = stage_flops(batch, nfd, m_p, m_blk, bsz, kw["n_iters"])
    d_flops = winv_stage_flops(batch, nfd, m_p, m_blk, bsz, kw["n_iters"])
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    d_flops_ms = d_flops / PEAK_F32_FLOPS * 1e3
    row = dict(
        name="admm_stage_fused_factored", route="cuda",
        source="mav_tube_trajectory_generation_tpu_torch/csrc/admm_stage.cu",
        replaces="mav_tube_trajectory_generation_tpu/ops/admm_kernel.py:604",
        launches=state["launches"], design=design,
        cluster=2 if design == "cluster" else 1,
        max_abs_err=max(diffs.values()), max_abs_diff=max(diffs.values()),
        max_abs_err_is="largest |kernel - plain float32 in the kernel's "
        "order| over the outputs",
        max_abs_err_vs_plain_f64=max(cmp["kernel_vs_plain_f64"].values()),
        plain_f32_vs_plain_f64=max(cmp["plain_vs_plain_f64"].values()),
        errors=cmp, tolerance=KERNEL_TOL * cmp["scale"],
        ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        winv_plain_ms=winv_plain_ms,
        plain_ms_is="the reference order's plain version (the wrapper's on "
        "the CPU); winv_plain_ms: the cluster design's order",
        wrapper_scratch_bytes=scratch,
        bound_ms=max(bytes_ms, flops_ms),
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
        design_flops=d_flops, design_bound_ms=max(bytes_ms, d_flops_ms),
        library_ms=None, shapes=dict(batch=batch, nfd=nfd, m_p=m_p,
                                     m_blk=m_blk, bsz=bsz,
                                     n_iters=kw["n_iters"]),
        flops=flops, bytes=in_bytes + out_bytes,
        bound_flops_ms=flops_ms, bound_bytes_ms=bytes_ms)
    del args, kw, ours
    torch.cuda.empty_cache()
    rows = ([row] + ew_rows(state) + admm_route_rows(state)
            + ipm_kernel_rows(state, mtt) + spd_inverse_rows(state, mtt))
    for r in rows:
        r.setdefault("bound_share", r["bound_ms"] / r["ms"])
    # thirteen kernels; #2 has a row at K=10 and one at K=2
    if not state.get("partial") and len(rows) != 14:
        raise RuntimeError(f"kernels: {len(rows)} rows, expected 14")
    say(json.dumps({"kernels": rows}))


def spd_inverse_flops(n):
    """Operations of one n x n inverse in the kernel's order, 2 flops a
    multiply-add: the Cholesky factor n^3 / 3, the forward solves against
    the identity's columns n^3 / 3, the backward solves n^3."""
    return 5 * n ** 3 / 3


def spd_inverse_rows(state, mtt):
    """The row of the `kernels` line for the small SPD inverse (#13,
    csrc/spd_inverse.cu), on the blocks one main-path call at batch 6144
    inverts, recorded from that call: the warm start's 36 x 36 block and the
    nine 15 x 15 pivot blocks.  On the same card tensors, in float32 as the
    call has them and in float64, the kernel (``spd_inverse_cuda``) is held
    to the library chain (``_spd_inverse_library``, the plain version, run
    on the card): the same refusal flags, an exactly symmetric result,
    finite where the chain's is, and the gap of SPD_INVERSE_RTOL.  The
    row's ms, bound_ms and library_ms are a call's ten launches in float32;
    ``shapes`` holds each shape's launch in both types."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import linalg
    sc = mtt.make_inputs(10, MAIN_BATCH, seed=0)
    seen = []
    inverse = linalg.spd_inverse

    def record(a):
        seen.append(a.contiguous().clone())
        return inverse(a)

    linalg.spd_inverse = record
    try:
        solve(mtt, sc, bench_config(mtt))
    finally:
        linalg.spd_inverse = inverse
    del sc
    if len(seen) != SPD_INVERSE_LAUNCHES:
        raise RuntimeError(f"kernels: the main path inverted {len(seen)} "
                           f"batches of blocks, expected "
                           f"{SPD_INVERSE_LAUNCHES}")
    groups = {}
    for a in seen:
        groups.setdefault(a.shape[-1], []).append(a)
    shapes, bad = [], []
    call = dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for n, blocks in sorted(groups.items()):
        for dtype in (torch.float32, torch.float64):
            blk = [b.to(dtype) for b in blocks]
            kind = str(dtype).replace("torch.", "")
            ms = cuda_ms(lambda: [linalg.spd_inverse_cuda(b) for b in blk],
                         reps=10) / len(blk)
            lib_ms = cuda_ms(lambda: [linalg._spd_inverse_library(b)
                                      for b in blk], reps=5) / len(blk)
            dev_ms = device_ms_each(lambda: linalg.spd_inverse_cuda(blk[0]),
                                    10)
            gap, refused, refused_lib, flags_same, symmetric, finite = (
                0.0, 0, 0, True, True, True)
            for a in blk:
                x, r = linalg.spd_inverse_cuda(a)
                y, r_lib = linalg._spd_inverse_library(a)
                flags_same &= torch.equal(r != 0, r_lib)
                symmetric &= torch.equal(x, x.transpose(-1, -2))
                keep = torch.isfinite(y).flatten(1).all(1)
                finite &= bool(torch.isfinite(x[keep]).all())
                d = torch.sqrt(torch.diagonal(a, dim1=-2, dim2=-1))
                dd = d[..., :, None] * d[..., None, :]
                g = (((x - y) * dd).abs().amax(dim=(-2, -1))
                     / (y * dd).abs().amax(dim=(-2, -1)))[keep]
                gap = max(gap, float(g.max()) if g.numel() else 0.0)
                refused += int(r.sum())
                refused_lib += int(r_lib.sum())
            batch = blk[0].numel() // (n * n)
            total = batch * (2 * n * n * blk[0].element_size() + 4)
            bytes_ms = total / PEAK_BYTES_PER_S * 1e3
            flops = batch * spd_inverse_flops(n)
            flops_ms = flops / PEAK_F64_FLOPS * 1e3
            ok = (flags_same and symmetric and finite
                  and gap < SPD_INVERSE_RTOL[kind])
            shapes.append(dict(
                n=n, dtype=kind, batch=batch, launches_a_call=len(blk),
                ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="operations" if flops_ms >= bytes_ms else "bytes",
                flops=flops, bytes=total, max_gap_to_library=gap,
                tolerance=SPD_INVERSE_RTOL[kind], refused=refused,
                refused_by_library=refused_lib, flags_same=flags_same,
                exactly_symmetric=symmetric, finite=finite, ok=ok))
            if not ok:
                bad.append(shapes[-1])
            if dtype == torch.float32:
                call["ms"] += ms * len(blk)
                call["library_ms"] += lib_ms * len(blk)
                call["bound_ms"] += max(bytes_ms, flops_ms) * len(blk)
                bound_by.add(shapes[-1]["bound_by"])
            del blk
    if bad:
        raise RuntimeError(f"kernels: spd_inverse disagrees with the library "
                           f"chain on the main path's blocks: {bad}")
    return [dict(
        name="spd_inverse", route="cuda", source=f"{PKG}/csrc/spd_inverse.cu",
        replaces=None, replaces_is="no Pallas kernel: the JAX package's "
        "ops/linalg.py spd_inverse_schur is matmuls outside any kernel",
        launches=state.get("spd_launches"),
        max_abs_err=max(s["max_gap_to_library"] for s in shapes),
        max_abs_err_is="largest gap to the library chain in the "
        "equilibrated frame, over the block's largest entry",
        tolerance=SPD_INVERSE_RTOL, **call,
        ms_is="a main-path call's ten launches in float32 (CUDA events: "
        "each shape's mean launch times its launches a call)",
        plain_ms=call["library_ms"], plain_ms_is="the plain version is the "
        "library chain (cholesky_ex, cholesky_solve, inv_ex, where) on the "
        "card", bound_by="/".join(sorted(bound_by)), shapes=shapes)]


def nbytes(tensors):
    import torch
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def admm_row(name, source, line, fn, fn_plain, args, kw, flops, launches,
             kind, shape_arg, names=None, library=None, note=None,
             twin=None, design=None, ranks=2, **extra):
    """A row of the `kernels` line for a kernel of ops.admm_kernel, timed on
    ``args`` and held there to its check (``kind`` "stage": compare_outputs,
    criterion 1 against ``twin`` where the kernel's ``design`` sums in
    another order than the reference ``fn_plain``; "band": band_compare
    with output ``names``).  A stage kernel in its cluster design (of
    ``ranks`` blocks a scenario) may take no device memory beyond its
    outputs (no m1 scratch)."""
    import torch
    ms = cuda_ms(lambda: fn(*args, **kw), reps=5)
    plain_ms = cuda_ms(lambda: fn_plain(*args, **kw), reps=2)
    lib_ms = cuda_ms(library, reps=5) if library else None
    ours, ref32, plain64, same = triple(fn, fn_plain, args, kw)
    if kind == "stage":
        plain = ref32 if twin is None else twin(*args, **kw)
        res, ok = compare_outputs(ours, plain, plain64, ref32)
        err = max(res["kernel_vs_plain"].values())
        del plain
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = fn(*args, **kw)
        torch.cuda.synchronize()
        extra["wrapper_scratch_bytes"] = (torch.cuda.max_memory_allocated()
                                          - base - nbytes(outs))
        del outs
        if design == "cluster" and extra["wrapper_scratch_bytes"] > 0:
            raise RuntimeError(f"kernels: {name} took scratch in its cluster "
                               f"design: {extra['wrapper_scratch_bytes']} B")
        if twin is not None:
            extra["twin_plain_ms"] = cuda_ms(lambda: twin(*args, **kw),
                                             reps=2)
    else:
        res, ok = band_compare(names, ours, ref32, plain64)
        err = max(v.get("kernel_vs_plain", 0.0) for v in res.values())
        extra.update(device_ms=device_ms_each(lambda: fn(*args, **kw), 10),
                     device_ms_is="device time of one call by "
                     "torch.profiler (mean of 10), the kernel alone")
    if not (ok and same):
        raise RuntimeError(f"kernels: {name} disagrees with its plain "
                           f"version at its path's shapes: {res}")
    total = nbytes(args) + nbytes(ours)
    bytes_ms = total / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    del ours, ref32, plain64
    torch.cuda.empty_cache()
    if design in ("cluster", "stream"):
        extra.update(design=design,
                     cluster=ranks if design == "cluster" else 1)
    elif design is not None:
        extra["design"] = design
    return dict(
        name=name, route="cuda", source=f"{PKG}/csrc/{source}",
        replaces=f"mav_tube_trajectory_generation_tpu/ops/admm_kernel.py:"
        f"{line}", launches=launches, max_abs_err=err,
        max_abs_err_is="largest |kernel - plain float32 in the kernel's "
        "order| over the outputs",
        errors=res, tolerance="kernel_check_routes' criteria", ms=ms,
        plain_ms=plain_ms, bound_ms=max(bytes_ms, flops_ms),
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
        library_ms=lib_ms, shapes=dict(
            **{"e" if name.endswith("_ew") else "gt":
               list(args[shape_arg].shape)}, note=note),
        flops=flops, bytes=total, bound_flops_ms=flops_ms,
        bound_bytes_ms=bytes_ms, **extra)


def band_row_design(ak, bsz, nfd, m_p, blk, source="stored"):
    """The `kernels` row fields of a band kernel's design at these shapes
    (G^T ``source``): ``band_design``'s, and for the ring its grid and
    blocks an SM on this card."""
    d = ak.band_design(nfd, m_p, blk, source)
    out = dict(design=d.design, band_design=d._asdict())
    if d.design == "ring":
        out.update(grid=ak.ring_grid(bsz, m_p, d),
                   blocks_per_sm=ak.ring_blocks_per_sm(m_p, d))
    return out


def band_library(gt_fn, pb=None, rho=None, sigma=0.0):
    """One PyTorch computation of the band kernels' function: G^T
    (``gt_fn()``), ``torch.bmm(gt, gt.mT)``, the band gather, and with
    ``pb`` the adds of the KKT band."""
    import torch

    def call():
        gt = gt_fn()
        bsz, nfd, _ = gt.shape
        m_blk = nfd // BAND_BLOCK
        g5 = torch.bmm(gt, gt.mT).reshape(bsz, m_blk, BAND_BLOCK, m_blk,
                                          BAND_BLOCK)
        gd = torch.stack([g5[:, i, :, i, :] for i in range(m_blk)], 1)
        gu = torch.stack([g5[:, i, :, i + 1, :] for i in range(m_blk - 1)], 1)
        if pb is None:
            return gd, gu
        eye = torch.eye(BAND_BLOCK, dtype=gt.dtype, device=gt.device)
        return (pb[0] + rho[:, None] * gd + sigma * eye,
                pb[1] + rho[:, None] * gu)
    return call


def band_flops(bsz, nfd, m_p, blk, factors=False):
    """Multiply-adds (x2) of the 2m-1 band blocks over m_p lanes, and with
    ``factors`` the KKT band's adds."""
    m_blk = nfd // blk
    out = bsz * (2 * m_blk - 1) * 2 * blk * blk * m_p
    if factors:
        out += bsz * ((2 * m_blk - 1) * 2 * blk * blk + m_blk * blk)
    return out


def stage_flops(bsz, nfd, m_p, m_blk, bs, n_iters):
    """Kernel 1's work: (3m - 2) products of (b, b) @ (b, m_p) and
    2 n_iters + 2 matvecs against (nfd, m_p), 2 flops per multiply-add."""
    return bsz * ((3 * m_blk - 2) * 2 * bs * bs * m_p
                  + (2 * n_iters + 2) * 2 * nfd * m_p)


def winv_stage_flops(bsz, nfd, m_p, m_blk, bs, n_iters):
    """The cluster design's work: W^-1 by the (3m - 2) sweep steps of
    (b, b) @ (b, nfd), then y0, n_iters x (G^T v, W^-1 g, G x) and the dual
    matvec, 2 flops per multiply-add."""
    return bsz * ((3 * m_blk - 2) * 2 * bs * bs * nfd
                  + n_iters * (2 * 2 * nfd * m_p + 2 * nfd * nfd)
                  + 2 * 2 * nfd * m_p)


def have_recorded(state, need, what):
    """Whether the calls a group of rows is timed on were recorded; in a
    partial run a group without them is left out, in a whole run that
    raises."""
    if set(need) <= set(state.get("recorded", {})):
        return True
    if state.get("partial"):
        return False
    raise RuntimeError(f"the kernels phase times {what} on calls recorded "
                       f"by earlier phases: run them in the same call")


def given_device_ms(fn, reps=10):
    """#7's device time a launch by torch.profiler over ``reps`` calls:
    the kernels' time over the launches the trace holds.  A process's traces
    hold fewer of the launches made the more kernels it has launched before
    (profiler_probe.py), and by this phase a 10-call trace of #7 has come
    back with none: it is taken again with four times the calls, then
    raises."""
    fn()
    for n in (reps, 4 * reps):
        res = device_time_of(lambda: [fn() for _ in range(n)])
        if res is not None:
            return dict(device_ms=res["device_ms"] / res["launches"],
                        device_launches_in_trace=res["launches"],
                        device_ms_is=f"device time a launch by torch.profiler"
                        f" over {n} calls: kernel time over the launches in "
                        f"the trace")
    raise RuntimeError("kernels: torch.profiler shows no device time")


def admm_route_rows(state):
    """Rows of the `kernels` line for kernels #2 (at K=10 on route (a) and
    at K=2), #7, #6 and #5, each timed on a call its path made (recorded by
    dense_path, main_path and band_gram), and held to its check at those
    shapes."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as ak
    need = {"admm_stage_fused a", "admm_stage_fused c", "admm_stage",
            "gram_band", "gram_band_factors"}
    if not have_recorded(state, need, "kernels #2, #5, #6 and #7 (dense_path, "
                         "main_path and band_gram)"):
        return []
    rec = state["recorded"]
    dev = torch.device("cuda")
    rows = []

    for label, note in (("a", "dense_path (a): K=10, kkt_apply='inverse', "
                         "stage 0"),
                        ("c", "dense_path (c): K=2, its only route, stage "
                         "0")):
        args, kw = to_device(rec[f"admm_stage_fused {label}"], dev)
        bsz, nfd, m_p = args[2].shape
        winv, gt = args[1], args[2]
        # m1 = winv gt, then y0, n_iters x (x, y) and the dual matvec
        flops = bsz * (2 * nfd * nfd * m_p
                       + (2 * kw["n_iters"] + 2) * 2 * nfd * m_p)
        design, twin = fused_check_design(ak, gt, kw["nb_p"])
        rows.append(admm_row(
            f"admm_stage_fused ({'K=10' if label == 'a' else 'K=2'})",
            "admm_stage.cu", 549, ak.admm_stage_fused,
            ak.admm_stage_fused_plain, args, kw, flops,
            state["route_launches"][label], "stage", 2, note=note,
            twin=twin, design=design,
            m1_bmm_ms=cuda_ms(lambda: torch.bmm(winv, gt), reps=5),
            m1_bmm_is="torch.bmm(winv, gt): the stream design's m1 phase "
            "alone, as a library product"))
        del args, winv, gt
        torch.cuda.empty_cache()

    args, kw = to_device(rec["admm_stage"], dev)
    bsz, nfd, m_p = args[2].shape
    shapes = (nfd, m_p, 0, 0, kw["nb_p"])
    design = ak.given_design(nfd, m_p, kw["nb_p"])
    cluster = design == "cluster"
    rows.append(admm_row(
        "admm_stage", "admm_stage.cu", 663, ak.admm_stage,
        ak.admm_stage_plain, args, kw,
        bsz * kw["n_iters"] * 2 * 2 * nfd * m_p, state["stage_launches"],
        "stage", 2, note="no caller in either package: its public wrapper, "
        "driven once by dense_path on route (a)'s stage inputs",
        twin=ak.admm_stage_given_plain if cluster else None, design=design,
        ranks=ak.cluster_ranks("admm_stage"),
        max_active_clusters=ak.cluster_occupancy(*shapes, "admm_stage")
        if cluster else None,
        block_threads=ak.block_threads(*shapes, "admm_stage")
        if cluster else None,
        **given_device_ms(lambda: ak.admm_stage(*args, **kw))))
    del args
    torch.cuda.empty_cache()

    args, kw = to_device(rec["gram_band"], dev)
    gt = args[0]
    rows.append(admm_row(
        "gram_band", "gram_band.cu", 512, ak.gram_band, ak.gram_band_plain,
        args, kw, band_flops(*gt.shape, kw["blk"]),
        state["main_band_launches"], "band", 0,
        names=("gd", "gu"), library=band_library(lambda: gt),
        note="the main path's default band_gram 'auto', once a solve, on "
        "the call its warm-up made; library call: torch.bmm(gt, gt.mT) and "
        "the band gather; bound: the 2m-1 band blocks only",
        launches_per_pass=state["main_band_launches"] / state["main_passes"],
        pallas_route_launches=state["band_launches"]["pallas"]["gram_band"],
        **band_row_design(ak, *gt.shape, kw["blk"])))
    del args, gt
    args, kw = to_device(rec["gram_band_factors"], dev)
    gt, pb_d, pb_u, rho = args
    rows.append(admm_row(
        "gram_band_factors", "gram_band.cu", 437, ak.gram_band_factors,
        ak.gram_band_factors_plain, args, kw,
        band_flops(*gt.shape, kw["blk"], factors=True),
        state["band_launches"]["pallas_db"]["gram_band_factors"], "band", 0,
        names=("db", "ub"), library=band_library(
            lambda: gt, (pb_d, pb_u), rho, kw["sigma"]),
        note="band_gram='pallas_db', once a stage; library call: as "
        "gram_band's, then the adds", **band_row_design(ak, *gt.shape,
                                                        kw["blk"])))
    del args, gt, pb_d, pb_u, rho
    torch.cuda.empty_cache()
    return rows


def ew_rows(state):
    """Rows of the `kernels` line for kernels #3 and #4, each timed on the
    call the ew path made in its warm-up (stage 0, batch 6144) and held to
    its check there."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel as ak
    if not have_recorded(state, EW_KERNELS, "kernels #3 and #4 (ew_path)"):
        return []
    rec = state["recorded"]
    dev = torch.device("cuda")
    launches = state["ew_launches"]
    args, kw = to_device(rec[EW_KERNELS[0]], dev)
    sinv, e = args[1], args[4]
    bsz, nf, m_p = e.shape
    nfd = 3 * nf
    # kernel 1's work, and forming G^T from its factors once
    flops = (stage_flops(bsz, nfd, m_p, sinv.shape[1], sinv.shape[-1],
                         kw["n_iters"]) + bsz * nfd * m_p)
    design, twin = ew_stage_design(ak, args, kw["nb_p"])
    rows = [admm_row(
        EW_KERNELS[0], "admm_stage.cu", 317, ak.admm_stage_fused_factored_ew,
        ak.admm_stage_fused_factored_ew_plain, args, kw, flops,
        launches.get(EW_KERNELS[0], 0), "stage", 4,
        note="ew_path (gt_assembly='kernel'), stage 0; no single PyTorch "
        "call computes a stage", twin=twin, design=design)]
    del args, sinv, e
    torch.cuda.empty_cache()
    args, kw = to_device(rec[EW_KERNELS[1]], dev)
    e, w, pb_d, pb_u, rho = args
    bsz, nf, m_p = e.shape
    rows.append(admm_row(
        EW_KERNELS[1], "gram_band.cu", 384, ak.gram_band_factors_ew,
        ak.gram_band_factors_ew_plain, args, kw,
        band_flops(bsz, 3 * nf, m_p, kw["blk"], factors=True)
        + bsz * 3 * nf * m_p, launches.get(EW_KERNELS[1], 0), "band", 0,
        names=("db", "ub"), library=band_library(
            lambda: ak.expand_gt(e, w), (pb_d, pb_u), rho, kw["sigma"]),
        note="ew_path, once a stage; library call: e*w expanded, then as "
        "gram_band_factors'; bound: the 17 band blocks and the expansion",
        **band_row_design(ak, bsz, 3 * nf, m_p, kw["blk"], "factors")))
    del args, e, w, pb_d, pb_u, rho
    torch.cuda.empty_cache()
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of: "
                        + ", ".join(ALL_PHASES))
    parser.add_argument("--out", default=None, help="also append every "
                        "line to this file (its directory is created)")
    parser.add_argument("--bits-of-parent", default=None,
                        help="the --out file of the stage_bits, ipm_bits and "
                        "band_bits phases run on the parent's checkout: each "
                        "then fails unless its kernels' outputs (kernel 1's; "
                        "#8's and #9's; #5's and #6's) are the same bits, and "
                        "reports those of the kernels this tree redesigned "
                        "(#7, #4)")
    parser.add_argument("--sharded-child", nargs=4, default=None,
                        metavar=("RANK", "WORLD", "STORE", "OUT"),
                        help="run one rank of the sharded phase (the phase "
                        "starts its ranks itself)")
    opts = parser.parse_args()
    if opts.out:
        global LOG_PATH
        import os
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        LOG_PATH = opts.out
    phases = [p for p in opts.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        parser.error(f"unknown phases: {sorted(unknown)}")

    try:
        import torch
        import mav_tube_trajectory_generation_tpu_torch as mtt
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU mode",
              file=sys.stderr)
        return 2

    if opts.sharded_child:
        rank, world, store, out = opts.sharded_child
        return sharded_child(int(rank), int(world), store, out)

    t_start = time.perf_counter()
    state = {"launches": 0, "partial": set(phases) != set(ALL_PHASES)}
    runners = {
        "toolchain": lambda: phase_toolchain(state),
        "build": lambda: phase_build(state),
        "kernel_check": lambda: phase_kernel_check(state, mtt),
        "main_path": lambda: phase_main_path(state, mtt),
        "multi_stage": lambda: phase_multi_stage(state, mtt),
        "dense_path": lambda: phase_dense_path(state, mtt),
        "band_gram": lambda: phase_band_gram(state, mtt),
        "stage_bits": lambda: phase_stage_bits(state, mtt,
                                               opts.bits_of_parent),
        "ipm_bits": lambda: phase_ipm_bits(state, mtt, opts.bits_of_parent),
        "band_bits": lambda: phase_band_bits(state, mtt, opts.bits_of_parent),
        "ipm_kernel_check": lambda: phase_ipm_kernel_check(state, mtt),
        "fused_path": lambda: phase_fused_path(state, mtt),
        "strict_path": lambda: phase_strict_path(state, mtt),
        "strict_tight": lambda: phase_strict_tight(state, mtt),
        "ew_path": lambda: phase_ew_path(state, mtt),
        "linear_sweep": lambda: phase_linear_sweep(state, mtt),
        "extrema": lambda: phase_extrema(state, mtt),
        "esdf": lambda: phase_esdf(state, mtt),
        "nonlinear_collision": lambda: phase_nonlinear_collision(state, mtt),
        "nonlinear_time": lambda: phase_nonlinear_time(state, mtt),
        "sharded": lambda: phase_sharded(state, mtt),
        "kernels": lambda: phase_kernels(state, mtt),
    }
    for name in ALL_PHASES:
        if name in phases:
            runners[name]()
            torch.cuda.synchronize()
    if set(phases) != set(ALL_PHASES):
        print(f"chip_smoke: partial run ({','.join(phases)}) finished in "
              f"{time.perf_counter() - t_start:.1f} s; no final line",
              file=sys.stderr)
        return 4
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    say(state["nvidia_smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
