#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases toolchain,build,kernel_check

Builds the port's CUDA kernels from ``csrc/`` with nvcc (one nvcc per
source, all started together), holds each kernel against its plain PyTorch
version on the card, then drives the port's main paths through their public
entry points and checks the solution quality: ``solve_qcqp_batch`` on the
10-segment min-snap QP+QCQP benchmark configuration, batch 6144, and the
strict verdict router ``solve_qcqp_strict`` on the same batch (and on a
tight-corridor batch of 512, where its escalation tiers do the work).
Every phase prints one JSON object on a line of its own;
a failing phase raises, so the script exits non-zero and prints no final
line.  There is no CPU mode: without a CUDA device it exits with code 2.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import json
import re
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
KERNEL_TOL = 2e-5

# Quality bars of the main path at seed 0: the JAX reference recorded
# 6110/6144 feasible at the 1e-2 gate and a median violation of 1.49e-4.
MAIN_BATCH = 6144
MIN_FEASIBLE = 6080
MAX_MEDIAN_VIOLATION = 3e-4
OUT_NAMES = ("x", "z", "z_prev", "u", "prim", "dual", "y")
ALL_PHASES = ("toolchain", "build", "kernel_check", "main_path",
              "multi_stage", "ipm_kernel_check", "strict_path",
              "strict_tight", "kernels")

# The interior-point kernels against their plain versions, per output, on
# inputs recorded from real solves.  Rows are judged one scenario at a time
# because the step kernel takes discrete decisions on float comparisons (the
# seven-point line search, "merit < best", the update gate): where two
# float32 evaluations of the same sums fall on different sides of a
# comparison the whole row differs by a step, which no tolerance on values
# covers.  For each output, with scale = max |plain float64 output|:
#  1. kernel vs plain float32: at most IPM_ROW_TOL * scale in every row
#     but a few: the rows outside may number at most IPM_FLIP_ROWS of the
#     batch plus twice the rows where plain float32 vs plain float64 is
#     itself outside (those are the rows that sit on a comparison);
#  2. over the rows inside, kernel vs plain float64 is at most 3x plain
#     float32 vs plain float64 plus 1e-6 * scale.
# The weighted-Gram weights span 12 decades (w up to w_cap = 1e6 beside
# 1e-6), so sums lose up to ~1e-4 of the output's scale to cancellation in
# any float32 order.
IPM_ROW_TOL = 2e-4
IPM_FLIP_ROWS = 0.01
PIPE_OUT = ("x", "s", "lam", "y", "bx", "by", "bm", "max_lam", "hd", "hu",
            "rhs")
EVAL_OUT = ("y", "c", "jtwr2", "jts", "hd", "hu")

# Quality bars of the strict path at seed 0, batch 6144: the JAX reference
# recorded 6144/6144 under the 1e-4 gate with its float64 last tier; this
# path runs without that tier, so 99.5 % is asked.
MIN_STRICT = 6113
STRICT_GATE = 1e-4
IPM_SOURCES = ("gt_matvec", "ipm_eval", "ipm_pipe")
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


def stage_inputs(mtt, k, batch, seed, config):
    """Stage-kernel inputs exactly as the main path builds them."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.solver import banded, qcqp
    sc = mtt.make_inputs(k, batch, seed=seed)
    layout = qcqp._flagship_layout(sc.free)
    pre = qcqp._pre(sc.free, sc.d_fixed_free, sc.times, sc.waypoints,
                    sc.radii, config, None, layout,
                    warmstart_positions=sc.values[:, 1:-1, 0, :])
    blk = banded.kkt_tridiag_block(sc.free)
    band = qcqp._kkt_band(pre.gt, pre.p_eq, blk)
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


def compare_outputs(ours, plain, plain64):
    """Per-output max abs differences (kernel vs plain float32, kernel vs
    plain float64, plain float32 vs plain float64) and whether both criteria
    stated at KERNEL_TOL hold."""
    import torch
    diffs, diffs64, floor64, ok = {}, {}, {}, True
    scale = max(1.0, float(plain[0].abs().max()))
    for name, a, b, c in zip(OUT_NAMES, ours, plain, plain64):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"kernel output {name}: bad shape or "
                               f"non-finite values")
        diffs[name] = float((a - b).abs().max())
        diffs64[name] = float((a.double() - c).abs().max())
        floor64[name] = float((b.double() - c).abs().max())
        ok = (ok and diffs[name] <= KERNEL_TOL * scale
              and diffs64[name] <= 3.0 * floor64[name] + 1e-6 * scale)
    return dict(kernel_vs_plain=diffs, kernel_vs_plain_f64=diffs64,
                plain_vs_plain_f64=floor64, scale=scale), ok


def run_three(admm_kernel, args, kw, extra=(), init_z=True):
    """(kernel, plain float32, plain float64) outputs on the same inputs."""
    import torch
    ours = admm_kernel.admm_stage_fused_factored(*args, *extra,
                                                 init_z=init_z, **kw)
    torch.cuda.synchronize()
    plain = admm_kernel.admm_stage_fused_factored_plain(
        *args, *extra, init_z=init_z, **kw)
    plain64 = admm_kernel.admm_stage_fused_factored_plain(
        *(a.double() for a in args), *(a.double() for a in extra),
        init_z=init_z, **kw)
    return ours, plain, plain64


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


def phase_build(state):
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    t0 = time.perf_counter()
    wall = _build.prebuild(("admm_stage",) + IPM_SOURCES)
    smem = admm_kernel.smem_bytes(135, 512, 9, 15, 128)
    seconds = time.perf_counter() - t0
    emit("build_ipm", parallel_wall_seconds=round(wall, 3),
         libraries=[build_report(_build, n) for n in IPM_SOURCES],
         dynamic_smem_bytes_flagship={
             n: ipm_kernel.smem_bytes(n, 135, 512, 15, 128)
             for n in ("ipm_eval", "ipm_pipe")},
         threads_per_block=ipm_kernel.THREADS)
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


def phase_kernel_check(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    results = []
    for label, k, batch in (("flagship K=10", 10, 256), ("K=4", 4, 64)):
        cfg = bench_config(mtt)
        args, kw = stage_inputs(mtt, k, batch, seed=1, config=cfg)
        ours, plain, plain64 = run_three(admm_kernel, args, kw)
        again = admm_kernel.admm_stage_fused_factored(*args, init_z=True,
                                                      **kw)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(ours, again))
        d1, ok1 = compare_outputs(ours, plain, plain64)
        # second stage: z/u carried in (u rescaled as the rho rebalancing
        # does), the kernel entered with init_z=False
        x1, z1, _, u1 = plain[:4]
        args2 = args[:8] + (x1.contiguous(),)
        extra = (z1.contiguous(), (u1 * 0.5).contiguous())
        ours2, plain2, plain2_64 = run_three(admm_kernel, args2, kw, extra,
                                             init_z=False)
        d2, ok2 = compare_outputs(ours2, plain2, plain2_64)
        results.append(dict(shapes=label, batch=batch,
                            gt_shape=list(args[4].shape),
                            n_iters=kw["n_iters"], init_z=d1, carried=d2,
                            bit_identical=identical,
                            within_tolerance=ok1 and ok2))
    emit("kernel_check", kernel="admm_stage_fused_factored",
         tolerance=KERNEL_TOL, tolerance_is="kernel vs plain f32 <= "
         "tolerance * max(1, max|x|) per output, and kernel vs plain f64 <= "
         "3 * (plain f32 vs plain f64) + 1e-6 * max(1, max|x|)",
         cases=results)
    bad = [r["shapes"] for r in results
           if not (r["within_tolerance"] and r["bit_identical"])]
    if bad:
        raise RuntimeError(f"kernel_check failed for {bad}")


@contextlib.contextmanager
def plain_stage():
    """Route the solver's stage calls to the plain PyTorch version (used
    only to compare; the port itself never does this)."""
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    kernel_fn = admm_kernel.admm_stage_fused_factored
    admm_kernel.admm_stage_fused_factored = \
        admm_kernel.admm_stage_fused_factored_plain
    try:
        yield
    finally:
        admm_kernel.admm_stage_fused_factored = kernel_fn


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


def compare_paths(mtt, sc, cfg, n):
    """Solve the first ``n`` scenarios through the kernel, through the plain
    float32 stage and through the plain float64 stage; returns the error
    summary and whether the kernel path is within the stated bounds."""
    kern = solve(mtt, sc, cfg, n)
    with plain_stage():
        p32 = solve(mtt, sc, cfg, n)
        sc64 = sc._replace(**{f: getattr(sc, f).double() for f in (
            "d_fixed_std", "d_fixed_free", "times", "waypoints", "radii",
            "values")})
        p64 = solve(mtt, sc64, cfg, n)

    def errs(a, b):
        cost = (a.cost.double() - b.cost).abs() / b.cost.abs()
        viol = (a.max_violation.double() - b.max_violation).abs()
        return dict(cost=float(cost.max()), violation=float(viol.max()),
                    median_cost=float(cost.median()),
                    median_violation=float(viol.median()))

    out = dict(
        n=n,
        max_rel_cost_diff=float(((kern.cost - p32.cost).abs()
                                 / p32.cost.abs()).max()),
        max_abs_violation_diff=float((kern.max_violation
                                      - p32.max_violation).abs().max()),
        kernel_vs_f64=errs(kern, p64), plain_f32_vs_f64=errs(p32, p64))
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
    solve(mtt, sc, cfg)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    admm_kernel.launches = 0
    before = admm_kernel.launches
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
    after = admm_kernel.launches
    state["launches"] = after - before
    peak = torch.cuda.max_memory_allocated()

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
    parts["gram_and_band_ms"] = cuda_ms(
        lambda: qcqp._kkt_band(pre.gt, pre.p_eq, blk), 3)
    band = qcqp._kkt_band(pre.gt, pre.p_eq, blk)
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
         peak_device_memory_bytes=peak, launches_before=before,
         launches_after=after, launches_per_pass=(after - before) / n_pass,
         plain_prefix=prefix,
         phase_ms=parts, nvidia_smi=state.get("nvidia_smi"))
    if not shapes_ok:
        raise RuntimeError("main_path: unexpected output shapes")
    if after - before != cfg.n_stages * n_pass:
        raise RuntimeError(f"main_path: {after - before} kernel launches in "
                           f"{n_pass} passes, expected {cfg.n_stages} each")
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
    before = admm_kernel.launches
    kern, cmp, ok = compare_paths(mtt, sc, cfg, None)
    torch.cuda.synchronize()
    launched = admm_kernel.launches - before
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


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper of the port to its plain PyTorch version
    (used only to compare; the port itself never does this)."""
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    names = ("gt_matvec", "ipm_eval_step", "ipm_pipe_step")
    kept = {n: getattr(ipm_kernel, n) for n in names}
    for n in names:
        setattr(ipm_kernel, n, getattr(ipm_kernel, n + "_plain"))
    try:
        with plain_stage():
            yield
    finally:
        for n in names:
            setattr(ipm_kernel, n, kept[n])


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


def compare_ipm(names, ours, plain, plain64):
    """The two criteria stated at IPM_ROW_TOL for every output; returns the
    summary and whether they hold."""
    import torch
    bsz = ours[0].shape[0]
    summary, ok = {}, True
    for name, a, b, c in zip(names, ours, plain, plain64):
        fin = torch.isfinite(c)
        scale = max(1e-30, float(c[fin].abs().max()) if fin.any() else 0.0)
        e_kp = row_errors(a, b)
        e_k64 = row_errors(a, c)
        e_p64 = row_errors(b, c)
        tol = IPM_ROW_TOL * scale
        out_k = e_kp > tol
        out_p = e_p64 > tol
        allowed = int(IPM_FLIP_ROWS * bsz) + 2 * int(out_p.sum()) + \
            (1 if bsz >= 64 else 0)
        inside = ~out_k & ~out_p
        worst_k = float(e_k64[inside].max()) if inside.any() else 0.0
        worst_p = float(e_p64[inside].max()) if inside.any() else 0.0
        good = (int(out_k.sum()) <= allowed
                and worst_k <= 3.0 * worst_p + 1e-6 * scale
                and a.shape == b.shape)
        ok = ok and good
        summary[name] = dict(
            scale=scale, rows_outside=int(out_k.sum()),
            rows_outside_plain_f32_vs_f64=int(out_p.sum()),
            kernel_vs_plain=float(e_kp[~out_k].max()) if (~out_k).any()
            else None,
            kernel_vs_plain_f64=worst_k, plain_vs_plain_f64=worst_p, ok=good)
    return summary, ok


def to64(x):
    import torch
    return x.double() if isinstance(x, torch.Tensor) else x


def check_call(fn, fn_plain, names, args, kwargs, ours=None):
    """Kernel, plain float32 and plain float64 on the same inputs; the kernel
    twice for bit identity."""
    import torch
    first = as_tuple(fn(*args, **kwargs)) if ours is None else as_tuple(ours)
    again = as_tuple(fn(*args, **kwargs))
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        for a, b in zip(first, again))
    plain = as_tuple(fn_plain(*args, **kwargs))
    plain64 = as_tuple(fn_plain(*(to64(a) for a in args), **kwargs))
    summary, ok = compare_ipm(names, first, plain, plain64)
    scaled = {n: (v["kernel_vs_plain"] or 0.0) / v["scale"]
              for n, v in summary.items()}
    worst = max(scaled, key=scaled.get)
    res = dict(bit_identical=identical, within_tolerance=ok,
               worst_output=worst, worst_scaled_err=scaled[worst],
               worst_scaled_err_vs_plain_f64=max(
                   v["kernel_vs_plain_f64"] / v["scale"]
                   for v in summary.values()),
               plain_f32_scaled_err_vs_plain_f64=max(
                   v["plain_vs_plain_f64"] / v["scale"]
                   for v in summary.values()),
               rows_outside=max(v["rows_outside"] for v in summary.values()),
               rows_outside_plain_f32_vs_f64=max(
                   v["rows_outside_plain_f32_vs_f64"]
                   for v in summary.values()))
    if not ok:
        res["outputs"] = summary
    return res, ok and identical


def record_lanes(mtt, k, batch, seed):
    """Calls of the three interior-point kernels recorded from real solves:
    an ADMM tier-0 solve, then pipelined polishes that reach all seven mode
    pairs and a scan polish (eval with phr off and on, matvec)."""
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    sc = mtt.make_inputs(k, batch, seed=seed)
    pipe_calls, eval_calls, mv_calls = [], [], []

    def polish(**cfg):
        return mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=bench_config(mtt),
            ipm_config=mtt.IPMConfig(sigma_min=0.3, corrector=False, **cfg),
            warmstart_values=sc.values)

    with recorded(ipm_kernel, "ipm_pipe_step", pipe_calls):
        polish(n_iters=0, snap_iters=2, pipelined=True)
        polish(n_iters=3, snap_iters=1, pipelined=True)
        polish(n_iters=2, snap_iters=0, pipelined=True)
    with recorded(ipm_kernel, "ipm_eval_step", eval_calls), \
            recorded(ipm_kernel, "gt_matvec", mv_calls):
        polish(n_iters=2, snap_iters=1)
    pairs = {}
    for call in pipe_calls:
        key = (call[1]["upd_mode"], call[1]["eval_mode"])
        # keep the LAST call of a pair: the state is furthest from the start
        pairs[key] = call
    return pairs, eval_calls, mv_calls


def phase_ipm_kernel_check(state, mtt):
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    cases, bad = [], []
    for label, k, batch in (("flagship K=10", 10, 256), ("K=4", 4, 64)):
        pairs, eval_calls, mv_calls = record_lanes(mtt, k, batch, seed=1)
        if len(pairs) != 7:
            raise RuntimeError(f"ipm_kernel_check: reached mode pairs "
                               f"{sorted(pairs)}, expected all seven")
        gt_shape = list(eval_calls[0][0][0].shape)
        for (upd, ev), (args, kw, out) in sorted(pairs.items()):
            res, ok = check_call(ipm_kernel.ipm_pipe_step,
                                 ipm_kernel.ipm_pipe_step_plain, PIPE_OUT,
                                 args, kw, ours=out)
            cases.append(dict(kernel="ipm_pipe_step", shapes=label,
                              gt_shape=gt_shape, upd_mode=upd, eval_mode=ev,
                              **res))
            if not ok:
                bad.append(f"pipe {label} {upd}/{ev}")
        seen = set()
        for args, kw, out in eval_calls:
            if kw["phr"] in seen:
                continue
            seen.add(kw["phr"])
            res, ok = check_call(ipm_kernel.ipm_eval_step,
                                 ipm_kernel.ipm_eval_step_plain, EVAL_OUT,
                                 args, kw, ours=out)
            cases.append(dict(kernel="ipm_eval_step", shapes=label,
                              gt_shape=gt_shape, phr=kw["phr"], **res))
            if not ok:
                bad.append(f"eval {label} phr={kw['phr']}")
        args, kw, out = mv_calls[-1]
        res, ok = check_call(ipm_kernel.gt_matvec,
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
        del pairs, eval_calls, mv_calls
    emit("ipm_kernel_check", row_tolerance=IPM_ROW_TOL,
         flip_rows=IPM_FLIP_ROWS, tolerance_is="per output and scenario: "
         "kernel vs plain f32 <= row_tolerance * max|plain f64 output| in "
         "all rows but flip_rows of the batch + 2x the rows where plain f32 "
         "vs plain f64 is outside (+1 from 64 rows on); over the rows "
         "inside, kernel vs plain f64 <= 3 * (plain f32 vs plain f64) + "
         "1e-6 * scale; two kernel runs bit-identical", cases=cases)
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


def strict_call(mtt, sc, radii=None, n=None, **kw):
    sl = slice(None) if n is None else slice(0, n)
    radii = sc.radii if radii is None else radii
    return mtt.solve_qcqp_strict(
        sc.free, sc.d_fixed_free[sl], sc.times[sl], sc.waypoints[sl],
        radii[sl], warmstart_values=sc.values[sl], tier2_f64=False, **kw)


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
    return dict(admm_stage_fused_factored=admm_kernel.launches,
                **ipm_kernel.launches)


def reset_launches():
    from mav_tube_trajectory_generation_tpu_torch.ops import (admm_kernel,
                                                              ipm_kernel)
    admm_kernel.launches = 0
    for name in ipm_kernel.launches:
        ipm_kernel.launches[name] = 0


def phase_strict_path(state, mtt):
    import numpy as np
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    from mav_tube_trajectory_generation_tpu_torch.solver import ipm_lanes
    k, batch, n_pass = 10, MAIN_BATCH, 5
    sc = mtt.make_inputs(k, batch, seed=0)

    # Warm-up; it also records one call of each interior-point kernel at the
    # shapes this path gives it, for the `kernels` phase.
    pipe_calls, eval_calls, mv_calls = [], [], []
    with recorded(ipm_kernel, "ipm_pipe_step", pipe_calls), \
            recorded(ipm_kernel, "ipm_eval_step", eval_calls), \
            recorded(ipm_kernel, "gt_matvec", mv_calls):
        strict_call(mtt, sc)
    torch.cuda.synchronize()
    state["recorded"] = dict(
        ipm_pipe_step=next(c for c in pipe_calls
                           if c[1]["upd_mode"] == "snap"
                           and c[1]["eval_mode"] == "snap")[:2],
        ipm_eval_step=eval_calls[0][:2], gt_matvec=mv_calls[0][:2])
    del pipe_calls, eval_calls, mv_calls
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

    # One more pass with a device synchronisation around every tier, to
    # split the time (it is not one of the timed passes).
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
    try:
        t_all = time.perf_counter()
        strict_call(mtt, sc)
        torch.cuda.synchronize()
        split_total_ms = (time.perf_counter() - t_all) * 1e3
    finally:
        (ipm_lanes.solve_qcqp_polished_batch,
         ipm_lanes.solve_qcqp_ipm_lanes) = keep

    # And one pass under the profiler: time the device spends in kernels,
    # against the pass time measured above without the profiler.
    busy = device_time_of(lambda: strict_call(mtt, sc))
    if busy is not None:
        busy["busy_share_of_mean_pass"] = busy["device_ms"] / ms

    # The same call on a 512-row prefix through the plain versions.
    n_pre = 512
    kern = strict_call(mtt, sc, n=n_pre)
    with plain_kernels():
        plain = strict_call(mtt, sc, n=n_pre)
    agree = int((kern.verdict == plain.verdict).sum())
    plain_summary = strict_summary(mtt, plain, n_pre)

    emit("strict_path", config="K=10 N=10 D=3 strict router, radii 0.8, "
         "tier 0 ADMM 48 it + 2 snap sweeps, tier 1 it6 + 2 snaps with a "
         "128-row speculative restart, tier 1.5 restart chain, "
         "tier2_f64=False", passes=n_pass, ms_per_batch=ms, pass_ms=pass_ms,
         best_ms=min(pass_ms), worst_ms=max(pass_ms),
         wall_ms_per_batch=wall_ms, solves_per_s=batch / (ms * 1e-3),
         min_under_gate=MIN_STRICT, **summary,
         launches_in_timed_passes=launches,
         launches_per_pass={n: v / n_pass for n, v in launches.items()},
         peak_device_memory_bytes=peak, tier_split_ms=tiers,
         tier_split_total_ms=split_total_ms,
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
    if summary["under_gate"] < MIN_STRICT:
        raise RuntimeError(f"strict_path: {summary['under_gate']}/{batch} "
                           f"under {STRICT_GATE}, need {MIN_STRICT}")
    if not summary["finite_cost"]:
        raise RuntimeError("strict_path: non-finite cost on a feasible row")
    idle = [n for n, v in launches.items() if v == 0]
    if idle:
        raise RuntimeError(f"strict_path: kernels never launched: {idle}")
    if agree < 0.97 * n_pre:
        raise RuntimeError(f"strict_path: kernel and plain routers agree on "
                           f"{agree}/{n_pre} verdicts")


def phase_strict_tight(state, mtt):
    import torch
    k, batch = 10, 512
    sc = mtt.make_inputs(k, batch, seed=0)
    radii = mtt.tight_radii(k, batch)
    reset_launches()
    t0 = time.perf_counter()
    res = strict_call(mtt, sc, radii=radii)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    summary = strict_summary(mtt, res, batch)
    emit("strict_tight", config="K=10 strict router, one radius per scenario "
         "log-uniform in [0.05, 0.3], tier2_f64=False; correctness only",
         seconds_first_call=seconds, launches=ipm_launches(), **summary)
    if summary["false_feasible"]:
        raise RuntimeError("strict_tight: a FEASIBLE verdict at a violation "
                           f">= {STRICT_GATE}")
    if not summary["finite_cost"]:
        raise RuntimeError("strict_tight: non-finite cost on a feasible row")
    if summary["n_escalated"] == 0:
        raise RuntimeError("strict_tight: nothing escalated")


def ipm_kernel_rows(state, mtt):
    """Rows of the `kernels` line for the three interior-point kernels, each
    timed on a call the strict path itself made (recorded in its warm-up)."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel
    if "recorded" not in state:
        raise RuntimeError("the kernels phase times the interior-point "
                           "kernels on calls recorded by strict_path: run "
                           "both in one call")
    rec = state["recorded"]
    launches = state["strict_launches"]
    rows = []

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))

    def finish(name, source, replaces, fn, fn_plain, names, args, kw, flops,
               library=None, note=None):
        ms = cuda_ms(lambda: fn(*args, **kw), reps=5)
        plain_ms = cuda_ms(lambda: fn_plain(*args, **kw), reps=2)
        lib_ms = cuda_ms(library, reps=5) if library else None
        res, ok = check_call(fn, fn_plain, names, args, kw)
        if not ok:
            raise RuntimeError(f"kernels: {name} disagrees with its plain "
                               f"version at the strict path's shapes: {res}")
        outs = as_tuple(fn(*args, **kw))
        total = nbytes(args) + nbytes(outs)
        bytes_ms = total / PEAK_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_F32_FLOPS * 1e3
        rows.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{source}",
            replaces=replaces, launches=launches[name],
            max_abs_err=res["worst_scaled_err"],
            max_abs_err_is="worst output, kernel vs plain float32, as a "
            "share of max|plain float64 output| over the rows inside the "
            "tolerance", rows_outside=res["rows_outside"],
            tolerance=IPM_ROW_TOL, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, flops_ms),
            bound_by="operations" if flops_ms >= bytes_ms else "bytes",
            library_ms=lib_ms, shapes=dict(gt=list(args[0].shape), note=note),
            flops=flops, bytes=total, bound_flops_ms=flops_ms,
            bound_bytes_ms=bytes_ms))

    def eval_flops(bsz, nfd, m_p, blk, n_ball):
        # band blocks over the m_p lanes and the n_ball Jacobian rows (one
        # multiply by the weight and one multiply-add per term), forming the
        # Jacobian rows, and the three matvecs y, J^T (w r2), J^T (1/s)
        m_blk = nfd // blk
        return bsz * ((2 * m_blk - 1) * 2 * blk * blk * (m_p + n_ball)
                      + 5 * nfd * n_ball + 3 * 2 * nfd * m_p)

    args, kw = rec["ipm_pipe_step"]
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
           note="tier 0, upd_mode=snap, eval_mode=snap")

    args, kw = rec["ipm_eval_step"]
    bsz, nfd, m_p = args[0].shape
    finish("ipm_eval_step", "ipm_eval.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:426",
           ipm_kernel.ipm_eval_step, ipm_kernel.ipm_eval_step_plain,
           EVAL_OUT, args, kw,
           eval_flops(bsz, nfd, m_p, kw["band_block"], kw["n_ball"]),
           note="tier 1 (the escalated rows), band output, phr=False")

    args, kw = rec["gt_matvec"]
    bsz, nfd, m_p = args[0].shape
    gt, v = args
    finish("gt_matvec", "gt_matvec.cu",
           "mav_tube_trajectory_generation_tpu/ops/ipm_kernel.py:901",
           ipm_kernel.gt_matvec, ipm_kernel.gt_matvec_plain, ("y",), args,
           kw, 2 * bsz * nfd * m_p,
           library=lambda: torch.bmm(v.transpose(1, 2), gt),
           note="tier 1 (the escalated rows); library call: torch.bmm")
    return rows


def phase_kernels(state, mtt):
    """The summary line: each kernel's time at the main path's shapes beside
    its plain version's and its bound."""
    import torch
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    cfg = bench_config(mtt)
    batch = MAIN_BATCH
    args, kw = stage_inputs(mtt, 10, batch, seed=0, config=cfg)
    kernel_ms = cuda_ms(lambda: admm_kernel.admm_stage_fused_factored(
        *args, init_z=True, **kw), reps=5)
    plain_ms = cuda_ms(lambda: admm_kernel.admm_stage_fused_factored_plain(
        *args, init_z=True, **kw), reps=2)
    ours, plain, plain64 = run_three(admm_kernel, args, kw)
    cmp, ok = compare_outputs(ours, plain, plain64)
    del plain, plain64
    if not ok:
        raise RuntimeError(f"kernels: disagreement at batch {batch}: {cmp}")
    diffs = cmp["kernel_vs_plain"]

    # Bound from this run's shapes: every input read once, every output
    # written once; (3m - 2) products of (b, b) @ (b, m_p) and
    # 2 n_iters + 2 matvecs against (nfd, m_p), 2 flops per multiply-add.
    _, nfd, m_p = args[4].shape
    m_blk, bsz = args[1].shape[1], args[1].shape[-1]
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    out_bytes = sum(a.numel() * a.element_size() for a in ours)
    flops = batch * ((3 * m_blk - 2) * 2 * bsz * bsz * m_p
                     + (2 * kw["n_iters"] + 2) * 2 * nfd * m_p)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    row = dict(
        name="admm_stage_fused_factored", route="cuda",
        source="mav_tube_trajectory_generation_tpu_torch/csrc/admm_stage.cu",
        replaces="mav_tube_trajectory_generation_tpu/ops/admm_kernel.py:604",
        launches=state["launches"],
        max_abs_err=max(diffs.values()), max_abs_diff=max(diffs.values()),
        max_abs_err_vs_plain_f64=max(cmp["kernel_vs_plain_f64"].values()),
        plain_f32_vs_plain_f64=max(cmp["plain_vs_plain_f64"].values()),
        tolerance=KERNEL_TOL * cmp["scale"],
        ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, flops_ms),
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
        library_ms=None, shapes=dict(batch=batch, nfd=nfd, m_p=m_p,
                                     m_blk=m_blk, bsz=bsz,
                                     n_iters=kw["n_iters"]),
        flops=flops, bytes=in_bytes + out_bytes,
        bound_flops_ms=flops_ms, bound_bytes_ms=bytes_ms)
    rows = [row] + ipm_kernel_rows(state, mtt)
    say(json.dumps({"kernels": rows}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of: "
                        + ", ".join(ALL_PHASES))
    parser.add_argument("--out", default=None, help="also append every "
                        "line to this file (its directory is created)")
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

    t_start = time.perf_counter()
    state = {"launches": 0}
    runners = {
        "toolchain": lambda: phase_toolchain(state),
        "build": lambda: phase_build(state),
        "kernel_check": lambda: phase_kernel_check(state, mtt),
        "main_path": lambda: phase_main_path(state, mtt),
        "multi_stage": lambda: phase_multi_stage(state, mtt),
        "ipm_kernel_check": lambda: phase_ipm_kernel_check(state, mtt),
        "strict_path": lambda: phase_strict_path(state, mtt),
        "strict_tight": lambda: phase_strict_tight(state, mtt),
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
    say(state["nvidia_smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
