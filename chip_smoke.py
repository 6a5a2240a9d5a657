#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases toolchain,build,kernel_check

Builds the port's CUDA kernels from ``csrc/`` with nvcc, holds each kernel
against its plain PyTorch version on the card, then drives the port's main
path -- ``solve_qcqp_batch`` on the 10-segment min-snap QP+QCQP benchmark
configuration, batch 6144 -- through its public entry points and checks the
solution quality.  Every phase prints one JSON object on a line of its own;
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
              "multi_stage", "kernels")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_build(state):
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    t0 = time.perf_counter()
    smem = admm_kernel.smem_bytes(135, 512, 9, 15, 128)
    seconds = time.perf_counter() - t0
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
    print(json.dumps({"kernels": [row]}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of: "
                        + ", ".join(ALL_PHASES))
    opts = parser.parse_args()
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
    print(state["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
