#!/usr/bin/env python3
"""Phase profile of a cluster-design kernel on one NVIDIA GPU.

    python3 stage_profile.py              # kernel 1, K=10, batch 6144
    python3 stage_profile.py --k 4 --batch 512
    python3 stage_profile.py --kernel ipm_pipe   # #8, the strict tier 0 call
    python3 stage_profile.py --kernel ipm_solve  # #11, the fused polish

Builds the kernel's source with its profile macro (the kernel then adds, in
thread 0 of its first block, the clock64 cycles of each phase to a device
counter), runs it through its public wrapper and prints one JSON line: the
cycles of one scenario by phase, the kernel's time with the counters in
(CUDA events), and the card's name, power limit and SM clock.

* ``admm_stage`` (kernel 1, ``-DADMM_STAGE_PROFILE``): on the headline's
  stage inputs; the per-iteration phases as a mean over the iterations, the
  time at 0, 1 and the config's iterations, so that set-up and iterations
  part.
* ``ipm_pipe`` (#8, ``-DIPM_PIPE_PROFILE``): on the call tier 0 of the
  strict router makes at this batch (upd_mode snap, eval_mode snap),
  recorded from one strict pass on seed 0; two blocks are profiled, rank 0
  of the first scenario (the first wave) and of the middle one (the steady
  state), and besides the phases, the cycle at which G^T's share has landed
  (the first three phases).
* ``ipm_solve`` (#11, ``-DIPM_SOLVE_PROFILE``): on the call the fused polish
  makes at this batch (``IPMConfig(n_iters=10, sigma_min=0.3,
  corrector=False, fused=True)``, seed 0), the same two blocks; the phases
  summed over the polish's steps, and by part, a step on average: the
  evaluation (with the right-hand side and the snap's lane weights), the
  band's exchange, the factor (both blocks' sweeps, each block's outputs,
  Schur complement and elimination, and the middle block), the
  back-substitution, the exchange of dx and G dx, and the update.  Besides,
  with the counters compiled out, the same call timed in the cluster design
  and in the one-block body (``-DIPM_SOLVE_STREAM``, which every shape then
  takes), alternated: cluster, one-block, one-block, cluster.

Exits 2 without a CUDA device.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

PHASES = ("loads", "w_inverse", "gt_wait", "init", "gt_v", "cluster_barrier",
          "combine", "w_inverse_g", "g_x", "update", "finish")
PER_ITERATION = ("gt_v", "cluster_barrier", "combine", "w_inverse_g", "g_x",
                 "update")
# #8's marks (csrc/ipm_pipe.cu and csrc/ipm_cluster.cuh, IPM_PROF(i)): the
# counter of each phase, in the order the phases run (snap/snap).
PIPE_PHASES = (
    (15, "start_loads"), (1, "column_solve"),
    (0, "state_wait_and_start_barrier"), (2, "gt_wait"), (3, "gdx"),
    (14, "update_lanes"), (4, "update_combine_and_apply"),
    (11, "snap_lane_weights"), (12, "y_pass_and_row_block_masks"),
    (13, "lane_weights"), (5, "ball_masks_and_lane_lists"),
    (16, "jacobian_rows"), (6, "jt"), (17, "band_products_warp0"),
    (7, "band_wait_and_stores"), (8, "exchange_and_barrier"),
    (18, "jt_finals"), (19, "band_finals_warp0"), (9, "sync_and_rhs"),
    (10, "outputs"))
# #11's marks (csrc/ipm_solve.cu and csrc/ipm_cluster.cuh), each summed over
# the polish's steps, and the part of a step each belongs to.
SOLVE_PHASES = (
    (0, "loads_and_gt_wait", "start"),
    (12, "y_pass_and_row_block_masks", "evaluation"),
    (13, "lane_weights", "evaluation"),
    (5, "ball_masks_and_lane_lists", "evaluation"),
    (16, "jacobian_rows", "evaluation"), (6, "jt", "evaluation"),
    (17, "band_products_warp0", "evaluation"),
    (7, "band_wait_and_stores", "evaluation"),
    (8, "exchange_and_barrier", "evaluation"),
    (18, "jt_finals", "evaluation"),
    (19, "band_finals_to_both_blocks", "evaluation"),
    (20, "band_exchange_barrier", "band_exchange"),
    (21, "rhs", "evaluation"),
    (29, "factor_outputs_then_schur_and_right_hand_side", "factor"),
    (30, "factor_elimination", "factor"),
    (22, "factor_middle_block_outputs", "factor"),
    (23, "back_substitution", "solve"), (24, "exchange_and_gdx", "gdx"),
    (25, "newton_update", "update"), (14, "snap_update_lanes", "update"),
    (27, "snap_update_combine_and_apply", "update"),
    (26, "state_out_and_snap_lane_weights", "evaluation"),
    (28, "outputs", "outputs"))


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel",
                        choices=("admm_stage", "ipm_pipe", "ipm_solve"),
                        default="admm_stage")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--batch", type=int, default=6144)
    parser.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
    if opts.kernel == "ipm_pipe":
        return pipe_profile(opts)
    if opts.kernel == "ipm_solve":
        return solve_profile(opts)
    import chip_smoke
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libadmm_stage_profile.so")
    cmd = ([_build.find_nvcc()] + _build.NVCC_FLAGS
           + ["-DADMM_STAGE_PROFILE", "-o", so,
              os.path.join(_build.CSRC_DIR, "admm_stage.cu")])
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    # The wrapper declares its signatures on whatever library the name holds.
    _build._LIBS["admm_stage"] = lib
    lib.admm_stage_profile_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 16)()

    cfg = chip_smoke.bench_config(mtt)
    args, kw = chip_smoke.stage_inputs(mtt, opts.k, opts.batch, seed=0,
                                       config=cfg)
    nfd, m_p = args[4].shape[1:]
    design = admm_kernel.factored_design(nfd, m_p, args[1].shape[1],
                                         args[1].shape[-1], kw["nb_p"])
    if design != "cluster":
        print(f"stage_profile: this shape takes the {design} design",
              file=sys.stderr)
        return 3

    def run(n_iters):
        return admm_kernel.admm_stage_fused_factored(
            *args, init_z=True, **dict(kw, n_iters=n_iters))

    ms = {n: chip_smoke.cuda_ms(lambda: run(n), reps=opts.reps)
          for n in sorted({0, 1, kw["n_iters"]})}
    lib.admm_stage_profile_clear()
    for _ in range(opts.reps):
        run(kw["n_iters"])
    torch.cuda.synchronize()
    lib.admm_stage_profile_read(ctypes.addressof(counts))
    cycles = {}
    for i, name in enumerate(PHASES):
        c = counts[i] / opts.reps
        cycles[name] = c / kw["n_iters"] if name in PER_ITERATION else c
    print(json.dumps(dict(
        kernel="admm_stage_fused_factored", k=opts.k, batch=opts.batch,
        nfd=nfd, m_p=m_p, n_iters=kw["n_iters"],
        design=design, cycles_one_scenario=sum(counts[i] for i in range(11))
        / opts.reps, cycles_by_phase=cycles,
        per_iteration_phases=list(PER_ITERATION),
        ms_with_counters_by_n_iters=ms, nvidia_smi=smi())))
    return 0


def pipe_profile(opts):
    """#8's phase profile on tier 0's recorded call (see the top)."""
    import torch
    import chip_smoke
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel

    sc = mtt.make_inputs(opts.k, opts.batch, seed=0)
    calls = []
    with chip_smoke.recorded(ipm_kernel, "ipm_pipe_step", calls):
        chip_smoke.strict_call(mtt, sc)
    args, kw, _ = next(c for c in calls if c[1]["upd_mode"] == "snap"
                       and c[1]["eval_mode"] == "snap")
    del calls
    nfd, m_p = args[0].shape[1:]
    design = chip_smoke.ipm_design_of(ipm_kernel, "ipm_pipe_step", args, kw)
    if design != "cluster":
        print(f"stage_profile: this shape takes the {design} design",
              file=sys.stderr)
        return 3
    ms_plain_build = chip_smoke.cuda_ms(
        lambda: ipm_kernel.ipm_pipe_step(*args, **kw), reps=opts.reps)
    lib = _build.variant("ipm_pipe", ("IPM_PIPE_PROFILE",))
    _build._LIBS["ipm_pipe"] = lib        # the wrapper declares its types
    lib.ipm_pipe_profile_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 64)()
    ms = chip_smoke.cuda_ms(lambda: ipm_kernel.ipm_pipe_step(*args, **kw),
                            reps=opts.reps)
    lib.ipm_pipe_profile_clear()
    for _ in range(opts.reps):
        ipm_kernel.ipm_pipe_step(*args, **kw)
    torch.cuda.synchronize()
    lib.ipm_pipe_profile_read(ctypes.addressof(counts))
    by_block = {}
    for slot, label in enumerate(("first_wave", "middle_scenario")):
        cycles = {name: counts[32 * slot + i] / opts.reps
                  for i, name in PIPE_PHASES}
        by_block[label] = dict(
            cycles_one_scenario=sum(cycles.values()), cycles_by_phase=cycles,
            gt_landed_cycles_after_entry=sum(
                cycles[name] for _, name in PIPE_PHASES[:4]))
    print(json.dumps(dict(
        kernel="ipm_pipe_step", k=opts.k, batch=opts.batch, nfd=nfd,
        m_p=m_p, upd_mode=kw["upd_mode"], eval_mode=kw["eval_mode"],
        design=design, profiled_blocks=by_block,
        profiled_blocks_are="rank 0 of scenario 0 (the first wave) and of "
        "scenario batch // 2 (a wave in the steady state)",
        ms_with_counters=ms, ms_without_counters=ms_plain_build,
        nvidia_smi=smi())))
    return 0


def solve_profile(opts):
    """#11's phase profile on the fused polish's recorded call (see the
    top)."""
    import torch
    import chip_smoke
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel

    sc = mtt.make_inputs(opts.k, opts.batch, seed=0)
    calls = []
    with chip_smoke.recorded(ipm_kernel, "ipm_solve_fused", calls):
        mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=chip_smoke.bench_config(mtt),
            ipm_config=mtt.IPMConfig(n_iters=10, sigma_min=0.3,
                                     corrector=False, fused=True),
            warmstart_values=sc.values)
    args, kw, _ = calls[0]
    del calls
    nfd, m_p = args[0].shape[1:]
    design = chip_smoke.ipm_design_of(ipm_kernel, "ipm_solve_fused", args,
                                      kw)
    if design != "cluster":
        print(f"stage_profile: this shape takes the {design} design",
              file=sys.stderr)
        return 3
    run = lambda: ipm_kernel.ipm_solve_fused(*args, **kw)
    shipped = _build.load("ipm_solve")
    one_block = _build.variant("ipm_solve", ("IPM_SOLVE_STREAM",))
    by_design = {"cluster": [], "one_block": []}
    for name in ("cluster", "one_block", "one_block", "cluster"):
        _build._LIBS["ipm_solve"] = shipped if name == "cluster" else one_block
        by_design[name].append(chip_smoke.cuda_ms(run, reps=opts.reps))
    _build._LIBS["ipm_solve"] = shipped
    ms_plain_build = statistics.mean(by_design["cluster"])
    lib = _build.variant("ipm_solve", ("IPM_SOLVE_PROFILE",))
    _build._LIBS["ipm_solve"] = lib       # the wrapper declares its types
    lib.ipm_solve_profile_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 64)()
    ms = chip_smoke.cuda_ms(run, reps=opts.reps)
    lib.ipm_solve_profile_clear()
    for _ in range(opts.reps):
        ipm_kernel.ipm_solve_fused(*args, **kw)
    torch.cuda.synchronize()
    lib.ipm_solve_profile_read(ctypes.addressof(counts))
    steps = kw["n_iters"] + kw["snap_iters"]
    by_block = {}
    for slot, label in enumerate(("first_wave", "middle_scenario")):
        cycles = {name: counts[32 * slot + i] / opts.reps
                  for i, name, _ in SOLVE_PHASES}
        parts = {}
        for i, name, part in SOLVE_PHASES:
            parts[part] = parts.get(part, 0.0) + cycles[name]
        by_block[label] = dict(
            cycles_one_scenario=sum(cycles.values()), cycles_by_phase=cycles,
            cycles_a_step_by_part={
                p: c / steps for p, c in parts.items()
                if p not in ("start", "outputs")},
            cycles_start=parts["start"], cycles_outputs=parts["outputs"])
    print(json.dumps(dict(
        kernel="ipm_solve_fused", k=opts.k, batch=opts.batch, nfd=nfd,
        m_p=m_p, n_iters=kw["n_iters"], snap_iters=kw["snap_iters"],
        design=design, profiled_blocks=by_block,
        profiled_blocks_are="rank 0 of scenario 0 (the first wave) and of "
        "scenario batch // 2 (a wave in the steady state)",
        ms_with_counters=ms, ms_without_counters=ms_plain_build,
        ms_without_counters_by_design=by_design,
        ms_by_design_are="CUDA events, mean of --reps launches, in the order "
        "cluster, one_block, one_block, cluster",
        nvidia_smi=smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
