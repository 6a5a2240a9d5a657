#!/usr/bin/env python3
"""Phase profile of kernel 1's cluster design on one NVIDIA GPU.

    python3 stage_profile.py              # K=10, batch 6144, 48 iterations
    python3 stage_profile.py --k 4 --batch 512

Builds ``csrc/admm_stage.cu`` with ``-DADMM_STAGE_PROFILE`` (the kernel then
adds, in thread 0 of its first block, the clock64 cycles of each phase to a
device counter), runs ``admm_stage_fused_factored`` through its public
wrapper on the headline's stage inputs, and prints one JSON line: the
cycles of one scenario by phase (the per-iteration phases as a mean over the
iterations), the kernel's time with the counters in (CUDA events; at 0, 1
and the config's iterations, so that set-up and iterations part), and the
card's name, power limit and SM clock.  Exits 2 without a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("loads", "w_inverse", "gt_wait", "init", "gt_v", "cluster_barrier",
          "combine", "w_inverse_g", "g_x", "update", "finish")
PER_ITERATION = ("gt_v", "cluster_barrier", "combine", "w_inverse_g", "g_x",
                 "update")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--batch", type=int, default=6144)
    parser.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        k=opts.k, batch=opts.batch, nfd=nfd, m_p=m_p, n_iters=kw["n_iters"],
        design=design, cycles_one_scenario=sum(counts[i] for i in range(11))
        / opts.reps, cycles_by_phase=cycles,
        per_iteration_phases=list(PER_ITERATION),
        ms_with_counters_by_n_iters=ms, nvidia_smi=smi.strip())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
