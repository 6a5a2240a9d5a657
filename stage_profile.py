#!/usr/bin/env python3
"""Phase profile of a cluster-design kernel on one NVIDIA GPU.

    python3 stage_profile.py              # kernel 1, K=10, batch 6144
    python3 stage_profile.py --k 4 --batch 512
    python3 stage_profile.py --kernel admm_stage_fused   # #2, route (a)
    python3 stage_profile.py --kernel admm_stage_ew      # #3, the ew route
    python3 stage_profile.py --kernel admm_stage_fused --k 2 --designs
    python3 stage_profile.py --kernel ipm_pipe   # #8, the strict tier 0 call
    python3 stage_profile.py --kernel ipm_solve  # #11, the fused polish
    python3 stage_profile.py --kernel gram_band_factors  # #5, "pallas_db"
    python3 stage_profile.py --kernel gram_band --designs  # #6, "pallas"
    python3 stage_profile.py --paths --root _parent   # paths, another tree

Builds the kernel's source with its profile macro (the kernel then adds, in
thread 0 of its first block, the clock64 cycles of each phase to a device
counter), runs it through its public wrapper and prints one JSON line: the
cycles of one scenario by phase, the kernel's time with the counters in
(CUDA events), and the card's name, power limit and SM clock.

* ``admm_stage`` (kernel 1, ``-DADMM_STAGE_PROFILE``): on the headline's
  stage inputs; the per-iteration phases as a mean over the iterations, the
  time at 0, 1 and the config's iterations, so that set-up and iterations
  part.  ``admm_stage_fused`` (#2) and ``admm_stage_ew`` (#3) run the same
  cluster body, so the same marks: #2 on the stage inputs of the dense
  route (a) (``kkt_apply="inverse"``; W^-1 is given, so its ``w_inverse``
  phase is empty), #3 on those of the ``gt_assembly="kernel"`` route.
  With ``--designs`` no profile: the call timed in the cluster design at
  the block size its launcher takes (512 threads an SM over as many blocks
  as the shared memory holds) and at each of 512, 256, 128 and 64 threads
  (``-DADMM_STAGE_CLUSTER_THREADS=n``, which every shape then takes), each
  one's outputs against the launcher's bits, and in the stream design
  (``-DADMM_STAGE_STREAM``, which every shape then takes), alternated:
  stream, the launcher's, 512 .. 64, 64 .. 512, the launcher's, stream.
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
* ``gram_band_factors`` (#5) and ``gram_band`` (#6),
  ``-DGRAM_BAND_PROFILE``: on the call the band route makes at this batch
  (``band_gram="pallas_db"``: #5 once a stage; ``"pallas"``: #6 once a
  solve), recorded from one solve on seed 0; the cycles a scenario (the
  mean over the scenarios block 0 walks) of thread 0, a computing thread,
  by phase of the ring: start (the mbarriers and the first copies),
  slab_wait (waiting on a slab's mbarrier, with the loads of the KKT
  band's objective part), products, combine (the warps' groups and the
  partials' barrier) and epilogue (the warps' sum, the stores and the
  barrier), and of its producer issuing the copies; the time with the
  counters in and out.  With ``--designs`` no
  profile: the call timed in the design the launcher takes
  (``band_design``) and in each variant of it (slots, scenarios a block,
  tile shape, threads, and the window body), each one's outputs against
  the launcher's bits, alternated: the list, then the list backwards.
* ``--paths`` (no profile, no kernel build of its own): the paths the stage
  and band kernels sit on, through the public entry points of the package found
  under ``--root`` (default: this checkout; an unpacked copy of another
  commit times that commit's package, so that one machine alternates two
  trees process by process): the headline (K=10), the dense route (a)
  (K=10, ``kkt_apply="inverse"``), the dense route (c) (K=2), the band
  routes "pallas_db" (#5) and "pallas" (#6) at K=10 and the strict
  router with its defaults, seed 0, each ``--reps`` passes after a warm-up,
  by CUDA events and on the host's clock; and the host time of one call of
  each stage wrapper those paths make (kernel 1 on the headline, #2 on
  route (c)), the mean of 20 calls queued with no synchronisation between
  them, so that the card's time is not in it.

Exits 2 without a CUDA device.
"""

import argparse
import ctypes
import dataclasses
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
                        choices=("admm_stage", "admm_stage_fused",
                                 "admm_stage_ew", "ipm_pipe", "ipm_solve",
                                 "gram_band", "gram_band_factors"),
                        default="admm_stage")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--batch", type=int, default=6144)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--designs", action="store_true",
                        help="time the stage entry point's cluster design "
                        "at each block size and its stream design (the "
                        "band kernels: each variant of the ring, and the "
                        "window body) instead of profiling it")
    parser.add_argument("--paths", action="store_true",
                        help="time the paths the stage kernels sit on and "
                        "their wrappers' host time instead (see the top)")
    parser.add_argument("--root", default=None,
                        help="with --paths: the tree whose package is "
                        "timed (default: this checkout)")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
    if opts.paths:
        return paths_timing(opts)
    if opts.kernel == "ipm_pipe":
        return pipe_profile(opts)
    if opts.kernel == "ipm_solve":
        return solve_profile(opts)
    if opts.kernel.startswith("gram_band"):
        return band_profile(opts)
    import chip_smoke
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel

    cfg = chip_smoke.bench_config(mtt)
    if opts.kernel == "admm_stage_fused":
        kind = "admm_stage_fused"
        inp = chip_smoke.route_inputs(mtt, opts.k, opts.batch, seed=0,
                                      config=cfg)
        args, kw = inp["fused"], inp["kw"]
        del inp
        nfd, m_p = args[2].shape[1:]
        m_blk = bsz = 0
    elif opts.kernel == "admm_stage_ew":
        kind = "admm_stage_fused_factored_ew"
        inp = chip_smoke.ew_inputs(mtt, opts.k, opts.batch, seed=0,
                                   config=cfg)
        args, kw = inp["stage"] + (inp["x0"],), inp["kw"]
        del inp
        nfd, m_p = 3 * args[4].shape[1], args[4].shape[2]
        m_blk, bsz = args[1].shape[1], args[1].shape[-1]
    else:
        kind = "admm_stage_fused_factored"
        args, kw = chip_smoke.stage_inputs(mtt, opts.k, opts.batch, seed=0,
                                           config=cfg)
        nfd, m_p = args[4].shape[1:]
        m_blk, bsz = args[1].shape[1], args[1].shape[-1]
    design = admm_kernel.stage_design(kind, nfd, m_p, m_blk, bsz, kw["nb_p"])
    if design != "cluster":
        print(f"stage_profile: this shape takes the {design} design",
              file=sys.stderr)
        return 3
    wrapper = getattr(admm_kernel, kind)

    def run(n_iters):
        return wrapper(*args, init_z=True, **dict(kw, n_iters=n_iters))

    if opts.designs:
        return designs_timing(opts, kind, lambda: run(kw["n_iters"]),
                              (nfd, m_p, m_blk, bsz, kw["nb_p"]))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libadmm_stage_profile.so")
    cmd = ([_build.find_nvcc()] + _build.NVCC_FLAGS
           + ["-DADMM_STAGE_PROFILE", "-o", so,
              os.path.join(_build.CSRC_DIR, "admm_stage.cu")])
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    # The wrapper declares its signatures on whatever library the name
    # holds; the design it took is asked of that library again.
    _build._LIBS["admm_stage"] = lib
    admm_kernel._designs.clear()
    lib.admm_stage_profile_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 16)()

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
        kernel=kind, k=opts.k, batch=opts.batch,
        nfd=nfd, m_p=m_p, n_iters=kw["n_iters"],
        design=design, cycles_one_scenario=sum(counts[i] for i in range(11))
        / opts.reps, cycles_by_phase=cycles,
        per_iteration_phases=list(PER_ITERATION),
        ms_with_counters_by_n_iters=ms, nvidia_smi=smi())))
    return 0


BLOCK_THREADS = (512, 256, 128, 64)
# The host-time measure of --paths: calls queued without synchronising.
HOST_CALLS = 20


def paths_timing(opts):
    """The --paths report (see the top)."""
    import time
    import torch
    root = os.path.abspath(opts.root or os.path.dirname(__file__))
    sys.path.insert(0, root)
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    if not os.path.dirname(mtt.__file__).startswith(root):
        raise RuntimeError(f"stage_profile: the package came from "
                           f"{mtt.__file__}, not from {root}")
    build_s = _build.prebuild()
    config = mtt.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                            rho_tube_factor=0.125, rho_half_factor=0.125)
    inputs = {k: mtt.make_inputs(k, opts.batch, seed=0) for k in (2, 10)}

    def batch_solve(k, **over):
        sc, cfg = inputs[k], dataclasses.replace(config, **over)
        return lambda: mtt.solve_qcqp_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            config=cfg, warmstart_values=sc.values)

    sc10 = inputs[10]
    paths = {
        "headline_k10": batch_solve(10),
        "dense_route_a_k10": batch_solve(10, kkt_apply="inverse"),
        "dense_route_c_k2": batch_solve(2),
        "band_pallas_db_k10": batch_solve(10, band_gram="pallas_db"),
        "band_pallas_k10": batch_solve(10, band_gram="pallas"),
        "strict_k10": lambda: mtt.solve_qcqp_strict(
            sc10.free, sc10.d_fixed_free, sc10.times, sc10.waypoints,
            sc10.radii, warmstart_values=sc10.values)}
    # one call of each stage wrapper as its path makes it
    calls = {}
    for name, path in (("admm_stage_fused_factored", "headline_k10"),
                       ("admm_stage_fused", "dense_route_c_k2")):
        wrapper = getattr(admm_kernel, name)

        def record(*a, _name=name, _wrapper=wrapper, **kw):
            calls.setdefault(_name, (a, kw))
            return _wrapper(*a, **kw)
        setattr(admm_kernel, name, record)
        try:
            paths[path]()
        finally:
            setattr(admm_kernel, name, wrapper)
    torch.cuda.synchronize()
    out = dict(root=root, batch=opts.batch, reps=opts.reps,
               build_seconds=build_s)
    for name, run in paths.items():
        run()                                             # warm-up
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(opts.reps + 1)]
        wall = []
        marks[0].record()
        for i in range(opts.reps):
            t0 = time.perf_counter()
            run()
            marks[i + 1].record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(
            ms=[marks[i].elapsed_time(marks[i + 1])
                for i in range(opts.reps)], wall_ms=wall)
    host = {}
    for name, (a, kw) in calls.items():
        fn = getattr(admm_kernel, name)
        fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn(*a, **kw)
        host[name] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
        torch.cuda.synchronize()
    out.update(wrapper_host_us_a_call=host, nvidia_smi=smi())
    print(json.dumps(out))
    return 0


def designs_timing(opts, kind, run, shapes):
    """The --designs report of a stage entry point (see the top)."""
    import torch
    import chip_smoke
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel

    shipped = _build.load("admm_stage")
    builds = {t: ("admm_stage", (f"ADMM_STAGE_CLUSTER_THREADS={t}",))
              for t in BLOCK_THREADS}
    builds["stream"] = ("admm_stage", ("ADMM_STAGE_STREAM",))
    _build.prebuild(names=(), variants=builds.values())
    libs = {k: _build.variant(*v) for k, v in builds.items()}
    libs["launcher"] = shipped

    def timed(name):
        # the design is asked of the library in use
        _build._LIBS["admm_stage"] = libs[name]
        admm_kernel._designs.clear()
        try:
            ms = chip_smoke.cuda_ms(run, reps=opts.reps)
            out = run()
            torch.cuda.synchronize()
            return ms, out
        finally:
            _build._LIBS["admm_stage"] = shipped
            admm_kernel._designs.clear()

    order = (("stream", "launcher") + BLOCK_THREADS + BLOCK_THREADS[::-1]
             + ("launcher", "stream"))
    ms = {name: [] for name in libs}
    ref = timed("launcher")[1]
    same_bits = {}
    for name in order:
        t, out = timed(name)
        ms[name].append(t)
        if name != "stream":
            same_bits[name] = all(torch.equal(a, b)
                                  for a, b in zip(out, ref))
    nfd, m_p, m_blk, bsz, nb_p = shapes
    print(json.dumps(dict(
        kernel=kind, k=opts.k, batch=opts.batch, nfd=nfd, m_p=m_p,
        design=admm_kernel.stage_design(kind, *shapes),
        launcher_block_threads=admm_kernel.block_threads(*shapes, kind),
        cluster_ms_launcher=ms.pop("launcher"), stream_ms=ms.pop("stream"),
        cluster_ms_by_block_threads=ms, same_bits_as_launcher=same_bits,
        order="stream, launcher's block size, 512 .. 64 threads, 64 .. 512, "
        "launcher's, stream; CUDA events, mean of --reps launches each",
        nvidia_smi=smi())))
    return 0


# The ring's phases as csrc/gram_band.cu counts them (GRAM_BAND_PROFILE).
BAND_PHASES = ("start", "slab_wait", "products", "combine", "epilogue")
# --designs for the band kernels: each variant of the launcher's design.
BAND_VARIANTS = (("slots_2", dict(slots=2)), ("slots_4", dict(slots=4)),
                 ("per_block_1", dict(per_block=1)),
                 ("per_block_2", dict(per_block=2)),
                 ("tile_5x3", dict(tile="5x3")),
                 ("threads_96", dict(threads=96)),
                 ("threads_192", dict(threads=192)),
                 ("threads_224", dict(threads=224)),
                 ("threads_288", dict(threads=288)), ("window", None))


def band_call(opts, name):
    """(args, kwargs) of the call the band route of ``name`` makes at
    --k and --batch (seed 0), recorded from one solve."""
    import torch
    import chip_smoke
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
    mode = "pallas_db" if name == "gram_band_factors" else "pallas"
    sc = mtt.make_inputs(opts.k, opts.batch, seed=0)
    calls = []
    with chip_smoke.recorded(admm_kernel, name, calls):
        chip_smoke.solve(mtt, sc, chip_smoke.route_config(mtt,
                                                          band_gram=mode))
    torch.cuda.synchronize()
    args, kw, _ = calls[0]
    del calls
    return args, kw


def band_profile(opts):
    """#5's or #6's phase profile, or with --designs its variants' times
    (see the top)."""
    import torch
    import chip_smoke
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel

    name = opts.kernel
    args, kw = band_call(opts, name)
    bsz, nfd, m_p = args[0].shape
    launcher = admm_kernel.band_design(nfd, m_p, kw["blk"])
    wrapper = getattr(admm_kernel, name)
    run = lambda: wrapper(*args, **kw)
    shapes = dict(kernel=name, k=opts.k, batch=opts.batch, nfd=nfd, m_p=m_p,
                  blk=kw["blk"], design=launcher._asdict())
    if opts.designs:
        return band_designs_timing(opts, run, launcher, shapes)
    if launcher.design != "ring":
        print(f"stage_profile: this shape takes the {launcher.design} "
              f"design", file=sys.stderr)
        return 3
    ms_plain_build = chip_smoke.cuda_ms(run, reps=opts.reps)
    lib = _build.variant("gram_band", ("GRAM_BAND_PROFILE",))
    _build._LIBS["gram_band"] = lib       # the wrapper declares its types
    lib.gram_band_profile_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 8)()
    ms = chip_smoke.cuda_ms(run, reps=opts.reps)
    lib.gram_band_profile_clear()
    for _ in range(opts.reps):
        run()
    torch.cuda.synchronize()
    lib.gram_band_profile_read(ctypes.addressof(counts))
    scenarios = counts[5]
    cycles = {p: counts[i] / scenarios for i, p in enumerate(BAND_PHASES)}
    print(json.dumps(dict(
        **shapes, grid=admm_kernel.ring_grid(bsz, m_p, launcher),
        blocks_per_sm=admm_kernel.ring_blocks_per_sm(m_p, launcher),
        profiled_block="block 0: the mean over the scenarios it walks in "
        "--reps launches", scenarios_profiled=scenarios,
        cycles_one_scenario=sum(cycles.values()), cycles_by_phase=cycles,
        cycles_by_phase_are="thread 0 of block 0 (a computing thread)",
        block_cycles_a_scenario=counts[6] / scenarios,
        producer_issue_cycles_a_scenario=counts[7] / scenarios,
        ms_with_counters=ms, ms_without_counters=ms_plain_build,
        nvidia_smi=smi())))
    return 0


def band_designs_timing(opts, run, launcher, shapes):
    """The --designs report of a band kernel (see the top)."""
    import torch
    import chip_smoke
    from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel

    m_p, blk = shapes["m_p"], shapes["blk"]
    designs = {"launcher": launcher}
    for label, over in BAND_VARIANTS:
        if over is None:
            designs[label] = admm_kernel.window_design(m_p, blk)
            continue
        d = launcher._replace(**over)
        designs[label] = d._replace(smem_bytes=admm_kernel.ring_smem_bytes(
            m_p, d.threads, d.slots))
    chosen = admm_kernel.band_design

    def timed(label):
        admm_kernel.band_design = lambda *_: designs[label]
        try:
            ms = chip_smoke.cuda_ms(run, reps=opts.reps)
            out = run()
            torch.cuda.synchronize()
            return ms, out
        finally:
            admm_kernel.band_design = chosen

    labels = list(designs)
    ms = {label: [] for label in labels}
    ref = timed("launcher")[1]
    same_bits = {}
    for label in labels + labels[::-1]:
        t, out = timed(label)
        ms[label].append(t)
        same_bits[label] = all(torch.equal(a, b) for a, b in zip(out, ref))
    print(json.dumps(dict(
        **shapes, ms_by_design={k: v for k, v in ms.items()},
        mean_ms_by_design={k: statistics.mean(v) for k, v in ms.items()},
        same_bits_as_launcher=same_bits,
        designs={k: d._asdict() for k, d in designs.items()},
        order="the launcher's, then each variant, then back; CUDA events, "
        "mean of --reps launches each", nvidia_smi=smi())))
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
