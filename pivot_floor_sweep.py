#!/usr/bin/env python3
"""The pivot floor of #11's band factor swept on one NVIDIA GPU.

    python3 pivot_floor_sweep.py --out floor.jsonl
    python3 pivot_floor_sweep.py --floors 1e-4,1e-5 --parent-root _parent

#11 (``ipm_solve_fused``, ``csrc/ipm_solve.cu``) and its plain version
floor the pivots of their band factor at ``ops.ipm_kernel.PIVOT_FLOOR`` of
the equilibrated diagonal.  For each candidate floor (``--floors``: numbers,
or ``positive``, which lifts only a pivot that is not positive, to float32's
smallest normal number), the kernel built with ``-DIPM_PIVOT_FLOOR`` at that
floor and the plain version with ``PIVOT_FLOOR`` set to it, together:

* the fused path's gates (``chip_smoke.py``'s ``fused_path``): the polish at
  K=10, batch 6144, on seeds 0 and 1 against the same polish with #11's
  plain version in its place, and seed 0's against the scan polish, each
  bar read as a margin (the reading over its limit: at most 1 passes);
* the rows in which the plain factor floors a pivot, Newton steps and snap
  sweeps apart: in float32 in the plain polishes above, in float64 in seed
  0's recorded call run in float64;
* ``ipm_kernel_check``'s cases of #11 (``chip_smoke.fused_call_checks``) on
  the six polishes at the flagship (256 rows), K=4 (64) and K=12 (32), with
  the one-step controls, the one-sweep control and the build without rank
  0's band partial (gated at the flagship and K=4);
* the factor-alone check (``chip_smoke.factor_alone``) on the snap-only
  polish of 512 rows of seed 1 at K=10 and K=4: ``rows_lost_by_factor``,
  the rows where the kernel's own band solved in float64 gives a step that
  lowers phi and the kernel's float32 direction does not.

Then #11's time on seed 0's recorded call, by CUDA events (mean of
``--reps`` launches), at every candidate and, with ``--parent-root`` (an
unpacked copy of another commit), with the library built from that tree's
``csrc/ipm_solve.cu``, in turns: the list, then the list backwards.

One JSON line per candidate, one of the times, the ``nvidia-smi`` name and
power limit; ``--out`` appends them to a file too.  Exits 2 without a CUDA
device.
"""

import argparse
import os
import subprocess
import sys

import chip_smoke as cs

# float32's smallest normal number: the floor of the "positive" candidate.
FLT_MIN = 1.1754943508222875e-38
FLOORS = "1e-4,1e-5,1e-6,1e-7,positive"
# ipm_kernel_check's shapes: (label, K, batch, the design, controls?)
SHAPES = (("flagship K=10", 10, 256, "cluster", True),
          ("K=4", 4, 64, "cluster", True),
          ("K=12", 12, 32, "stream", False))
FACTOR_ALONE_KS = (10, 4)


def floor_value(label):
    return FLT_MIN if label == "positive" else float(label)


def floor_defines(value):
    return (f"IPM_PIVOT_FLOOR={value!r}f",)


def build_parent(root):
    """nvcc of ``root``'s csrc/ipm_solve.cu into this tree's build
    directory, started; returns (process, library path)."""
    from mav_tube_trajectory_generation_tpu_torch import _build
    src = os.path.join(os.path.abspath(root), cs.PKG, "csrc", "ipm_solve.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libipm_solve_parent.so")
    proc = subprocess.Popen([_build.find_nvcc()] + _build.NVCC_FLAGS
                            + ["-o", so, src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--floors", default=FLOORS)
    parser.add_argument("--parent-root", default=None)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    import ctypes
    import torch
    if not torch.cuda.is_available():
        print("pivot_floor_sweep: no CUDA device", file=sys.stderr)
        return 2
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        cs.LOG_PATH = opts.out
    import mav_tube_trajectory_generation_tpu_torch as mtt
    from mav_tube_trajectory_generation_tpu_torch import _build
    from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel

    state = {}
    cs.phase_toolchain(state)
    labels = [f for f in opts.floors.split(",") if f]
    parent = build_parent(opts.parent_root) if opts.parent_root else None
    builds = []
    for label in labels:
        d = floor_defines(floor_value(label))
        builds += [("ipm_solve", d), ("ipm_solve", cs.IPM_SOLVE_DUMP + d),
                   ("ipm_solve", cs.IPM_DROP_RANK0 + d)]
    build_s = _build.prebuild(variants=builds)
    libs = {label: _build.variant("ipm_solve",
                                  floor_defines(floor_value(label)))
            for label in labels}
    if parent:
        out, _ = parent[0].communicate()
        if parent[0].returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's ipm_solve:\n"
                               f"{out}")
        lib = ctypes.CDLL(parent[1])
        # the parent's source floors at 1e-4 and predates this export
        lib.ipm_solve_pivot_floor = lambda: ctypes.c_float(1e-4).value
        libs["parent"] = lib
    shipped, shipped_floor = _build.load("ipm_solve"), ipm_kernel.PIVOT_FLOOR

    def use(label):
        _build._LIBS["ipm_solve"] = libs[label]
        ipm_kernel.PIVOT_FLOOR = 1e-4 if label == "parent" else \
            floor_value(label)

    # the calls, recorded once with the shipped library (their inputs do not
    # depend on #11's floor)
    by_shape = {label: cs.record_lanes(mtt, k, batch, seed=1)[3]
                for label, k, batch, _, _ in SHAPES}
    snap_only = {k: next(c for c in cs.record_lanes(mtt, k,
                                                    cs.FUSED_WIDE_ROWS,
                                                    seed=1)[3]
                         if (c[1]["n_iters"], c[1]["snap_iters"]) == (0, 2))
                 for k in FACTOR_ALONE_KS}
    batch = cs.MAIN_BATCH
    inputs = {seed: mtt.make_inputs(10, batch, seed=seed)
              for seed in cs.FUSED_SEEDS}
    cfg = dict(n_iters=10, sigma_min=0.3, corrector=False)
    fused_cfg = mtt.IPMConfig(fused=True, **cfg)

    def polished(ipm_cfg, sc):
        return mtt.solve_qcqp_polished_batch(
            sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
            admm_config=cs.bench_config(mtt), ipm_config=ipm_cfg,
            warmstart_values=sc.values)

    calls = []
    with cs.recorded(ipm_kernel, "ipm_solve_fused", calls):
        polished(fused_cfg, inputs[0])
    fused_args, fused_kw = calls[0][:2]
    del calls
    scan = polished(mtt.IPMConfig(**cfg), inputs[0])

    ok_by_floor = {}
    for label in labels:
        use(label)
        defines = floor_defines(ipm_kernel.PIVOT_FLOOR)
        floors = {seed: {} for seed in cs.FUSED_SEEDS}
        with cs.counting_floors(ipm_kernel, floors[0], fused_kw):
            ipm_kernel.ipm_solve_fused_plain(
                *(cs.to64(a) for a in fused_args), **fused_kw)
        gates, sols = [], {}
        for seed, sc in inputs.items():
            sols[seed] = polished(fused_cfg, sc)
            with cs.plain_kernels(only=("ipm_solve_fused",)), \
                    cs.counting_floors(ipm_kernel, floors[seed], fused_kw):
                plain = polished(fused_cfg, sc)
            gates.append(cs.fused_gate(sols[seed], plain, seed))
            del plain
        vs_scan = cs.margins_vs_scan(sols[0], scan)
        cases, bad = [], []
        for shape, k, _, want, full in SHAPES:
            more, more_bad = cs.fused_call_checks(
                ipm_kernel, shape, by_shape[shape], full, want, rerun=True)
            cases += more
            bad += more_bad
            if full:
                args, kw, _ = next(c for c in by_shape[shape]
                                   if (c[1]["n_iters"], c[1]["snap_iters"])
                                   == (1, 0))
                with cs.library_variant("ipm_solve",
                                        cs.IPM_DROP_RANK0 + defines):
                    wrong = ipm_kernel.ipm_solve_fused(*args, **kw)
                res, _, _ = cs.check_call(
                    ipm_kernel.ipm_solve_fused,
                    ipm_kernel.ipm_solve_fused_plain, cs.FUSED_OUT, args, kw,
                    ours=wrong, uncapped=cs.fused_uncapped(kw))
                rejected = not res["within_tolerance"]
                cases.append(dict(kernel="ipm_solve_fused", shapes=shape,
                                  n_iters=1, snap_iters=0,
                                  without_rank0_band_partial_rejected=rejected))
                if not rejected:
                    bad.append(f"{shape}: #11 without rank 0's band partial "
                               f"passes")
        alone = {}
        for k, (args, kw, _) in snap_only.items():
            ours = ipm_kernel.ipm_solve_fused(*args, **kw)
            alone[f"K={k}"] = cs.factor_alone(ipm_kernel, args, kw, ours,
                                              defines=defines)
        ok = dict(fused_gates=all(g["ok"] for g in gates),
                  vs_scan=all(v <= 1.0 for v in vs_scan.values()),
                  ipm_kernel_check=not bad,
                  factor_alone=all(a["rows_lost_by_factor"] == 0
                                   for a in alone.values()))
        ok_by_floor[label] = all(ok.values())
        cs.emit("pivot_floor", floor=label, value=ipm_kernel.PIVOT_FLOOR,
                library_floor=libs[label].ipm_solve_pivot_floor(), ok=ok,
                fused_gates=gates, margins_vs_scan=vs_scan,
                plain_rows_flooring_a_pivot={
                    f"seed {seed}": cs.floored_counts(f)
                    for seed, f in floors.items()},
                ipm_kernel_check_failures=bad, ipm_kernel_check_cases=cases,
                factor_alone=alone, nvidia_smi=state["nvidia_smi"])
        del sols, cases
        torch.cuda.empty_cache()

    order = labels + (["parent"] if parent else [])
    ms = {label: [] for label in order}
    for label in order + order[::-1]:
        use(label)
        ms[label].append(cs.cuda_ms(
            lambda: ipm_kernel.ipm_solve_fused(*fused_args, **fused_kw),
            reps=opts.reps))
    _build._LIBS["ipm_solve"] = shipped
    ipm_kernel.PIVOT_FLOOR = shipped_floor
    cs.emit("pivot_floor_times", ms=ms, order=order + order[::-1],
            reps=opts.reps, gt_shape=list(fused_args[0].shape),
            n_iters=fused_kw["n_iters"], snap_iters=fused_kw["snap_iters"],
            build_seconds=round(build_s, 3), all_gates_hold=ok_by_floor,
            smallest_floor_holding_every_gate=next(
                (f for f in sorted(ok_by_floor, key=floor_value)
                 if ok_by_floor[f]), None),
            nvidia_smi=state["nvidia_smi"])
    cs.say(state["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
