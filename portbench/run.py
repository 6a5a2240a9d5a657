"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port
(``mav_tube_trajectory_generation_tpu_torch/``) and ``BENCHMARK.json``.  It
needs a CUDA card (exit 2 without one, or with fewer than the cell asks
for; there is no CPU fallback).  The port's kernel libraries are built on
first use into the port's ``build/`` directory inside the checkout and
loaded from there by later runs.  The compared numbers and their limits are
the last lines on standard error, and the last key of the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_ORIGIN = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    sys.path.insert(0, ROOT)
    from portbench import core

    age = core.process_age_s()
    t_origin = T_ORIGIN - age if age is not None else T_ORIGIN
    bench = core.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = core.Cell(bench, args.workload, ROOT)

    import torch
    # One host thread for PyTorch's own CPU work: the program's host side is
    # launches and small reads, and idle pool threads spinning beside the
    # launching thread on a shared host only add noise.
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        device="cuda", t_origin=t_origin)
    found = core.forbidden_loaded()
    if found:
        print(f"the process holds modules it must not load: {found}",
              file=sys.stderr)
        return 3
    lat = out.pop("latencies_ms", [])
    if lat:
        q = {p: core.percentile(lat, p) for p in (0, 50, 90, 95, 99, 100)}
        print(f"window: {len(lat)} timed calls, ms at percentiles "
              + ", ".join(f"p{p} {v:.3f}" for p, v in q.items()),
              file=sys.stderr)
    for line in core.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
