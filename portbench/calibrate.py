"""Readings of the correctness check for its limits: the program's, a
control's and each planted fault's, at a cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --variants none,reference_tf32 \
        --seeds 11,12,13 [--calls N] [--out chiprun_out/cal.jsonl]

Each (variant, seed) drives ``--calls`` calls (default: one pass over the
cell's pool) through the timed path with the variant of
``portbench/faults.py`` open, runs the cell's check and prints one JSON line
with every reading of the check, compared or not.  The cells of
``portbench/held_out.json`` run too.  The benchmark's runs never run this: it serves the limits in
``portbench/cells/`` and their record in PERF.md.  Needs the card, as run.py
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variants", default="none")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    # the program switches TF32 off when it is imported: import it before
    # a control switches it on
    import mav_tube_trajectory_generation_tpu_torch  # noqa: F401
    from portbench import core, faults

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(core.read_bench(ROOT, held_out=True), args.workload,
                     ROOT)
    calls = args.calls or int(cell.traffic["pool"])
    out_fh = open(args.out, "a") if args.out else None
    try:
        for variant in args.variants.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                with faults.planted(variant, cell):
                    res = core.run_cell(cell, seed, 0.0, False,
                                        device="cuda", calls=calls)
                line = dict(workload=args.workload, variant=variant, seed=seed,
                            batch=int(cell.traffic["batch"]),
                            calls=calls, correct=res["correct"],
                            attempted=res["attempted"], failed=res["failed"],
                            readings=res["readings"],
                            memory_peak_bytes=res["device"]["memory_peak_bytes"],
                            seconds=time.perf_counter() - t0)
                text = json.dumps(line)
                print(text, flush=True)
                if out_fh:
                    out_fh.write(text + "\n")
                    out_fh.flush()
    finally:
        if out_fh:
            out_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
