"""Whether a long torch.profiler trace leaves a process's later traces short
of records, on the card: kernel #7's cluster launches (``admm_stage`` at the
flagship shapes, K=10 batch 6144) traced 10 at a time by ``key_averages()``
(``chip_smoke.device_time_of``, three traces) and by the raw trace
(``chip_smoke.device_launches_of``, one), in a fresh process, then after
300,000 and 3,000,000 one-element additions outside any trace, after raw
traces of 30,000 and of 300,000, and after emptying the allocator's
cache.  One JSON line: the launches each trace
holds.  Run it on a machine with the card:

    python3 profiler_probe.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mav_tube_trajectory_generation_tpu_torch as mtt  # noqa: E402
from mav_tube_trajectory_generation_tpu_torch import _build  # noqa: E402
from mav_tube_trajectory_generation_tpu_torch.ops import (  # noqa: E402
    admm_kernel as ak)


def main():
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    _build.prebuild()
    inp = cs.route_inputs(mtt, 10, cs.MAIN_BATCH, seed=0,
                          config=cs.bench_config(mtt))

    def stage():
        return ak.admm_stage(*inp["stage"], **inp["kw"])
    stage()
    torch.cuda.synchronize()
    out = {}

    def probe(label, n=10):
        held = []
        for _ in range(3):
            res = cs.device_time_of(lambda: [stage() for _ in range(n)])
            held.append(None if res is None else res["launches"])
        raw = cs.device_launches_of(lambda: [stage() for _ in range(n)])
        out[label] = dict(calls=n, key_averages=held,
                          raw=None if raw is None else raw["launches"])

    def additions(n):
        x = torch.zeros(1, device="cuda")

        def run():
            for _ in range(n):
                x.add_(1.0)
        return run

    probe("fresh")
    for n in (300_000, 3_000_000):
        t0 = time.perf_counter()
        additions(n)()
        torch.cuda.synchronize()
        out[f"untraced_{n}"] = dict(seconds=time.perf_counter() - t0)
        probe(f"after_untraced_{n}")
    for n in (30_000, 300_000):
        t0 = time.perf_counter()
        res = cs.device_launches_of(additions(n))
        out[f"trace_of_{n}"] = dict(
            launches=None if res is None else res["launches"],
            seconds=time.perf_counter() - t0)
        probe(f"after_{n}")
    torch.cuda.empty_cache()
    probe("after_empty_cache")
    print(json.dumps({"profiler_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
