"""The benchmark's harness: one cell, one seed, one run.

Everything that belongs to one configuration, one traffic mix, one cell's
check or one metric is found by name.  ``BENCHMARK.json`` names the cell, its
configuration and its traffic; ``portbench/configs/<config>.json`` holds the
deployment (sizes, segment times, solver settings, guarantee, the driver and
the kernel sources it builds); ``portbench/traffic/<traffic>.json`` the mix
(batch, pool, waypoint steps, radii); ``portbench/cells/<cell>.json`` the
check's sample and limits; ``portbench/drivers/<driver>.py`` the entry point
the window drives; ``portbench/metrics/<metric>.py`` one reader a metric.

A run: set-up (import, CUDA context, the cell's kernel libraries, the pool of
distinct batches made from the seed and moved to the card, one warm call),
then a closed loop with one client for ``seconds`` seconds, then the check
against the plain reference, then one JSON line.  With ``trace`` the window
first runs a stretch of whole calls under the profiler, then the rest with
synchronised spans around the program's layers; its metrics are the
per-layer ones.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names that no process of the benchmark may hold: the
#: JAX package (the port's name begins with it: names are compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mav_tube_trajectory_generation_tpu")

#: Share of the window's calls, past the first pass over the pool, whose
#: every answer the check keeps (the others keep the sampled rows).
FULL_CALL_SHARE = 0.125


def load_file(path: str, name: str) -> ModuleType:
    """A Python file of the benchmark as a module (files are found by the
    names in ``BENCHMARK.json``, not imported by a fixed list)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def read_bench(root: str = ROOT, held_out: bool = False) -> Dict:
    """``BENCHMARK.json``; with ``held_out`` also the entries of
    ``portbench/held_out.json``, the cells whose check the program fails
    today (the calibration and the tests run them; the benchmark does not)."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    if held_out:
        extra = read_json(os.path.join(root, "portbench", "held_out.json"))
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    check files read."""

    def __init__(self, bench: Dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.root = root
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = read_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.traffic = read_json(os.path.join(
            root, "portbench", "traffic", self.entry["traffic"] + ".json"))
        self.check = read_json(os.path.join(root, "portbench", "cells",
                                            name + ".json"))
        self.chips = int(self.entry["chips"])
        self.metrics_e2e = [m for m in bench["end_to_end"]
                            if name in m.get("workloads", [name])]
        self.metrics_layer = [m for m in bench["per_layer"]
                              if name in m.get("workloads", [name])]

    def driver(self) -> ModuleType:
        d = self.config["driver"]
        return load_file(os.path.join(self.root, "portbench", "drivers",
                                      d + ".py"), "portbench_driver_" + d)

    def reader(self, metric: str) -> ModuleType:
        return load_file(os.path.join(self.root, "portbench", "metrics",
                                      metric + ".py"),
                         "portbench_metric_" + metric.replace(".", "_"))


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_loaded() -> List[str]:
    """Modules of ``FORBIDDEN_MODULES`` in ``sys.modules``, by whole
    top-level name."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class Context:
    """What a metric reader reads: the window, the spans, the counters and
    the trace of one run."""

    def __init__(self):
        self.setup_s: float = 0.0
        self.window_s: float = 0.0
        self.latencies_s: List[float] = []
        self.attempted = 0
        self.failed = 0
        self.counters: Dict[str, List[float]] = {}
        # one dict a timed call of a traced run: span path -> summed ms
        self.spans: List[Dict[str, float]] = []
        self.trace = None           # trace.TraceSummary of the profiled stretch
        self.cell: Optional[Cell] = None
        self.device_name = ""
        self.power_limit = ""


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_origin: Optional[float] = None,
             calls: Optional[int] = None):
    """One run of ``cell``; returns the result line's object.

    ``device`` is "cuda" for every run that reports; the CPU serves the
    tests that drive a run with a planted fault (no kernel is built, the
    program runs its plain versions).
    ``t_origin``: the ``time.perf_counter()`` reading that stands for the
    process's start.  ``calls``: run that many calls in place of a timed
    window (the tests and the calibration of the check's limits)."""
    import torch
    from portbench.gen import scenarios
    from portbench import trace as tr

    t_origin = time.perf_counter() if t_origin is None else t_origin
    ctx = Context()
    ctx.cell = cell
    on_card = device == "cuda"
    import mav_tube_trajectory_generation_tpu_torch as mtg
    if on_card:
        torch.cuda.init()
        dev = torch.device("cuda", torch.cuda.current_device())
        ctx.device_name = torch.cuda.get_device_name(dev)
        from mav_tube_trajectory_generation_tpu_torch import _build
        _build.prebuild(tuple(cell.config["sources"]))
        built = set(_build._LIBS)
    else:
        dev = torch.device(device)
    drv_mod = cell.driver()
    drv = drv_mod.Driver(mtg, cell, dev)
    pool_host = scenarios.make_pool(cell.config, cell.traffic, seed)
    pool = [drv.to_device(b) for b in pool_host]
    keep_rows = drv.sample_rows(pool_host, seed)
    fetch = Fetch(on_card)
    # every batch has the one shape: one warm call builds what it needs
    fetch(drv.call(pool[0]))
    ctx.setup_s = time.perf_counter() - t_origin

    kept: List[Dict] = []
    n_pool = len(pool)
    # Calls whose every answer is kept for the check: the first pass over
    # the pool and a share of the rest drawn from the seed (every call,
    # where the driver asks for it); of the others the sampled rows
    keep_all = np.random.default_rng([int(seed), 7])
    keep_every = bool(getattr(drv_mod.Driver, "KEEP_EVERY_CALL", False))
    trace_calls = int(cell.check["trace_calls"]) if trace else 0
    spans = tr.Spans(drv_mod.SPANS, sync=on_card) if trace else None
    i = 0
    t_start = time.perf_counter()
    while True:
        b = i % n_pool
        if i < trace_calls:
            if i == 0:
                profiled = tr.Profiled(spans, on_card)
                profiled.start()
            res = fetch(drv.call(pool[b]))
            if i == trace_calls - 1:
                ctx.trace = profiled.stop()
        else:
            if spans is not None and not spans.installed:
                spans.install()
            t = time.perf_counter()
            with spans.call() if spans is not None else tr.nothing():
                res = fetch(drv.call(pool[b]))
            ctx.latencies_s.append(time.perf_counter() - t)
        n, f, counters = drv.tally(res)
        ctx.attempted += n
        ctx.failed += f
        for k, v in counters.items():
            ctx.counters.setdefault(k, []).append(v)
        # (not inside the profiled stretch, whose idle gaps it would widen)
        first_pass = trace_calls <= i < trace_calls + n_pool
        full = keep_every or first_pass or (
            i >= trace_calls and keep_all.random() < FULL_CALL_SHARE)
        kept.append(keep(res, b, None if full else keep_rows[b]))
        i += 1
        if calls is not None:
            if i >= calls:
                break
        elif time.perf_counter() - t_start >= seconds and i > trace_calls:
            break
    ctx.window_s = time.perf_counter() - t_start
    if spans is not None:
        spans.remove()
        ctx.spans = spans.per_call
    memory_peak = 0
    if on_card:
        ctx.power_limit = tr.power_limit()
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
        from mav_tube_trajectory_generation_tpu_torch import _build
        late = sorted(set(_build._LIBS) - built)
        if late:
            raise RuntimeError(f"kernel libraries loaded inside the window "
                               f"(add them to the configuration's sources): {late}")
    del pool, res
    if on_card:
        torch.cuda.empty_cache()

    readings = drv.check(pool_host, keep_rows, kept, dev)
    if "failed" in readings:
        # a driver that keeps every call counts the guarantee's misses
        # from the reference's readings of every answer
        ctx.failed = int(readings.pop("failed"))
    limits = cell.check["limits"]
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"the check of {cell.name} reads no {missing}")
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.metrics_layer if trace else cell.metrics_e2e):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else device,
                   "kind": ctx.device_name, "count": cell.chips,
                   "memory_peak_bytes": memory_peak,
                   "power_limit": ctx.power_limit}
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics,
           "device": device_info}
    if trace and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["latencies_ms"] = [t * 1e3 for t in ctx.latencies_s]
    out["readings"] = readings
    out["checks"] = checks
    return out


class Fetch:
    """Brings a call's answers to the host: every tensor on the card is
    copied into a page-locked buffer kept from call to call, then the
    device is synchronised; what is on the host already passes."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.buffers: Dict[str, Any] = {}

    def __call__(self, res: Dict) -> Dict:
        import torch
        if not self.on_card:
            return res
        out = {}
        for k, v in res.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                buf = self.buffers.get(k)
                if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                    buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    self.buffers[k] = buf
                buf.copy_(v, non_blocking=True)
                out[k] = buf
            else:
                out[k] = v
        torch.cuda.synchronize()
        return out


def keep(res: Dict, batch: int, rows) -> Dict:
    """What the check keeps of a call: every answer (``rows`` None) or the
    rows ``rows``, copied out of the fetch buffers."""
    import torch
    out = {"batch": batch, "rows": rows}
    idx = None if rows is None else torch.as_tensor(rows, dtype=torch.long)
    for k, v in res.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone() if idx is None else v[idx]
    return out


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a compared number: name, reading, limit, verdict."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
            for k, v in checks.items()]


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile (NumPy's linear rule) of values, None if empty."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
