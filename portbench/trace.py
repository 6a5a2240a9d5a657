"""Spans around the program's layers, and the reduction of a device trace.

Spans are the benchmark's own: ``Spans`` replaces module attributes of the
program (``(module, attribute, span name)`` triples that a driver names in
its ``SPANS``) by wrappers, for the traced run only, and puts them back
after.  A span opened inside another is recorded under the path
``outer/inner``.  Two modes:

  * timed (the traced window after the profiled stretch): a device
    synchronisation on each side and CUDA events, so a span's milliseconds
    are the device's and the host's time of that layer alone;
  * marked (the profiled stretch): no synchronisation, the host clock's
    nanoseconds only, to name what the host was doing in the device's idle
    gaps.

``Profiled`` traces CUDA activity only (kernels, copies, sets) over a
stretch of whole calls and reduces it to the union of busy intervals, the
device operations that took the most time, and the idle gaps by the span
open on the host.
"""

from __future__ import annotations

import contextlib
import importlib
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

PACKAGE = "mav_tube_trajectory_generation_tpu_torch"


@contextlib.contextmanager
def nothing():
    yield


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them ("" if it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Spans:
    """Wrappers around the program's layers (see the module docstring)."""

    def __init__(self, specs: Sequence[Tuple[str, str, str]], sync: bool):
        self.specs = list(specs)
        self.sync = sync
        self.installed = False
        self.marking = False
        self._saved: List[Tuple[object, str, object]] = []
        self._stack: List[str] = []
        self._current: Optional[Dict[str, float]] = None
        self.per_call: List[Dict[str, float]] = []
        self.marks: List[Tuple[str, int, int]] = []

    def install(self, marking: bool = False) -> None:
        if self.installed:
            self.remove()
        self.marking = marking
        for mod_name, attr, span in self.specs:
            mod = importlib.import_module(f"{PACKAGE}.{mod_name}")
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, span))
        self.installed = True

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
        self.installed = False

    def _wrap(self, fn, span: str):
        import torch

        def wrapper(*args, **kwargs):
            path = "/".join(self._stack + [span])
            self._stack.append(span)
            try:
                if self.marking:
                    t0 = time.time_ns()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        self.marks.append((path, t0, time.time_ns()))
                if self.sync:
                    torch.cuda.synchronize()
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                    out = fn(*args, **kwargs)
                    ev1.record()
                    torch.cuda.synchronize()
                    ms = ev0.elapsed_time(ev1)
                else:
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    ms = (time.perf_counter() - t0) * 1e3
                if self._current is not None:
                    self._current[path] = self._current.get(path, 0.0) + ms
                return out
            finally:
                self._stack.pop()
        return wrapper

    @contextlib.contextmanager
    def call(self):
        """One call of the window: its spans' summed ms by path."""
        self._current = {}
        try:
            yield
        finally:
            self.per_call.append(self._current)
            self._current = None


class TraceSummary:
    """The reduction of one profiled stretch."""

    def __init__(self, busy_s: float, window_s: float,
                 device_ops: List[Tuple[str, float]],
                 idle_gaps: List[Tuple[str, float]], n_events: int):
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.n_events = n_events

    def breakdown(self) -> Dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def union_length(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """(busy ns inside [lo, hi], the gaps [(a, b)]) of a set of intervals."""
    busy, gaps = 0, []
    cur = lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def name_gaps(gaps: List[Tuple[int, int]], marks: List[Tuple[str, int, int]]
              ) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host span open at each gap's middle
    ("client": the harness between calls, outside every span)."""
    marks = sorted(marks, key=lambda m: m[1])
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name, depth = "client", -1
        for path, t0, t1 in marks:
            if t0 > mid:
                break
            if t1 >= mid and path.count("/") > depth:
                name, depth = path, path.count("/")
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])


class Profiled:
    """A stretch of whole calls under the profiler (CUDA activity only),
    with the spans marking on the host."""

    def __init__(self, spans: Optional[Spans], on_card: bool):
        self.spans = spans
        self.on_card = on_card
        self.prof = None

    def start(self) -> None:
        import torch
        if self.spans is not None:
            self.spans.install(marking=True)
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self) -> TraceSummary:
        import torch
        if self.on_card:
            torch.cuda.synchronize()
        t1 = time.time_ns()
        intervals, by_name = [], {}
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            from torch.autograd import DeviceType
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                a = int(e.start_ns())
                d = int(e.duration_ns())
                intervals.append((a, a + d))
                key = e.name()[:96]
                by_name[key] = by_name.get(key, 0.0) + d / 1e9
        marks = []
        if self.spans is not None:
            marks = list(self.spans.marks)
            self.spans.remove()
        busy, gaps = union_length(intervals, self.t0, t1)
        return TraceSummary(
            busy_s=busy / 1e9, window_s=(t1 - self.t0) / 1e9,
            device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
            idle_gaps=name_gaps(gaps, marks), n_events=len(intervals))
