"""Named-timer registry and the program's spans (reference C12 equivalent).

Counterpart of the JAX package's ``utils/timing.py``: the reference
``timing::`` registry (timing.h:36-214, src/timing.cpp) -- named timers
accumulating into one global registry with a rolling window (sum, mean,
min, max, stddev), a printable report, and a compile-out dummy -- plus
``time_torch``, which waits for the card so that asynchronous launches do
not fake a time, and the program's spans and counters.

Spans (``span``) and counters (``count``) are on only while a
``torch.profiler`` session is active (``torch.autograd.profiler``'s
``_is_profiler_enabled`` flag); otherwise a span costs one read of that flag,
records nothing and creates no CUDA event.  An operator who profiles gets
the program's phases; nobody else pays for them.  When on, a span records

  * its nested path, ``outer/inner`` (``qcqp/factor/spd_inverse``);
  * host enter and exit stamps from ``time.time_ns()``, the clock of the
    profiler's own ``start_ns()``, so that spans and device activity can be
    laid on one time line;
  * on a CUDA device, a pair of timing events recorded on the current
    stream, with no synchronisation, taken from a pool; they are turned into
    milliseconds only when the log is read (after the caller's own
    synchronisation);
  * its host seconds, into ``Timing`` under its path.

The outermost span opens a call record; ``count`` adds to the open call's
counters.  Closed calls go into a log of the last ``LOG_CALLS``, which
``span_log()`` reads.  Spans assume one host thread.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

WINDOW = 50  # rolling-window length, matching Accumulator<.,.,50>


class Accumulator:
    """Rolling-window statistics (timing.h:36-101)."""

    def __init__(self, window: int = WINDOW):
        self.window = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float) -> None:
        self.window.append(value)
        self.total += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def std(self) -> float:
        n = len(self.window)
        if n < 2:
            return 0.0
        m = self.rolling_mean
        return math.sqrt(sum((v - m) ** 2 for v in self.window) / (n - 1))


class Timing:
    """Global registry (timing.h:141-181)."""

    _timers: Dict[str, Accumulator] = {}
    enabled: bool = True

    @classmethod
    def add(cls, tag: str, seconds: float) -> None:
        if not cls.enabled:
            return
        cls._timers.setdefault(tag, Accumulator()).add(seconds)

    @classmethod
    def get(cls, tag: str) -> Optional[Accumulator]:
        return cls._timers.get(tag)

    @classmethod
    def get_mean(cls, tag: str) -> float:
        acc = cls._timers.get(tag)
        return acc.mean if acc else 0.0

    @classmethod
    def get_total(cls, tag: str) -> float:
        acc = cls._timers.get(tag)
        return acc.total if acc else 0.0

    @classmethod
    def get_num_samples(cls, tag: str) -> int:
        acc = cls._timers.get(tag)
        return acc.count if acc else 0

    @classmethod
    def reset(cls) -> None:
        cls._timers.clear()

    @classmethod
    def print(cls) -> str:
        """Formatted report (timing.cpp:159-193 analogue)."""
        lines = ["Timing", "-" * 72,
                 f"{'tag':30s} {'n':>6s} {'total':>9s} {'mean':>9s} "
                 f"{'std':>8s} {'min':>8s} {'max':>8s}"]
        for tag in sorted(cls._timers):
            a = cls._timers[tag]
            lines.append(
                f"{tag:30s} {a.count:6d} {a.total:9.4f} {a.mean:9.5f} "
                f"{a.std:8.5f} {a.min:8.5f} {a.max:8.5f}")
        return "\n".join(lines)


class Timer:
    """RAII/context-manager timer (timing.h:124-139).

    Usage::

        with Timer("opti/deriv"):
            ...
    """

    def __init__(self, tag: str, construct_stopped: bool = False):
        self.tag = tag
        self._start: Optional[float] = None
        if not construct_stopped:
            self.start()

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        dt = time.perf_counter() - self._start
        Timing.add(self.tag, dt)
        self._start = None
        return dt

    def is_timing(self) -> bool:
        return self._start is not None

    def __enter__(self):
        if self._start is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class DummyTimer:
    """Compile-out variant (timing.h:113-122)."""

    def __init__(self, *a, **k): pass
    def start(self): pass
    def stop(self): return 0.0
    def is_timing(self): return False
    def __enter__(self): return self
    def __exit__(self, *exc): return False


#: Closed calls the span log keeps; older ones are dropped.
LOG_CALLS = 256


class _Off:
    """The span of a run with no profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Call:
    """One call's spans and counters, as recorded, until the log reads it."""

    __slots__ = ("root", "intervals", "counters", "entry")

    def __init__(self, root: str):
        self.root = root
        # (path, t0_ns, t1_ns, start event, end event); no events on the host
        self.intervals: list = []
        self.counters: Dict[str, list] = {}
        self.entry: Optional[Dict] = None      # span_log's record, once read


_stack: List["_Span"] = []
_call: Optional[_Call] = None
_log: collections.deque = collections.deque(maxlen=LOG_CALLS)
_events: list = []        # timing events of calls already read, for reuse


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "device", "path", "cuda", "t0", "ev0")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        global _call
        if _stack:
            parent = _stack[-1]
            self.path = parent.path + "/" + self.name
            if self.device is None:
                self.device = parent.device
        else:
            self.path = self.name
            _call = _Call(self.name)
        self.cuda = (self.device is not None
                     and torch.device(self.device).type == "cuda")
        _stack.append(self)
        self.ev0 = None
        self.t0 = time.time_ns()
        if self.cuda:
            self.ev0 = _event()
            self.ev0.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        global _call
        ev1 = None
        if self.cuda:
            ev1 = _event()
            ev1.record(torch.cuda.current_stream(self.device))
        t1 = time.time_ns()
        _stack.pop()
        _call.intervals.append((self.path, self.t0, t1, self.ev0, ev1))
        Timing.add(self.path, (t1 - self.t0) / 1e9)
        if not _stack:
            _log.append(_call)
            _call = None
        return False


def span(name: str, device=None):
    """A span of the program (module docstring): a context manager.

    ``device``: where the span's work runs; a CUDA device gets the span
    timed on the device as well.  None takes the enclosing span's device (a
    span with no enclosing span and no device is timed on the host only).
    """
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


#: The former name of ``span``.
trace = span


def count(name: str, value) -> None:
    """Adds ``value`` to the open call's counter ``name`` while spans are on
    (nothing outside a span).  A tensor is kept as it is, and its sum is
    read when the log is read: the caller must not write to it after."""
    if _profiler._is_profiler_enabled and _call is not None:
        _call.counters.setdefault(name, []).append(value)


def _entry(call: _Call) -> Dict:
    spans: Dict[str, Dict] = {}
    for path, t0, t1, ev0, ev1 in call.intervals:
        s = spans.setdefault(path, {"host_ms": 0.0, "device_ms": None,
                                    "n": 0})
        s["host_ms"] += (t1 - t0) / 1e6
        s["n"] += 1
        if ev0 is not None:
            ev1.synchronize()
            s["device_ms"] = (s["device_ms"] or 0.0) + ev0.elapsed_time(ev1)
            _events.extend((ev0, ev1))
    counters = {name: float(sum(v.sum().item() if isinstance(v, torch.Tensor)
                                else v for v in values))
                for name, values in call.counters.items()}
    _, t0, t1, _, _ = call.intervals[-1]        # the root closes last
    return {"root": call.root, "t0_ns": t0, "t1_ns": t1, "spans": spans,
            "counters": counters,
            "intervals": [iv[:3] for iv in call.intervals]}


def span_log() -> List[Dict]:
    """The closed calls of the log, oldest first.  A call reads

        {"root": the outermost span's name, "t0_ns", "t1_ns": its stamps,
         "spans": {path: {"host_ms", "device_ms", "n"}},
         "counters": {name: total},
         "intervals": [(path, t0_ns, t1_ns), ...] in the order they closed}

    with each path's milliseconds summed over its ``n`` spans in the call;
    ``device_ms`` is None for a span off the card.  Reading waits for the
    device to reach each call's last event."""
    out = []
    for call in _log:
        if call.entry is None:
            call.entry = _entry(call)
            call.intervals, call.counters = [], {}
        out.append(call.entry)
    return out


def clear_span_log() -> None:
    """Forgets every closed call."""
    _log.clear()


def time_torch(tag: str, fn, *args, **kwargs):
    """Time a PyTorch computation correctly: waits for the card to finish
    what ``fn`` launched before the clock stops, so asynchronous launches
    are included (the counterpart of the JAX package's ``time_jax``)."""
    t = Timer(tag)
    out = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t.stop()
    return out
