"""Named wall-clock phases, and spans and counters on the profiler's clock.

Replaces the reference's misc.setGetElapsedTime (misc.cpp:210).

Phases (`phase`, `timed`) are the CLI's steps.  They always add to
`elapsed`, and CUDA work is asynchronous, so a phase synchronizes the
card before its clock stops: a phase's seconds are the card's seconds
too.  The exit line reads `Total` from them.

Spans (`span`) and counters (`count`) mark the layer boundaries inside a
step (the reader, the refit, the GRM build, the REML loop).  They record
only while a torch profiler records on their thread (the profiler
records the thread that started it), so an operator who runs the
program under `torch.profiler` gets them in the trace.  A run without
one pays, per span, a flag test and a placeholder on the thread's span
stack: no clock is read, the card is never synchronized and no record is
made.  While recording, a span

- opens a `_RecordFunctionFast` range: a plain CPU operator in the
  profile.  `record_function` would open a user annotation instead,
  which the profiler mirrors onto the device's timeline as a
  `gpu_user_annotation` event, so a reading of the device timeline would
  count the span's whole interval as device work;
- keeps (name, parent, start_ns, end_ns, thread) from `time.time_ns()`,
  the clock the profiler stamps its events with, so a span lines up with
  the device trace's events, and an idle gap on the card is named by the
  span the host was in.  The parent is the enclosing span of the same
  thread.

A span never synchronizes the card: its interval holds the card's work
only where the span itself waits for a result (a read back to the host).
While recording, a phase is also a span of its name.  `summary()` gives
each span name's count, seconds and self seconds (its seconds less those
of its child spans), and the counters, since the last `reset()`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


def _sync_cuda() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    thread: int
    self_ns: int


class _Open:
    """A span being recorded: its profiler range, its start and the time
    its finished child spans took."""

    __slots__ = ("name", "parent", "range", "start_ns", "child_ns")

    def __init__(self, name: str, parent: Optional["_Open"]):
        self.name, self.parent, self.child_ns = name, parent, 0
        self.range = _RecordFunctionFast(name)
        self.range.__enter__()
        self.start_ns = time.time_ns()


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []


class _Span:
    """`Timers.span(name)`: a context manager, and a decorator whose every
    call is the span.  Each thread keeps a stack of its open spans (None
    where the profiler was off when the span opened)."""

    __slots__ = ("timers", "name")

    def __init__(self, timers: "Timers", name: str):
        self.timers, self.name = timers, name

    def __enter__(self):
        stack = self.timers._local.stack
        if not _profiler_enabled():
            stack.append(None)
            return
        parent = next((s for s in reversed(stack) if s is not None), None)
        stack.append(_Open(self.name, parent))

    def __exit__(self, exc_type, exc, tb):
        span = self.timers._local.stack.pop()
        if span is None:
            return False
        end_ns = time.time_ns()
        span.range.__exit__(None, None, None)
        took = end_ns - span.start_ns
        if span.parent is not None:
            span.parent.child_ns += took
        self.timers._records.append(SpanRecord(
            span.name, span.parent and span.parent.name, span.start_ns, end_ns,
            threading.get_ident(), took - span.child_ns))
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return inner


class Timers:
    def __init__(self):
        self.elapsed: Dict[str, float] = {}
        self.counters: collections.Counter = collections.Counter()
        self._records: List[SpanRecord] = []
        self._local = _Local()
        self._lock = threading.Lock()
        self._spans: Dict[str, _Span] = {}

    def reset(self) -> None:
        """In-process sequential CLI calls must not accumulate."""
        self.elapsed.clear()
        self.counters.clear()
        self._records.clear()

    def span(self, name: str) -> _Span:
        """The span `name`, as a context manager or a decorator; it records
        only while a torch profiler records (the module's docstring)."""
        span = self._spans.get(name)
        if span is None:
            span = self._spans.setdefault(name, _Span(self, name))
        return span

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` while a torch profiler records."""
        if _profiler_enabled():
            with self._lock:
                self.counters[name] += n

    @property
    def records(self) -> List[SpanRecord]:
        """The spans recorded since the last `reset()`, in the order they
        ended."""
        return list(self._records)

    def summary(self) -> dict:
        """{"spans": {name: {"count", "seconds", "self_seconds"}},
        "counters": {name: total}} over what was recorded since the last
        `reset()`."""
        spans: Dict[str, dict] = {}
        for r in self.records:
            s = spans.setdefault(r.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0})
            s["count"] += 1
            s["seconds"] += (r.end_ns - r.start_ns) * 1e-9
            s["self_seconds"] += r.self_ns * 1e-9
        with self._lock:
            counters = dict(self.counters)
        return {"spans": spans, "counters": counters}

    @contextlib.contextmanager
    def phase(self, name: str):
        """A CLI step: its seconds, the card's work included, add to
        `elapsed[name]`; while recording it is also the span `name`."""
        with self.span(name):
            start = time.monotonic()
            try:
                yield
            finally:
                _sync_cuda()
                self.elapsed[name] = self.elapsed.get(name, 0.0) + time.monotonic() - start

    def timed(self, name: str):
        """Decorator: the whole call is phase `name`."""

        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.phase(name):
                    return fn(*args, **kwargs)

            return inner

        return wrap

    @staticmethod
    def process_memory() -> dict:
        """Host VM/RSS from /proc/self/status (MemUsage parity,
        memusage.cpp:38-88)."""
        out = {}
        try:
            with open("/proc/self/status") as fh:
                for line in fh:
                    if line.startswith(("VmRSS", "VmHWM", "VmSize", "VmPeak")):
                        key, val = line.split(":", 1)
                        out[key] = val.strip()
        except OSError:
            pass
        return out


timers = Timers()
