"""Named wall-clock phase timers.

Replaces the reference's misc.setGetElapsedTime (misc.cpp:210).  CUDA
work is asynchronous, so a phase that ran on the card synchronizes it
before its clock stops: a phase's seconds are the card's seconds too.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict

import torch


def _sync_cuda() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timers:
    def __init__(self):
        self._start: Dict[str, float] = {}
        self.elapsed: Dict[str, float] = {}

    def reset(self) -> None:
        """In-process sequential CLI calls must not accumulate."""
        self._start.clear()
        self.elapsed.clear()

    @contextlib.contextmanager
    def phase(self, name: str):
        self._start[name] = time.monotonic()
        try:
            yield
        finally:
            _sync_cuda()
            dt = time.monotonic() - self._start.pop(name)
            self.elapsed[name] = self.elapsed.get(name, 0.0) + dt

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
