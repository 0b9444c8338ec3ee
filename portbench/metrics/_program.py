"""Readings of the spans and counters the program records while the
window is profiled (`dissect_tpu_torch.runtime.timers`): the benchmark
profiles exactly its window, so what the program recorded since it
started is what happened in the window.  A program that records no such
span or counter (or has no `summary`) gives None, and the metric is
left out of the result line."""


def summary():
    from dissect_tpu_torch.runtime.timers import timers

    read = getattr(timers, "summary", None)
    return read() if callable(read) else None


def span_seconds(name):
    """Seconds in the spans called `name`, or None."""
    s = summary()
    span = s["spans"].get(name) if s else None
    return None if span is None else span["seconds"]


def program_share(run, name):
    """Percent of the window spent in the program's spans called `name`."""
    seconds = span_seconds(name)
    return None if seconds is None else 100.0 * seconds / run.window_s


def counter(name):
    s = summary()
    return s["counters"].get(name) if s else None
