"""Named spans and counters of the port's host code, kept per mixture.

`span(name)` marks a stretch of host work.  Under a profiler it opens a
`torch.profiler.record_function` of that name, so that the span lies on
the same timeline as the device's kernels; in any case it appends
`(name, parent name, start_ns, end_ns)`, on `time.perf_counter_ns()`, to
the record open in the calling thread, if any.  `count(name, n)` adds to
that record's counters.

A `JointPipeline` opens a fresh `Record` in its thread (`recording`)
around each forward, with the set-up spans of its array when this is the
array's first forward.  A forward that completes `publish`es its record to
a bounded log of the latest records (`records`); one that raises publishes
nothing.  Outside a record (the tools) a span is only the profiler's mark.

There is no switch.  Without a profiler a span costs a check that none is
on and two clock reads: the `record_function` mark, several times dearer,
is left out then.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

# Closed records kept in the log: the latest ones, of every pipeline.
LOG_SIZE = 256


class Record:
    """One mixture's spans `(name, parent, start_ns, end_ns)` in the order
    they closed, and its counters `{name: n}`."""

    def __init__(self):
        self.spans: list[tuple[str, str | None, int, int]] = []
        self.counters: dict[str, int] = {}

    @property
    def candidates(self) -> int:
        """The candidates swept (`search.candidates`), which the forward's
        lane also counts in `SweepLane.calls`."""
        return self.counters.get("search.candidates", 0)


class _State(threading.local):
    def __init__(self):
        self.record: Record | None = None
        self.open: list[str] = []  # names of the spans open, innermost last


_state = _State()
_log: collections.deque[Record] = collections.deque(maxlen=LOG_SIZE)
_log_lock = threading.Lock()  # lanes publish from their threads


class span:
    """`with span(name) as s:` marks the block; after it, `s.seconds` is
    its duration on `time.perf_counter_ns()`."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "_mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.parent = _state.open[-1] if _state.open else None
        _state.open.append(self.name)
        # the clock is read just before the mark's enter and its exit, each
        # a like lead before the profiler's own stamps, so that the span's
        # two views agree
        self.start_ns = time.perf_counter_ns()
        self._mark = None
        if torch.autograd._profiler_enabled():
            self._mark = torch.profiler.record_function(self.name)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._mark is not None:
            self._mark.__exit__(*exc)
        _state.open.pop()
        if _state.record is not None:
            _state.record.spans.append(
                (self.name, self.parent, self.start_ns, self.end_ns))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add `n` to the open record's counter `name`."""
    record = _state.record
    if record is not None:
        record.counters[name] = record.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(record: Record):
    """Spans and counts of the calling thread go to `record` inside."""
    outer, _state.record = _state.record, record
    try:
        yield record
    finally:
        _state.record = outer


def publish(record: Record) -> None:
    with _log_lock:
        _log.append(record)


def records() -> list[Record]:
    """The latest closed records, oldest first."""
    with _log_lock:
        return list(_log)
