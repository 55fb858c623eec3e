"""Scoped phase timing (the reference's Timer, made actually useful).

The reference's Timer output is dead code behind an undeclared feature flag
(reference src/timer.rs:12-32, SURVEY.md §5); here profiling is a
runtime switch: SPARTAN_TPU_PROFILE=1 or Timer.enable() prints each span,
Timer.collect() records them. Off (neither) a Timer does nothing at all.
On, spans nest, synchronise the CUDA device at start and stop (when CUDA is
in use) so asynchronous kernels are attributed to the phase that queued
them, and, while collecting, record a tree: each span's id, its parent's
id, its label, and its start and end in ``time.time_ns()``, the clock of
``torch.profiler``'s event times. While collecting, the innermost running
span is also the one open ``torch.profiler.record_function`` range, named
by its label: opening a child closes its parent's range and stopping the
child opens it again, so the profiler's host timeline carries one flat
track of program phases.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import NamedTuple

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Span(NamedTuple):
    """A finished span: ``parent`` is the id of the span it ran in (None
    for a root); start and end are ``time.time_ns()``."""

    id: int
    parent: int | None
    label: str
    start_ns: int
    end_ns: int


class Timer:
    _enabled = os.environ.get("SPARTAN_TPU_PROFILE") == "1"
    _records: list | None = None  # finished Spans, in stop order, when collecting
    _open: list = []              # running Timers that print or record, innermost last
    _ids = itertools.count()

    def __init__(self, label: str):
        self.label = label
        self.id = None
        self._range = None
        collecting = Timer._records is not None
        if not (Timer._enabled or collecting):
            return
        _sync()
        if Timer._enabled:
            print(f"{'  ' * len(Timer._open)}* {label}", flush=True)
        if collecting:
            parent = Timer._open[-1] if Timer._open else None
            self.id = next(Timer._ids)
            self.parent = parent.id if parent is not None else None
            if parent is not None:
                parent._close_range()
        self.start_ns = time.time_ns()
        self._open_range()
        Timer._open.append(self)

    def stop(self) -> float:
        if self not in Timer._open:   # opened while off, or dropped by collect()
            return 0.0
        _sync()
        end_ns = time.time_ns()
        self._close_range()
        Timer._open.remove(self)
        dt = (end_ns - self.start_ns) / 1e9
        if Timer._enabled:
            print(f"{'  ' * len(Timer._open)}* {self.label} {dt * 1000:.1f} ms", flush=True)
        if self.id is not None and Timer._records is not None:
            Timer._records.append(Span(self.id, self.parent, self.label, self.start_ns, end_ns))
        if Timer._open:
            Timer._open[-1]._open_range()
        return dt

    def _open_range(self) -> None:
        if self.id is not None and Timer._records is not None:
            self._range = torch.profiler.record_function(self.label)
            self._range.__enter__()

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    @staticmethod
    def enable(on: bool = True) -> None:
        Timer._enabled = on

    @staticmethod
    def collect(on: bool = True) -> None:
        """Start (anew) or stop recording the span tree. Spans still
        running are dropped, and their profiler range is closed."""
        for t in Timer._open:
            t._close_range()
        Timer._open = []
        Timer._records = [] if on else None

    @staticmethod
    def collecting() -> bool:
        return Timer._records is not None

    @staticmethod
    def tree() -> list:
        """The finished ``Span``s since ``collect``, in stop order."""
        return list(Timer._records or [])

    @staticmethod
    def records() -> list:
        """(depth, label, seconds) of every finished span, in stop order;
        the depth counts the span's ancestors in the tree."""
        spans = Timer._records or []
        parent = {s.id: s.parent for s in spans}
        parent.update((t.id, t.parent) for t in Timer._open if t.id is not None)

        def depth(i):
            d, p = 0, parent.get(i)
            while p is not None:
                d, p = d + 1, parent.get(p)
            return d

        return [(depth(s.id), s.label, (s.end_ns - s.start_ns) / 1e9) for s in spans]

    @staticmethod
    def print(msg: str) -> None:
        if Timer._enabled:
            print(msg, flush=True)

    # -- cross-call accumulators (for per-round loops where a Timer per
    # -- iteration would spam the record stream) ---------------------------
    _acc: dict = {}
    _counts: dict = {}
    _pending: list = []   # (label, start event, end event) not read yet

    @staticmethod
    def acc(label: str, dt: float) -> None:
        Timer._acc[label] = Timer._acc.get(label, 0.0) + dt

    @staticmethod
    def count(label: str, k: int = 1) -> None:
        Timer._counts[label] = Timer._counts.get(label, 0) + k

    @staticmethod
    def laps(prefix: str):
        """While collecting, a clock ``lap``: ``lap(name)`` adds the seconds
        since its last call to the accumulator ``<prefix>/<name>``, ``lap()``
        only restarts it. Otherwise a ``lap`` that does nothing."""
        if Timer._records is None:
            return _no_lap
        last = [time.perf_counter()]

        def lap(name: str | None = None) -> None:
            t = time.perf_counter()
            if name is not None:
                Timer.acc(f"{prefix}/{name}", t - last[0])
            last[0] = t

        return lap

    @staticmethod
    @contextlib.contextmanager
    def stage(label: str, device):
        """While collecting, add the time of the enclosed work to the
        accumulator ``<innermost running Timer>/<label>``: on a CUDA device
        the stream time between two events (read in ``acc_records``, so the
        stage does not synchronise), on the CPU the wall clock. Otherwise
        does nothing."""
        if Timer._records is None:
            yield
            return
        key = f"{Timer._open[-1].label}/{label}" if Timer._open else label
        if device.type != "cuda":
            t = time.perf_counter()
            yield
            Timer.acc(key, time.perf_counter() - t)
            return
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        yield
        e.record()
        Timer._pending.append((key, s, e))

    @staticmethod
    def acc_reset() -> None:
        Timer._acc = {}
        Timer._counts = {}
        Timer._pending = []

    @staticmethod
    def acc_records() -> list:
        """[(label, seconds)] + [(label, count)] sorted by time desc."""
        for key, s, e in Timer._pending:
            e.synchronize()
            Timer.acc(key, s.elapsed_time(e) / 1e3)
        Timer._pending = []
        out = sorted(Timer._acc.items(), key=lambda kv: -kv[1])
        return out + [(f"n:{k}", v) for k, v in sorted(Timer._counts.items())]


def _no_lap(name: str | None = None) -> None:
    pass
