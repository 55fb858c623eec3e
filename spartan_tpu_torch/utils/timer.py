"""Scoped phase timing (the reference's Timer, made actually useful).

The reference's Timer output is dead code behind an undeclared feature flag
(reference src/timer.rs:12-32, SURVEY.md §5); here profiling is a
runtime switch: SPARTAN_TPU_PROFILE=1 or Timer.enable(). Timers nest, print
on stop, and synchronise the CUDA device at start and stop (when CUDA is
in use) so asynchronous kernels are attributed to the phase that queued
them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    _enabled = os.environ.get("SPARTAN_TPU_PROFILE") == "1"
    _depth = 0
    _records: list | None = None  # (depth, label, seconds) when collecting
    _open: list = []              # running Timers, innermost last

    def __init__(self, label: str):
        self.label = label
        _sync()
        self.start = time.perf_counter()
        self.depth = Timer._depth
        Timer._depth += 1
        Timer._open.append(self)
        if Timer._enabled:
            print(f"{'  ' * (Timer._depth - 1)}* {label}", flush=True)

    def stop(self) -> float:
        _sync()
        dt = time.perf_counter() - self.start
        if Timer._enabled:
            print(f"{'  ' * (Timer._depth - 1)}* {self.label} {dt * 1000:.1f} ms", flush=True)
        if Timer._records is not None:
            Timer._records.append((self.depth, self.label, dt))
        Timer._depth = max(0, Timer._depth - 1)
        if self in Timer._open:
            Timer._open.remove(self)
        return dt

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
        """Start/stop recording (depth, label, seconds) for every stop()."""
        Timer._records = [] if on else None

    @staticmethod
    def collecting() -> bool:
        return Timer._records is not None

    @staticmethod
    def records() -> list:
        return list(Timer._records or [])

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
