"""Tracing, timing, a step meter and a metric log (the counterparts of
``topiaxl/core/profiling.py``): ``trace`` writes a ``torch.profiler``
Chrome trace of a block, ``timeit`` times a callable between two
synchronisations of the card, ``StepMeter`` and ``MetricLogger`` serve
the training loops.

The program's spans: ``with span(name):`` around a stage (the encode,
``generate_primx`` and its chain and decode, the training step and its
phases, the W8A8 layer's parts). The switch is the profiler: a span
records only while a ``torch.profiler`` (or ``torch.autograd.profiler``)
profile is recording, and otherwise returns one shared object that does
nothing (a flag test). A recorded span keeps its name, its id, its
parent's and its root's ids (a span opened in no other is a root; each
thread has its own stack of open spans), and its host start and end on
``time.time_ns``, the clock of the profiler's timestamps, so the spans
and the device's operations lie on one timeline. It also opens a
``record_function`` range of its name, which a profile with CPU activity
shows (``trace``'s Chrome trace, ``cli.profile``). Where the process has
initialised CUDA and the current stream is not being captured into a
graph, it records a timing event on the current CUDA stream at entry and
at exit: ``device_ms`` is the stretch of that stream's timeline between
them, the work the span enqueued and any idle time inside it, whatever
device the span's own work ran on (a span of CPU work in such a process
reads the stream's stretch too); None in a process without CUDA or in a
capture. ``spans()`` returns the finished spans (in memory only, each
holding its two events until it is cleared), ``clear_spans()`` forgets
them. Clearing is the job of whoever starts the profile: ``trace``
clears when it enters, ``cli.profile`` around each region, and the
benchmark reads only the spans inside its window.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_finished: list = []
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One span: a context manager while open, a record once finished."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "_range", "_marks", "_device_ms")

    def __init__(self, name: str):
        self.name = name
        self.id = self.parent = self.root = None
        self.start_ns = self.end_ns = None
        self._range = self._marks = self._device_ms = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._marks = (start, None)
        return self

    def __exit__(self, *exc):
        if self._marks is not None:
            if torch.cuda.is_current_stream_capturing():
                self._marks = None
            else:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._marks = (self._marks[0], end)
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.time_ns()
        _local.stack.remove(self)
        _finished.append(self)
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's device markers (waits for the
        exit marker), None without them."""
        if self._marks is not None:
            start, end = self._marks
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._marks = None
        return self._device_ms


# what ``span`` returns while no profiler records
_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` while a profiler records, else the shared
    no-op context manager."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name)


def spans() -> list:
    """The finished spans, oldest first, their ``device_ms`` resolved
    (synchronise the device first, or this waits for it)."""
    out = list(_finished)
    for s in out:
        s.device_ms  # noqa: B018 (resolves the markers)
    return out


def clear_spans() -> None:
    _finished.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host and, where a card is
    present, device activity) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (viewable in Perfetto), also when the block
    raises. Yields the profiler. Forgets the spans of earlier profiles
    first, so ``spans()`` holds this block's alone."""
    from torch.profiler import ProfilerActivity, profile

    clear_spans()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           **kwargs) -> dict:
    """Wall seconds per call of ``fn(*args, **kwargs)``: ``warmup`` calls,
    then ``iters`` timed ones, the card synchronised before the clock
    starts and before it stops. Returns ``mean_s``, ``per_sec``, ``iters``
    and the last call's ``out``."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_sec": 1.0 / dt, "iters": iters, "out": out}


class StepMeter:
    """Steps per second over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times = self._times[-self.window:]

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(span, 1e-9)


class MetricLogger:
    """JSONL metric log plus a stdout line every ``print_every`` steps."""

    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        self._fh = open(path, "a") if path else None

    def log(self, step: int, metrics: dict) -> None:
        vals = {k: float(v) for k, v in metrics.items()}
        if self._fh:
            self._fh.write(json.dumps({"step": int(step), **vals}) + "\n")
            self._fh.flush()
        if step % self.print_every == 0:
            msg = " ".join(f"{k}={v:.5g}" for k, v in vals.items())
            print(f"[step {step}] {msg}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
