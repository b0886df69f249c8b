"""Tracing, timing, a step meter and a metric log (the counterparts of
``topiaxl/core/profiling.py``): ``trace`` writes a ``torch.profiler``
Chrome trace of a block, ``timeit`` times a callable between two
synchronisations of the card, ``StepMeter`` and ``MetricLogger`` serve
the training loops."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host and, where a card is
    present, device activity) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (viewable in Perfetto), also when the block
    raises. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

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
