"""Step meter and metric log for training loops (the ``StepMeter`` and
``MetricLogger`` of ``topiaxl/core/profiling.py``)."""

from __future__ import annotations

import json
import time
from typing import Optional


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
