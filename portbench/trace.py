"""Reading a ``torch.profiler`` trace of the window: the device's busy time
as the union of its operations' intervals, the time of named kernels, and
the breakdown the result line carries.

The profiler records the device's activity only (kernels, copies,
fills): recording every host op as well slowed the eager training step
by a quarter under the profiler. Its timestamps are Unix-epoch
nanoseconds, the clock of ``time.time_ns``, so the window and the
benchmark's spans, taken on the host with that clock, bound the trace
and label its idle gaps by what the host was doing while the device
waited.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Trace:
    ops: list = field(default_factory=list)     # (name, start_ns, end_ns)
    spans: list = field(default_factory=list)   # (name, start_ns, end_ns)
    lo: int = 0                                  # the traced window, ns
    hi: int = 0

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9


def from_profiler(prof, spans: list, lo: int, hi: int) -> Trace:
    """The device operations of a finished profile, with the host's
    ``spans`` [(name, start_ns, end_ns)] and the window [lo, hi] in ns."""
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if "CUDA" in str(e.device_type())]
    ops.sort(key=lambda o: o[1])
    return Trace(ops, list(spans), lo, hi)


def busy_intervals(ops, lo: int, hi: int) -> list:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    out: list = []
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr.ops, tr.lo, tr.hi)) * 1e-9


def kernel_seconds(tr: Trace, names) -> float:
    """Device time of the operations whose name contains one of ``names``,
    inside the window."""
    total = 0
    for n, s, e in tr.ops:
        if any(k in n for k in names):
            total += max(0, min(e, tr.hi) - max(s, tr.lo))
    return total * 1e-9


def _open_span(tr: Trace, t: int) -> str:
    """The innermost benchmark span open at ``t``."""
    best, width = "window", None
    for n, s, e in tr.spans:
        if s <= t <= e and (width is None or e - s < width):
            best, width = n, e - s
    return best


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark span open at its middle."""
    by_name: dict = {}
    for n, s, e in tr.ops:
        d = max(0, min(e, tr.hi) - max(s, tr.lo))
        by_name[n[:120]] = by_name.get(n[:120], 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(tr.ops, tr.lo, tr.hi)
    edges = [tr.lo] + [x for iv in busy for x in iv] + [tr.hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, d * 1e-9] for n, d in ops],
            "idle_gaps": [[_open_span(tr, (s + e) // 2), (e - s) * 1e-9]
                          for s, e in gaps]}
