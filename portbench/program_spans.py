"""The program's own spans (``topiaxl_torch/core/profiling.py``: ``span``,
``spans``), which record while the window's profiler runs, read against
the traced window: a span's device milliseconds per root span (a request's
``generate_primx``, a step's ``train_step``), and the window's idle device
time by the innermost program span open on the host at each moment.

A span counts toward a run when its host start lies in the window
``[run.trace.lo, run.trace.hi]``. Each reader returns None where the run
has no trace, or the program no spans or no device markers (a program
without the recorder; a run on the CPU).
"""

from __future__ import annotations

from . import trace as T

OUTSIDE = "outside"


def recorded() -> list | None:
    """Every finished span of the program, or None where it records none."""
    try:
        from topiaxl_torch.core.profiling import spans
    except ImportError:
        return None
    return spans()


def window_spans(run) -> list | None:
    """The program's spans whose host start lies in the traced window."""
    if run.trace is None:
        return None
    found = recorded()
    if not found:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    return [s for s in found if lo <= s.start_ns <= hi] or None


def per_root_ms(run, name: str, root: str) -> float | None:
    """The device milliseconds of the spans ``name`` in the window over
    the number of root spans ``root`` there."""
    spans = window_spans(run)
    if spans is None:
        return None
    roots = sum(s.name == root for s in spans)
    ms = [s.device_ms for s in spans if s.name == name]
    ms = [m for m in ms if m is not None]
    if not roots or not ms:
        return None
    return sum(ms) / roots


def idle_intervals(tr: T.Trace) -> list:
    """The window's stretches in which no device operation ran."""
    edges = [tr.lo] + [x for iv in T.busy_intervals(tr.ops, tr.lo, tr.hi)
                       for x in iv] + [tr.hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def innermost(spans: list, lo: int, hi: int) -> list:
    """[(start, end, span or None)] covering [lo, hi]: the span open on the
    host over each stretch that started last (the innermost), None where
    none is open."""
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for s in spans
                              for t in (s.start_ns, s.end_ns)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [s for s in spans if s.start_ns <= a and s.end_ns >= b]
        out.append((a, b, max(open_, key=lambda s: (s.start_ns, -s.end_ns))
                    if open_ else None))
    return out


def idle_by_span(run) -> dict | None:
    """{innermost program span's name, or "outside": idle device ms} over
    the traced window."""
    spans = window_spans(run)
    if spans is None:
        return None
    tr = run.trace
    segments, out = innermost(spans, tr.lo, tr.hi), {}
    i = 0
    for a, b in idle_intervals(tr):
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s, e, sp = segments[j]
            d = min(b, e) - max(a, s)
            if d > 0:
                key = OUTSIDE if sp is None else sp.name
                out[key] = out.get(key, 0.0) + d * 1e-6
            j += 1
    return out


def program_idle_pct(run) -> float | None:
    """Share of the window in which the device is idle while the host is
    inside a program span: the window's idle time less its "outside"."""
    by = idle_by_span(run)
    if by is None or run.trace.window_s <= 0:
        return None
    inside = sum(ms for k, ms in by.items() if k != OUTSIDE)
    return 100.0 * inside * 1e-3 / run.trace.window_s
