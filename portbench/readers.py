"""What the per-layer metrics' readers (``metrics/<metric>.py``) share:
the mean of a span, the device's idle share, the model FLOPs' share of
the card's peak, and a kernel's share of its roofline. Each returns None
where the run has nothing to read."""

from __future__ import annotations

from . import counts
from . import trace as T


def span_ms(run, name: str):
    vals = run.spans.get(name)
    return 1e3 * sum(vals) / len(vals) if vals else None


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - T.busy_seconds(run.trace) / run.trace.window_s)


def mfu_pct(run):
    """Model FLOPs of the units completed in the traced window over the
    window and the card's dense bf16 peak."""
    if run.trace is None or not run.units or "flops" not in run.work:
        return None
    peak, _ = counts.peaks(run.card)
    return 100.0 * run.units * run.work["flops"] / run.trace.window_s / peak


def roofline_pct(run, kernels, shapes: dict):
    """The least time the work of the window's units needs (``shapes``:
    {"attn_fwd" | "attn_bwd": [(shape, calls a unit)]}, each call bounded
    by operations over the peak or bytes over the bandwidth), over the
    device time of the kernels named in ``kernels``."""
    if run.trace is None or not run.units:
        return None
    spent = T.kernel_seconds(run.trace, kernels)
    if spent <= 0:
        return None
    count = {"attn_fwd": counts.attention_fwd, "attn_bwd": counts.attention_bwd}
    least = sum(calls * counts.least_seconds(*count[kind](*shape), run.card)
                for kind, calls_list in shapes.items()
                for shape, calls in calls_list)
    return 100.0 * run.units * least / spent
