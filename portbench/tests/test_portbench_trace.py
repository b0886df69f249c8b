"""The trace's arithmetic on synthetic intervals (nanoseconds)."""

from __future__ import annotations

import pytest

from portbench import trace as T


def _trace():
    ops = [("gemm", 0, 100), ("flash_fwd_kernel<72>", 50, 150),
           ("gemm", 140, 160), ("ln", 300, 400), ("copy", 390, 420),
           ("flash_fwd_kernel<64>", 600, 700), ("late", 950, 1200)]
    spans = [("encode", 160, 320), ("stage1", 420, 1000)]
    return T.Trace(sorted(ops, key=lambda o: o[1]), spans, 0, 1000)


def test_busy_time_is_the_union_of_the_intervals_inside_the_window():
    tr = _trace()
    assert T.busy_intervals(tr.ops, tr.lo, tr.hi) == [
        [0, 160], [300, 420], [600, 700], [950, 1000]]
    assert T.busy_seconds(tr) == pytest.approx(430e-9)
    assert tr.window_s == pytest.approx(1000e-9)


def test_kernel_time_sums_the_named_kernels_inside_the_window():
    tr = _trace()
    assert T.kernel_seconds(tr, ["flash_fwd_kernel"]) == pytest.approx(200e-9)
    assert T.kernel_seconds(tr, ["late"]) == pytest.approx(50e-9)
    assert T.kernel_seconds(tr, ["nothing"]) == 0


def test_breakdown_names_the_gaps_by_the_open_span():
    b = T.breakdown(_trace())
    assert b["device_ops"][0] == ["gemm", pytest.approx(120e-9)]
    assert [n for n, _ in b["idle_gaps"]] == ["stage1", "stage1", "encode"]
    assert [g for _, g in b["idle_gaps"]] == pytest.approx(
        [250e-9, 180e-9, 140e-9])


def test_an_empty_window_reads_nothing():
    from portbench import readers

    class Run:
        trace = T.Trace([], [], 5, 5)
        units = 0
        work: dict = {}
        spans: dict = {}
        card = "NVIDIA H100 80GB HBM3"

    assert readers.idle_pct(Run) is None
    assert readers.mfu_pct(Run) is None
    assert readers.roofline_pct(Run, ["flash"], {}) is None
    assert readers.span_ms(Run, "encode") is None
