"""The program spans' arithmetic (``portbench/program_spans.py``) on a
hand-built run: a trace of device operations and the program's spans, in
nanoseconds."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import program_spans as S
from portbench import run as R
from portbench import trace as T


def _span(name, id_, start, end, parent=None, root=None, device_ms=None):
    return SimpleNamespace(name=name, id=id_, parent=parent,
                           root=id_ if root is None else root,
                           start_ns=start, end_ns=end, device_ms=device_ms)


# busy [0, 100], [300, 400], [600, 700]; idle [100, 300], [400, 600],
# [700, 1000]
OPS = [("gemm", 0, 100), ("flash", 300, 400), ("copy", 600, 700)]
SPANS = [
    _span("before", 1, -50, 80, device_ms=9.0),          # starts before lo
    _span("req", 2, 50, 450, device_ms=7.0),
    _span("chain", 3, 150, 250, parent=2, root=2, device_ms=2.0),
    _span("req", 4, 500, 650, device_ms=1.0),
    _span("chain", 5, 520, 560, parent=4, root=4, device_ms=3.0),
    _span("enc", 6, 660, 690),                           # no markers
    _span("chain", 7, 1100, 1200, device_ms=50.0),       # after hi
]


def _run(spans=SPANS, ops=OPS, lo=0, hi=1000, monkeypatch=None):
    monkeypatch.setattr(S, "recorded", lambda: spans)
    return SimpleNamespace(trace=T.Trace(list(ops), [], lo, hi))


def test_idle_time_goes_to_the_innermost_program_span_or_outside(monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    assert S.idle_intervals(run.trace) == [(100, 300), (400, 600),
                                           (700, 1000)]
    by = S.idle_by_span(run)
    # [100, 150) req, [150, 250) chain, [250, 300) req; [400, 450) req,
    # [450, 500) outside, [500, 520) req, [520, 560) chain, [560, 600) req;
    # [700, 1000) outside
    assert by == pytest.approx({"req": 210e-6, "chain": 140e-6,
                                "outside": 350e-6})
    assert sum(by.values()) == pytest.approx(
        (1000e-9 - T.busy_seconds(run.trace)) * 1e3)


def test_the_program_s_idle_share_is_the_idle_time_inside_its_spans(
        monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    # 350 ns of the 1000 ns window idle inside spans, 350 outside
    assert S.program_idle_pct(run) == pytest.approx(35.0)
    # from 500: [500, 600) in spans of the second request, [700, 1000) not
    run = _run(lo=500, monkeypatch=monkeypatch)
    assert S.program_idle_pct(run) == pytest.approx(20.0)


def test_spans_count_when_their_host_start_lies_in_the_window(monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    assert [s.id for s in S.window_spans(run)] == [2, 3, 4, 5, 6]
    # a window that starts at 500 holds the second request alone and clips
    # the idle time to [500, 1000]
    run = _run(lo=500, monkeypatch=monkeypatch)
    assert [s.id for s in S.window_spans(run)] == [4, 5, 6]
    assert S.idle_by_span(run) == pytest.approx(
        {"req": 60e-6, "chain": 40e-6, "outside": 300e-6})
    assert S.per_root_ms(run, "chain", "req") == pytest.approx(3.0)


def test_device_time_is_summed_and_divided_by_the_roots(monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    assert S.per_root_ms(run, "chain", "req") == pytest.approx(2.5)
    assert S.per_root_ms(run, "req", "req") == pytest.approx(4.0)
    assert S.per_root_ms(run, "chain", "nothing") is None


def test_without_a_trace_spans_or_markers_nothing_is_read(monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    assert S.per_root_ms(run, "enc", "req") is None      # no markers
    run.trace = None
    assert S.per_root_ms(run, "chain", "req") is None
    assert S.idle_by_span(run) is None
    assert S.program_idle_pct(run) is None
    for found in (None, []):
        run = _run(spans=found, monkeypatch=monkeypatch)
        assert S.window_spans(run) is None
        assert S.idle_by_span(run) is None
        assert S.program_idle_pct(run) is None


def test_the_readers_of_the_program_spans_read_their_spans(monkeypatch):
    spans = [_span("generate_primx", 1, 0, 400, device_ms=420.0),
             _span("chain.replay", 2, 10, 300, 1, 1, device_ms=385.0),
             _span("decode_primx", 3, 310, 390, 1, 1, device_ms=34.0),
             _span("encode", 4, 400, 450, device_ms=7.0)]
    run = _run(spans=spans, monkeypatch=monkeypatch)
    want = {"chain_device_ms.primx": 385.0, "decode_device_ms.primx": 34.0,
            "encode_device_ms.primx": 7.0}
    for name, value in want.items():
        reader, params = R.load_reader(name)
        assert reader.read(run, params) == pytest.approx(value), name
    reader, params = R.load_reader("program_idle.primx")
    # idle [100, 300], [400, 600], [700, 1000]: 200 + 50 in the spans
    assert reader.read(run, params) == pytest.approx(25.0)
    run.trace = None
    for name in ("forward_device_ms.train", "backward_device_ms.train",
                 "optimizer_device_ms.train", "program_idle.train"):
        reader, params = R.load_reader(name)
        assert reader.read(run, params) is None, name


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent's program has no ``spans``: the readers return None and
    raise nothing."""
    import topiaxl_torch.core.profiling as P

    monkeypatch.delattr(P, "spans")
    run = SimpleNamespace(trace=T.Trace(list(OPS), [], 0, 1000))
    assert S.recorded() is None
    for name in ("chain_device_ms.primx", "program_idle.primx"):
        reader, params = R.load_reader(name)
        assert reader.read(run, params) is None
