"""The program's span recorder (``topiaxl_torch/core/profiling.py``:
``span``, ``spans``, ``clear_spans``) and the spans the port opens.

On the CPU: with no profiler a span is the shared no-op object and
records nothing; under ``torch.profiler`` spans record their names, ids,
parents and roots and ordered ``time.time_ns`` times, each thread on a
stack of its own; ``generate_primx``, a training step and ``int8_matmul``
give their trees of spans. On a card (marked ``cuda``): a span around a
sleeping kernel, synchronised inside it, contains the kernel's interval
in the profiler's trace (one clock), and its ``device_ms`` lies within its
host stretch, within 5% of the kernel's traced time and 0 to 1 ms over
the kernel's own; a span inside a stream capture records no event and
the capture succeeds; ``cli.profile``'s regions report the W8A8 spans'
device time.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from topiaxl_torch.core import profiling


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    # as tests/test_torch_models.py's fixture (which imports JAX, and the
    # card's tests here must not): tier 1's workers oversubscribe the cores
    # at torch's default
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(spans):
    """{(name, its parent's name)} of the spans."""
    names = {s.id: s.name for s in spans}
    return {(s.name, names.get(s.parent)) for s in spans}


def test_the_switch_is_torch_s_profiler_flag():
    """``span`` reads ``torch.autograd.profiler._is_profiler_enabled``:
    false with no profile, true while ``torch.profiler.profile`` or
    ``torch.autograd.profiler.profile`` records."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with _cpu_profile():
        assert flag() is True
        assert isinstance(profiling.span("x"), profiling.Span)
    assert flag() is False
    with torch.autograd.profiler.profile():
        assert flag() is True
    assert flag() is False
    assert profiling.span("x") is profiling._OFF


def test_without_a_profiler_a_span_records_nothing():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b is profiling._OFF
    with a as inner:
        assert inner is None
        with profiling.span("c"):
            torch.ones(2).sum()
    assert profiling.spans() == []


def test_spans_record_names_ids_parents_roots_and_host_times():
    t0 = time.time_ns()
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
            with profiling.span("inner2"):
                pass
        with profiling.span("next"):
            pass
    t1 = time.time_ns()
    inner, inner2, outer, nxt = profiling.spans()
    assert [s.name for s in (inner, inner2, outer, nxt)] == [
        "inner", "inner2", "outer", "next"]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == inner2.parent == outer.id
    assert inner.root == inner2.root == outer.id
    assert nxt.parent is None and nxt.root == nxt.id != outer.id
    assert len({s.id for s in (inner, inner2, outer, nxt)}) == 4
    assert (t0 <= outer.start_ns <= inner.start_ns <= inner.end_ns
            <= inner2.start_ns <= inner2.end_ns <= outer.end_ns
            <= nxt.start_ns <= nxt.end_ns <= t1)
    # device markers follow the process, not the span's work: a process
    # that has initialised CUDA (an earlier test on a card) times the
    # current stream's stretch
    if torch.cuda.is_initialized():
        assert all(s.device_ms >= 0 for s in profiling.spans())
    else:
        assert all(s.device_ms is None for s in profiling.spans())
    # each span opened a profiler range of its name
    keys = {e.key for e in prof.key_averages()}
    assert {"outer", "inner", "inner2", "next"} <= keys
    profiling.clear_spans()
    assert profiling.spans() == []


def test_trace_keeps_the_spans_of_its_own_block_alone(tmp_path):
    with _cpu_profile():
        with profiling.span("earlier"):
            pass
    assert [s.name for s in profiling.spans()] == ["earlier"]
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("traced"):
            torch.ones(2).sum()
    assert [s.name for s in profiling.spans()] == ["traced"]
    assert (tmp_path / "tr" / "trace.json").exists()


def test_a_span_that_raises_is_recorded_and_closed():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.span("fails"):
                raise ValueError("x")
        with profiling.span("after"):
            pass
    fails, after = profiling.spans()
    assert fails.name == "fails" and fails.end_ns >= fails.start_ns
    assert after.parent is None


def test_each_thread_keeps_its_own_stack():
    """Two threads open an outer and an inner span each, interleaved: each
    inner span's parent is its own thread's outer one."""
    turn = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"outer.{tag}"):
            turn.wait()
            with profiling.span(f"inner.{tag}"):
                turn.wait()
            turn.wait()

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in profiling.spans()}
    assert len(by) == 4
    for tag in "ab":
        outer, inner = by[f"outer.{tag}"], by[f"inner.{tag}"]
        assert outer.parent is None and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id


def test_generate_primx_spans_its_chain_and_decode():
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.vae3d import VAE3D
    from topiaxl_torch.pipelines import infer as P

    g = torch.Generator().manual_seed(0)
    dit = DiT(seq_length=16, in_channels=68, condition_channels=8,
              hidden_size=32, depth=1, num_heads=2, dtype=torch.float32,
              generator=g)
    vae = VAE3D(down_channels=(8, 16), up_channels=(16, 8),
                dtype=torch.float32, generator=g)
    diffusion = create_diffusion("ddim2", "squaredcos_cap_v2",
                                 parameterization="v")
    y = torch.randn((1, 5, 8), generator=g)
    with _cpu_profile():
        P.generate_primx(dit, vae, diffusion, y, np.zeros(68, np.float32),
                         np.ones(68, np.float32), cfg_scale=3.0, generator=g)
    spans = profiling.spans()
    assert _tree(spans) == {("generate_primx", None),
                            ("sample_tokens", "generate_primx"),
                            ("decode_primx", "generate_primx")}
    assert len({s.root for s in spans}) == 1


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_train_step_spans_its_draws_phases_and_update(grad_accum):
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.pipelines.train import (
        create_train_state, make_optimizer, make_train_step)

    model = DiT(seq_length=8, in_channels=4, condition_channels=6,
                hidden_size=16, depth=1, num_heads=2, cond_drop_prob=0.1,
                dtype=torch.float32, param_dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    diffusion = create_diffusion(None, "squaredcos_cap_v2", diffusion_steps=10)
    state = create_train_state(model)
    step = make_train_step(model, diffusion, make_optimizer(warmup_iters=1),
                           grad_accum=grad_accum)
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn((4, 8, 4), generator=g),
             "y": torch.randn((4, 3, 6), generator=g)}
    with _cpu_profile():
        step(state, batch, 7)
    spans = profiling.spans()
    assert _tree(spans) == {("train_step", None),
                            ("train.draws", "train_step"),
                            ("train.forward", "train_step"),
                            ("train.backward", "train_step"),
                            ("train.optimizer", "train_step")}
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    assert names == (["train_step", "train.draws"]
                     + ["train.forward", "train.backward"] * grad_accum
                     + ["train.optimizer"])
    assert state.step == 1


def test_int8_matmul_spans_its_three_parts():
    from topiaxl_torch.ops import int8

    g = torch.Generator().manual_seed(0)
    w_q, w_s = int8.quantize_weight(torch.randn((8, 16), generator=g))
    x = torch.randn((3, 16), generator=g)
    want = int8.int8_matmul(x, w_q, w_s, torch.float32)
    with _cpu_profile():
        got = int8.int8_matmul(x, w_q, w_s, torch.float32)
    assert torch.equal(got, want)
    spans = profiling.spans()
    assert [s.name for s in spans] == [
        "int8.quantize_activations", "int8.int_mm", "int8.rescale"]
    assert all(s.parent is None for s in spans)


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device markers are CUDA events")
    return torch.device("cuda")


def _sleep_cycles(ms: float) -> int:
    """Clock cycles ``torch.cuda._sleep`` spins for about ``ms``."""
    rate = torch.cuda.get_device_properties(0).clock_rate  # kHz
    return int(ms * rate)


# Under a profiler a launch can hold the host for milliseconds (1-13 ms
# seen on an H100, once 530 ms), which leaves the device idle inside a span
# that waited for it. Each span here opens while a kernel this long still
# runs ahead of it, so that its start marker and its kernel are queued
# back to back and its device stretch is the kernel's, plus the wake from
# the synchronisation inside the span (0.18-0.57 ms at 40 and 200 ms).
AHEAD_MS = 100.0
# device_ms - the kernel's own time, at most (ms)
OVER_KERNEL_MS = 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("sleep_ms", [40.0, 200.0])
def test_a_span_holds_its_kernel_on_the_trace_s_clock(card, sleep_ms):
    """Two spans, the profile's first and the next, each around a spinning
    kernel and synchronised inside it: each holds its kernel's traced
    interval (host spans and the trace share the clock), its ``device_ms``
    lies within its host stretch on ``time.time_ns``, within 5% of the
    kernel's traced duration, and 0 to 1 ms over the kernel's own time
    between CUDA events recorded next to it. (That offset is not read
    from the trace: the trace's durations of one kernel run up to 1.6% off
    its events' in some profiles, 3 ms at 200 ms.)"""
    torch.cuda._sleep(_sleep_cycles(1.0))       # load the kernel
    torch.cuda.synchronize()
    own = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in ("opening", "later"):
            torch.cuda._sleep(_sleep_cycles(AHEAD_MS))
            with profiling.span(name):
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(2)]
                marks[0].record()
                torch.cuda._sleep(_sleep_cycles(sleep_ms))
                marks[1].record()
                torch.cuda.synchronize()
            own.append(marks[0].elapsed_time(marks[1]))
    spans = profiling.spans()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if "CUDA" in str(e.device_type()) and "spin" in e.name())
    assert len(kernels) == 4, [e.name() for e in
                               prof.profiler.kineto_results.events()]
    read = []
    for sp, (k0, k1), own_ms in zip(spans, kernels[1::2], own):
        read.append((sp, k0, k1, (sp.end_ns - sp.start_ns) * 1e-6,
                     (k1 - k0) * 1e-6, own_ms))
        print(f"sleep {sleep_ms} ms, {sp.name} span: device_ms "
              f"{sp.device_ms:.4f}, host {read[-1][3]:.4f}, kernel traced "
              f"{read[-1][4]:.4f}, kernel's events {own_ms:.4f}; over the "
              f"kernel {sp.device_ms - own_ms:.4f} ms")
    for sp, k0, k1, host_ms, traced_ms, own_ms in read:
        assert sp.start_ns <= k0 < k1 <= sp.end_ns, (sp.name, sp.start_ns,
                                                      sp.end_ns, k0, k1)
        assert traced_ms > 0.8 * sleep_ms
        assert sp.device_ms <= host_ms, (sp.name, sp.device_ms, host_ms)
        assert sp.device_ms == pytest.approx(traced_ms, rel=0.05)
        assert 0 <= sp.device_ms - own_ms <= OVER_KERNEL_MS, (
            sp.name, sp.device_ms, own_ms)


@pytest.mark.cuda
def test_a_span_inside_a_capture_records_no_event(card):
    x = torch.ones(1024, device=card)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.cuda.stream(stream):
            (x * 2).sum()                       # warm up off the capture
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            with profiling.span("captured"):
                y = x * 2
        with profiling.span("replayed"):
            graph.replay()
        torch.cuda.synchronize()
    captured, replayed = profiling.spans()
    assert captured.name == "captured" and captured.device_ms is None
    assert replayed.device_ms is not None and replayed.device_ms >= 0
    assert torch.equal(y, x * 2)


@pytest.mark.cuda
def test_profile_region_reports_the_int8_spans(card):
    from topiaxl_torch.cli.profile import profile_region
    from topiaxl_torch.ops import int8

    g = torch.Generator(card).manual_seed(0)
    w_q, w_s = int8.quantize_weight(torch.randn((1024, 1024), device=card,
                                                generator=g))
    x = torch.randn((4096, 1024), device=card, generator=g)
    out = profile_region("int8", lambda: int8.int8_matmul(x, w_q, w_s), 3)
    assert set(out["ranges_ms"]) == {
        "int8.quantize_activations", "int8.int_mm", "int8.rescale"}
    assert all(ms > 0 for ms in out["ranges_ms"].values()), out["ranges_ms"]
    assert out["device_ms"] > 0
