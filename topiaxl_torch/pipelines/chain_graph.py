"""The sampling chain as one CUDA graph: the counterpart of JAX's jitted
``sample_tokens`` (``topiaxl/pipelines/infer.py:35-87``).

JAX compiles ``sample_tokens`` once per static key (``dit``,
``cfg_scale``, ``sampler`` and the shapes) into one program that holds
the cross-attention K/V projection, the null branch's outputs and the
whole chain as one ``lax.scan``. Run op by op from Python, the same chain
is some thousand launches a CFG step whose host cost kept the card idle
about half of each step. On a CUDA card ``ChainGraph`` captures the whole
body (``sample_chain``: ``precompute_kv``, ``precompute_null_out`` and
every step of the chosen chain) in one ``torch.cuda.CUDAGraph`` and
replays it:

- its inputs are static buffers, copied in at each call: ``y``, the
  initial noise and the diffusion's tables (traced arguments of JAX's
  jit too); for ``ancestral`` the graph draws each step's noise from a
  CUDA generator of its own, registered with it
  (``register_generator_state``), into which each call copies the state
  of the caller's generator (the card's default one when none is given)
  and from which it copies the advanced state back, so a replay draws
  what the eager chain draws from that state and advances it as far;
- each call returns clones of the graph's outputs;
- one graph is kept per key (``chain_key``): the DiT and the addresses of
  its parameters and buffers (the graph reads the weights where they lay
  at capture: a ``.to()``, a re-quantisation or an assigned parameter
  moves them and drops the DiT's graphs, a ``load_state_dict`` that copies
  in place keeps them), ``cfg_scale``, the sampler, the step count and
  parameterisation, y's shape, dtype and device and the noise's shape,
  kept until ``forget`` or until the DiT is gone;
- the first call of a key runs the body once eagerly on the capture
  stream (the warm-up that creates cuBLAS's workspace and loads the
  kernels outside the capture; that call returns its result), then
  captures; every later call replays. A capture or replay that fails
  raises: nothing falls back to the eager chain;
- the kernel wrappers count their launches in Python, where a replay runs
  nothing, so the counts the capturing thread added during the capture
  are taken back and each replay adds them (``ops/_cuda.py:tally``,
  ``add_launches``);
- a capture runs on a stream of its own in ``thread_local`` error mode,
  so other threads (``serve_assets``' extraction workers) may allocate
  and synchronise meanwhile; captures are serialised by a lock, and the
  calls of one key take turns on its buffers.

The DiT must be whole on its card: ``capturable`` is false for a
tensor-parallel copy (its all-reduces) or a ring-attention one, which
``pipelines/infer.py:sample_tokens`` runs eagerly, as it runs every chain
on the CPU.

``CapturedGraph`` holds the capture, replay and launch bookkeeping of any
body (the bench's chain on K/V projected before its timed window);
``ChainGraph`` is one key of ``sample_tokens`` on top of it.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref

import torch

from ..core.profiling import span
from ..diffusion import gaussian
from ..diffusion.schedule import Diffusion, DiffusionTables
from ..ops import _cuda

# captures and replays made in this process
stats = {"captures": 0, "replays": 0}

_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_lock = threading.Lock()
_streams: dict = {}


def sample_chain(dit, diffusion, y: torch.Tensor, noise: torch.Tensor,
                 cfg_scale: float = 6.0, sampler: str = "ddim",
                 generator: torch.Generator | None = None,
                 step_noises=None) -> gaussian.SampleLoopOutput:
    """The body of ``sample_tokens``, run eagerly: cross-attention K/V of
    ``y`` [B, M, C] and the null branch's outputs, then the chain from
    ``noise`` [B, N, C_in]; ``ancestral`` draws each step's noise from
    ``generator`` or takes ``step_noises[n]``. What a ``ChainGraph``
    captures, and what runs on the CPU."""
    kvs = dit.precompute_kv(y)
    if cfg_scale > 0:
        null_outs = dit.precompute_null_out()

        def model_fn(x, t):
            return dit.forward_with_cfg_fast(x, t, kvs, null_outs, cfg_scale)
    else:
        def model_fn(x, t):
            return dit.forward_kv(x, t, kvs)

    if sampler == "ancestral":
        return gaussian.p_sample_loop(diffusion, model_fn, noise.float(),
                                      generator=generator,
                                      step_noises=step_noises)
    return gaussian.SAMPLERS[sampler](diffusion, model_fn, noise.float())


def capturable(dit) -> bool:
    """Whether ``dit`` runs whole on its card: no tensor-parallel layer
    (``tp_group``) and no ring attention (``backend``)."""
    return not any(getattr(m, "tp_group", None) is not None
                   or getattr(m, "backend", "auto") != "auto"
                   for m in dit.modules())


def weight_ptrs(dit) -> tuple:
    """The addresses of the DiT's parameters and buffers, which a graph
    reads in place."""
    return tuple(t.data_ptr() for t in itertools.chain(dit.parameters(),
                                                       dit.buffers()))


def chain_key(dit, diffusion: Diffusion, y: torch.Tensor,
              noise: torch.Tensor, cfg_scale: float, sampler: str) -> tuple:
    """What a graph is captured for, beside the DiT and its weights'
    addresses: JAX's static arguments (``cfg_scale``, the sampler) and the
    shapes, the diffusion's step count and parameterisation among them
    (its tables, like y and the noise, are inputs copied in)."""
    return (diffusion.num_timesteps, diffusion.mean_type,
            diffusion.var_type, float(cfg_scale), sampler, tuple(y.shape),
            y.dtype, str(y.device), tuple(noise.shape), dit.dtype, dit.quant)


def _stream(device: torch.device):
    """The capture stream of ``device`` (one per card, made once)."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _warm_up(fn, device):
    """``fn()`` run on the capture stream of ``device``, after the current
    stream's work and before its next; its outputs are marked as used on
    the current stream."""
    stream, current = _stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in out:
        if isinstance(t, torch.Tensor):
            t.record_stream(current)
    return out


def _capture(fn, device, generator: torch.Generator | None):
    """(graph, fn's outputs) of ``fn`` captured on the capture stream of
    ``device``; a CUDA ``generator`` is registered with the graph (the
    default one always is)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=_stream(device),
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _source_generator(generator: torch.Generator | None, device):
    """The generator an ``ancestral`` chain draws from: ``generator``, or
    the device's default one."""
    if generator is not None:
        return generator
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator


def _static_diffusion(diffusion: Diffusion) -> Diffusion:
    """A copy of ``diffusion`` whose tables are buffers of its own."""
    tables = DiffusionTables(**{
        f.name: getattr(diffusion.tables, f.name).clone()
        for f in dataclasses.fields(DiffusionTables)})
    return dataclasses.replace(diffusion, tables=tables)


class CapturedGraph:
    """``fn()`` (no arguments; it returns a ``SampleLoopOutput``) as one
    CUDA graph on ``device``; a subclass overrides ``body`` in place of
    ``fn``. The first call runs it once on the capture stream (the
    warm-up; that call returns its result), then captures it;
    every later call replays it and returns clones of its outputs. The
    launches the capturing thread's wrappers counted during the capture
    (``launches``) are taken back and each replay adds them. A CUDA
    ``generator`` the body draws from is registered with the graph, and
    keeps through the capture the state the warm-up left."""

    def __init__(self, fn, device: torch.device,
                 generator: torch.Generator | None = None):
        self.fn, self.device, self.generator = fn, device, generator
        self.graph = None
        self.out = None
        self.launches: dict = {}
        self.capture_s = None

    def body(self) -> gaussian.SampleLoopOutput:
        return self.fn()

    @torch.inference_mode()
    def capture(self) -> gaussian.SampleLoopOutput:
        """Run the body once on the capture stream (the warm-up), then
        capture it; returns the warm-up's result, made ready on the
        current stream. One capture at a time in the process."""
        with _lock:
            first = _warm_up(self.body, self.device)
            state = (None if self.generator is None
                     else self.generator.get_state())
            t0 = time.perf_counter()
            with _cuda.tally() as counts:
                self.graph, self.out = _capture(self.body, self.device,
                                                self.generator)
            self.capture_s = time.perf_counter() - t0
            self.launches = dict(counts)
            _cuda.add_launches({k: -v for k, v in self.launches.items()})
            stats["captures"] += 1
        if state is not None:
            self.generator.set_state(state)
        return first

    @torch.inference_mode()
    def replay(self) -> gaussian.SampleLoopOutput:
        """Replay the graph on what its input buffers hold; the launches
        it makes are counted here."""
        with span("chain.replay"):
            self.graph.replay()
        with _lock:
            _cuda.add_launches(self.launches)
            stats["replays"] += 1
        return gaussian.SampleLoopOutput(self.out.sample.clone(),
                                         self.out.pred_xstart.clone())

    def __call__(self) -> gaussian.SampleLoopOutput:
        return self.replay() if self.graph is not None else self.capture()


class ChainGraph(CapturedGraph):
    """One key's chain: static buffers shaped like ``y``, ``noise`` and the
    diffusion's tables, and the body (``sample_chain`` on them) captured
    at the first ``run``. An ``ancestral`` chain draws from a generator of
    its own, into which ``load`` copies the caller's generator state and
    ``done`` copies it back; ``step_noises`` (the CPU tests) hands it its
    per-step noise in place of draws."""

    def __init__(self, dit, diffusion: Diffusion, y: torch.Tensor,
                 noise: torch.Tensor, cfg_scale: float = 6.0,
                 sampler: str = "ddim", step_noises=None):
        if sampler not in gaussian.SAMPLERS:
            raise ValueError(f"sampler={sampler!r}: expected one of "
                             f"{sorted(gaussian.SAMPLERS)}")
        super().__init__(None, y.device,
                         torch.Generator(y.device)
                         if sampler == "ancestral" and step_noises is None
                         else None)
        # weakly: the cache's values must not keep its keys (the DiTs) alive
        self._dit = weakref.ref(dit)
        self.cfg_scale, self.sampler = float(cfg_scale), sampler
        self.step_noises = step_noises
        with torch.inference_mode():
            self.diffusion = _static_diffusion(diffusion)
            self.y = torch.empty_like(y)
            self.noise = torch.empty_like(noise, dtype=torch.float32)
        # one call at a time loads, runs and reads the static buffers; on a
        # card the next call's stream waits for the last call's work
        self.lock = threading.Lock()
        self.last = None

    @property
    def dit(self):
        return self._dit()

    @torch.inference_mode()
    def load(self, y: torch.Tensor, noise: torch.Tensor,
             diffusion: Diffusion,
             generator: torch.Generator | None = None) -> None:
        """Copy the inputs into the static buffers: y, the noise, the
        diffusion's tables and, for ``ancestral``, the state of
        ``generator`` (the device's default one when None)."""
        self.y.copy_(y)
        self.noise.copy_(noise)
        for f in dataclasses.fields(DiffusionTables):
            getattr(self.diffusion.tables, f.name).copy_(
                getattr(diffusion.tables, f.name))
        if self.generator is not None:
            self.generator.set_state(
                _source_generator(generator, self.device).get_state())

    def done(self, generator: torch.Generator | None = None) -> None:
        """After a run: the caller's generator (the default one when None)
        takes the state the chain's draws left."""
        if self.generator is not None:
            _source_generator(generator, self.device).set_state(
                self.generator.get_state())

    @torch.inference_mode()
    def body(self) -> gaussian.SampleLoopOutput:
        """The chain on the static buffers, eagerly (``sample_chain``)."""
        return sample_chain(self.dit, self.diffusion, self.y, self.noise,
                            self.cfg_scale, self.sampler, self.generator,
                            self.step_noises)

    def run(self, y, noise, diffusion: Diffusion,
            generator: torch.Generator | None = None
            ) -> gaussian.SampleLoopOutput:
        """One call: load the inputs, capture at the first call, replay
        after, give the generator its state back. Calls from several
        threads take turns; on a card each waits for the last one's work
        on its own stream."""
        with self.lock:
            cuda = self.device.type == "cuda"
            if cuda and self.last is not None:
                torch.cuda.current_stream(self.device).wait_event(self.last)
            self.load(y, noise, diffusion, generator)
            out = self()
            self.done(generator)
            if cuda:
                self.last = torch.cuda.Event()
                self.last.record(torch.cuda.current_stream(self.device))
            return out


def graph_for(dit, diffusion: Diffusion, y, noise, cfg_scale: float,
              sampler: str) -> ChainGraph:
    """The key's ChainGraph, made (not yet captured) at its first call: a
    DiT whose weights moved loses its graphs first."""
    ptrs = weight_ptrs(dit)
    key = chain_key(dit, diffusion, y, noise, cfg_scale, sampler)
    with _lock:
        held = _graphs.get(dit)
        if held is None or held[0] != ptrs:
            held = _graphs[dit] = (ptrs, {})
        graphs = held[1]
        if key not in graphs:
            graphs[key] = ChainGraph(dit, diffusion, y, noise, cfg_scale,
                                     sampler)
        return graphs[key]


def sample(dit, diffusion: Diffusion, y: torch.Tensor, noise: torch.Tensor,
           cfg_scale: float = 6.0, sampler: str = "ddim",
           generator: torch.Generator | None = None
           ) -> gaussian.SampleLoopOutput:
    """``sample_tokens``' chain on a card: the key's graph, captured at its
    first call, replayed after. An ``ancestral`` chain's generator must be
    a CUDA one on y's card."""
    if sampler == "ancestral" and generator is not None and not (
            generator.device.type == y.device.type
            and (generator.device.index or 0) == (y.device.index or 0)):
        raise ValueError(f"ancestral on {y.device}: the generator is on "
                         f"{generator.device}; a CUDA graph draws from a "
                         f"generator on the chain's card")
    chain = graph_for(dit, diffusion, y, noise, cfg_scale, sampler)
    return chain.run(y, noise, diffusion, generator)


def forget(dit=None) -> None:
    """Drop the graphs of ``dit`` (every DiT's when None) and their
    memory."""
    with _lock:
        if dit is None:
            _graphs.clear()
        else:
            _graphs.pop(dit, None)
