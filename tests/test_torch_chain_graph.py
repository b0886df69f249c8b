"""The chain that ``sample_tokens`` captures as one CUDA graph on a card
(``topiaxl_torch/pipelines/chain_graph.py``), held on the CPU:

- its body, run eagerly from a ``ChainGraph``'s static buffers, against
  JAX's jitted ``sample_tokens`` for ``ddim``, ``dpm`` and ``ancestral``
  on a depth-2 DiT (hidden 144, 2 heads), fed the initial noise JAX draws
  from its key and, for ``ancestral``, the per-step noise it draws; bar
  atol 5e-5, rtol 1e-3 (``tests/test_torch_samplers.py``'s);
- the body under a ``TorchDispatchMode`` that fails on what a capture
  cannot hold: a host sync (``aten._local_scalar_dense``), ``aten.nonzero``
  (a sync for its size), a tensor made from host data (``aten.lift_fresh``:
  a copy from the host on a card) or on another device than the buffers';
- the cache key: one capture for the same key, a new one when
  ``cfg_scale``, the sampler, the batch or a parameter's address changes;
- the launch bookkeeping: the counts the capturing thread adds during a
  capture (and no other thread's) are taken back, each replay adds them;
  ``CapturedGraph`` of any body (the bench's chain) does the same.

The last two run through a stand-in for the CUDA graph (the CPU has
none) that runs the body at capture and at each replay, as a replay
would, without counting. ``tests/test_torch_kernels.py`` holds the real
graph against the eager chain on a card, bit for bit (marked ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from test_torch_models import tiny_dit, torch_threads  # noqa: F401
from test_torch_samplers import _jax_step_noises
from topiaxl.diffusion import create_diffusion as jax_diffusion
from topiaxl.models import DiT as JaxDiT
from topiaxl.pipelines import infer as JP
from topiaxl_torch.diffusion import create_diffusion
from topiaxl_torch.ops import _cuda
from topiaxl_torch.pipelines import chain_graph as CG
from topiaxl_torch.pipelines import infer as P

KW = dict(noise_schedule="squaredcos_cap_v2", parameterization="v")
ATOL, RTOL = 5e-5, 1e-3
SAMPLERS = ("ddim", "dpm", "ancestral")


def _jax_dit():
    return JaxDiT(seq_length=64, in_channels=68, condition_channels=32,
                  hidden_size=144, depth=2, num_heads=2, attn_proj_bias=True,
                  dtype=jnp.float32)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_graph_body_matches_jax_sample_tokens(sampler):
    dit, params = tiny_dit(seed=40)
    y = np.random.default_rng(41).standard_normal((1, 10, 32)).astype(
        np.float32)
    key = jax.random.PRNGKey(42)
    jdf = jax_diffusion("ddim6", **KW)
    ref = JP.sample_tokens(_jax_dit(), jdf, params, jnp.asarray(y), key, 6.0,
                           sampler=sampler)
    noise_key, loop_key = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_key, (1, 64, 68),
                                         jnp.float32))
    tdf = create_diffusion("ddim6", **KW)
    steps = (torch.stack(_jax_step_noises(loop_key, tdf.num_timesteps,
                                          noise.shape))
             if sampler == "ancestral" else None)
    chain = CG.ChainGraph(dit, tdf, torch.from_numpy(y),
                          torch.from_numpy(noise), 6.0, sampler,
                          step_noises=steps)
    chain.load(torch.from_numpy(y), torch.from_numpy(noise), tdf)
    got = chain.body()
    assert np.abs(np.asarray(ref.sample) - noise).max() > 0.1
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(ref.sample),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.pred_xstart.numpy(),
                               np.asarray(ref.pred_xstart), atol=ATOL,
                               rtol=RTOL)


def test_sample_tokens_on_the_cpu_is_the_eager_body():
    """On the CPU ``sample_tokens`` runs the body as it is: the same bits
    as ``_sample_tokens_eager`` and as the body on static buffers."""
    dit, _ = tiny_dit(seed=43)
    tdf = create_diffusion("ddim4", **KW)
    g = torch.Generator().manual_seed(44)
    y = torch.randn(1, 10, 32, generator=g)
    noise = torch.randn(1, 64, 68, generator=g)
    a = P.sample_tokens(dit, tdf, y, 6.0, noise=noise, sampler="dpm")
    b = P._sample_tokens_eager(dit, tdf, y, 6.0, noise=noise, sampler="dpm")
    chain = CG.ChainGraph(dit, tdf, y, noise, 6.0, "dpm")
    chain.load(y, noise, tdf)
    c = chain.body()
    assert torch.equal(a.sample, b.sample) and torch.equal(a.sample,
                                                           c.sample)


class CaptureGuard(TorchDispatchMode):
    """Fails on what a CUDA graph capture cannot hold: a host read of a
    tensor's value, ``nonzero``, a tensor made from host data, or an
    output on another device than ``device``."""

    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default,
                 torch.ops.aten.nonzero.default,
                 torch.ops.aten.lift_fresh.default}

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"{func} inside the captured body")
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device != self.device:
                raise AssertionError(f"{func} made a tensor on {t.device}")
        self.ops += 1
        return out


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("cfg_scale", [6.0, 0.0])
def test_graph_body_has_no_host_sync(sampler, cfg_scale):
    dit, _ = tiny_dit(seed=45)
    tdf = create_diffusion("ddim3", **KW)
    g = torch.Generator().manual_seed(46)
    y, noise = torch.randn(1, 10, 32, generator=g), torch.randn(1, 64, 68,
                                                                generator=g)
    chain = CG.ChainGraph(dit, tdf, y, noise, cfg_scale, sampler)
    chain.load(y, noise, tdf, g)
    guard = CaptureGuard("cpu")
    with guard:
        chain.body()
    assert guard.ops > 100


def test_capture_guard_sees_a_host_sync():
    """The guard's planted faults: ``.item()``, ``nonzero`` and a table
    made from host data inside a body fail it."""
    x = torch.ones(3)
    for fault in (lambda: x.sum().item(), lambda: x.nonzero(),
                  lambda: torch.tensor([1.0, 2.0]) + x[:2]):
        with pytest.raises(AssertionError, match="inside the captured"):
            with CaptureGuard("cpu"):
                fault()


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: ``replay`` reruns the body
    into the captured outputs and leaves the launch counts as they were
    (a replay runs no wrapper)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        before = dict(_cuda.launches)
        new = self.fn()
        for a, b in zip(self.out[:2], new[:2]):
            a.copy_(b)
        _cuda.launches.update(before)


@pytest.fixture
def fake_graphs(monkeypatch):
    """``chain_graph`` with its CUDA parts stood in for: captures are
    FakeGraphs and counted in ``made``."""
    made = []

    def capture(fn, device, generator):
        out = fn()
        made.append(FakeGraph(fn, out))
        return made[-1], out

    monkeypatch.setattr(CG, "_capture", capture)
    monkeypatch.setattr(CG, "_warm_up", lambda fn, device: fn())
    CG.forget()
    yield made
    CG.forget()


def test_one_capture_per_key(fake_graphs):
    dit, _ = tiny_dit(seed=47)
    tdf = create_diffusion("ddim3", **KW)
    g = torch.Generator().manual_seed(48)
    y = torch.randn(2, 10, 32, generator=g)
    noise = torch.randn(2, 64, 68, generator=g)

    def run(y=y, noise=noise, cfg=6.0, sampler="ddim", diffusion=tdf):
        with torch.inference_mode():
            return CG.sample(dit, diffusion, y, noise, cfg, sampler)

    first = run()
    assert len(fake_graphs) == 1
    again = run()
    assert len(fake_graphs) == 1
    assert torch.equal(first.sample, again.sample)
    # a second asset through the same graph gives its own chain
    y2 = torch.randn(2, 10, 32, generator=g)
    other = run(y=y2)
    assert len(fake_graphs) == 1
    assert torch.equal(other.sample, P._sample_tokens_eager(
        dit, tdf, y2, 6.0, noise=noise).sample)
    assert not torch.equal(other.sample, first.sample)
    run(cfg=4.0)
    assert len(fake_graphs) == 2
    run(sampler="dpm")
    assert len(fake_graphs) == 3
    run(y=y[:1], noise=noise[:1])
    assert len(fake_graphs) == 4
    run()                                   # every key is still held
    assert len(fake_graphs) == 4
    # the diffusion's tables are inputs: another diffusion of as many steps
    # replays the graph on its own tables, one of other steps captures
    other_schedule = create_diffusion("ddim3", noise_schedule="linear",
                                      parameterization="v")
    got = run(diffusion=other_schedule)
    assert len(fake_graphs) == 4
    assert torch.equal(got.sample, P._sample_tokens_eager(
        dit, other_schedule, y, 6.0, noise=noise).sample)
    assert not torch.equal(got.sample, first.sample)
    run(diffusion=create_diffusion("ddim4", **KW))
    assert len(fake_graphs) == 5
    # weights copied in place keep their addresses: the graph stays
    with torch.no_grad():
        dit.load_state_dict({k: v * 1.0 for k, v in dit.state_dict().items()})
    run()
    assert len(fake_graphs) == 5
    # an assigned parameter moves: the DiT's graphs go, the key captures
    w = dit.blocks[0].attn.qkv.weight
    w.data = w.data.clone()
    run()
    assert len(fake_graphs) == 6
    run(cfg=4.0)
    assert len(fake_graphs) == 7


def test_threads_take_turns_on_a_keys_buffers(fake_graphs):
    """Eight threads, more than the two torch threads the tests run on,
    call one key with their own assets at once (a short switch interval
    interleaves them): each gets its own asset's chain (within 1e-4, f32
    sums split otherwise under concurrent calls), which a call loading
    its y between another's load and replay would break."""
    import sys
    import threading

    dit, _ = tiny_dit(seed=61)
    tdf = create_diffusion("ddim3", **KW)
    g = torch.Generator().manual_seed(62)
    noise = torch.randn(1, 64, 68, generator=g)
    ys = [torch.randn(1, 10, 32, generator=g) for _ in range(8)]
    refs = [P._sample_tokens_eager(dit, tdf, y, 6.0, noise=noise).sample
            for y in ys]
    got, errors = {}, []

    def call(i):
        try:
            for _ in range(2):
                with torch.inference_mode():
                    out = CG.sample(dit, tdf, ys[i], noise, 6.0, "ddim")
                got.setdefault(i, []).append(out.sample)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(fake_graphs) == 1
    # concurrent CPU calls may split their sums otherwise (f32 rounding);
    # another asset's chain is further away than that by orders
    apart = min((refs[i] - refs[j]).abs().max().item()
                for i in range(8) for j in range(8) if i != j)
    assert apart > 1e-2
    for i, outs in got.items():
        assert len(outs) == 2
        for out in outs:
            assert (out - refs[i]).abs().max().item() < 1e-4, i


def test_planted_fault_keeps_the_last_conditioning(fake_graphs):
    """A replay that loads every input but y replays the last asset's
    chain: the check the card's phase makes sees it."""
    dit, _ = tiny_dit(seed=49)
    tdf = create_diffusion("ddim3", **KW)
    g = torch.Generator().manual_seed(50)
    noise = torch.randn(1, 64, 68, generator=g)
    y1, y2 = (torch.randn(1, 10, 32, generator=g) for _ in range(2))
    with torch.inference_mode():
        a = CG.sample(dit, tdf, y1, noise, 6.0, "ddim")
        chain = CG.graph_for(dit, tdf, y2, noise, 6.0, "ddim")
        chain.noise.copy_(noise)
        b = chain.replay()
    assert torch.equal(a.sample, b.sample)
    eager = P._sample_tokens_eager(dit, tdf, y2, 6.0, noise=noise).sample
    assert (b.sample - eager).abs().max() > 1e-3


def test_replays_add_the_captured_launches(fake_graphs, monkeypatch):
    """The first call runs the body once for real (its launches count) and
    captures (its launches are taken back); each replay adds the launches
    the capture saw."""
    def counting_body(dit, diffusion, y, noise, *args, **kw):
        for _ in range(3):
            _cuda.count_launch("flash_attn_fwd")
        _cuda.count_launch("ln_modulate")
        return CG.gaussian.SampleLoopOutput(noise * 2.0, noise * 3.0)

    monkeypatch.setattr(CG, "sample_chain", counting_body)
    dit, _ = tiny_dit(seed=51)
    tdf = create_diffusion("ddim3", **KW)
    y, noise = torch.zeros(1, 10, 32), torch.ones(1, 64, 68)
    saved = dict(_cuda.launches)
    _cuda.reset_launch_counts()
    try:
        stats = dict(CG.stats)
        with torch.inference_mode():
            out = CG.sample(dit, tdf, y, noise, 6.0, "ddim")
            assert _cuda.launches["flash_attn_fwd"] == 3
            assert _cuda.launches["ln_modulate"] == 1
            chain = CG.graph_for(dit, tdf, y, noise, 6.0, "ddim")
            assert chain.graph is not None
            assert chain.launches == {"flash_attn_fwd": 3, "ln_modulate": 1}
            for n in (2, 3):
                again = CG.sample(dit, tdf, y, noise, 6.0, "ddim")
                assert _cuda.launches["flash_attn_fwd"] == 3 * n
                assert _cuda.launches["ln_modulate"] == n
        assert torch.equal(out.sample, again.sample)
        assert CG.stats["captures"] == stats["captures"] + 1
        assert CG.stats["replays"] == stats["replays"] + 2
        assert sum(_cuda.launches.values()) == 12
    finally:
        _cuda.launches.update(saved)


def test_capture_counts_only_its_own_threads_launches(fake_graphs,
                                                      monkeypatch):
    """Launches another thread makes while a chain is captured (an
    extraction worker's, an eager chain's) stay counted once and are not
    booked to the graph, so later replays add only the chain's."""
    import threading

    def other_thread():
        for _ in range(5):
            _cuda.count_launch("ln_modulate_residual")

    def counting_body(dit, diffusion, y, noise, *args, **kw):
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        _cuda.count_launch("flash_attn_fwd")
        return CG.gaussian.SampleLoopOutput(noise * 2.0, noise * 3.0)

    monkeypatch.setattr(CG, "sample_chain", counting_body)
    dit, _ = tiny_dit(seed=63)
    tdf = create_diffusion("ddim3", **KW)
    y, noise = torch.zeros(1, 10, 32), torch.ones(1, 64, 68)
    saved = dict(_cuda.launches)
    _cuda.reset_launch_counts()
    try:
        with torch.inference_mode():
            CG.sample(dit, tdf, y, noise, 6.0, "ddim")   # warm-up, capture
            chain = CG.graph_for(dit, tdf, y, noise, 6.0, "ddim")
            assert chain.launches == {"flash_attn_fwd": 1}
            assert _cuda.launches["flash_attn_fwd"] == 1
            assert _cuda.launches["ln_modulate_residual"] == 10
            CG.sample(dit, tdf, y, noise, 6.0, "ddim")   # replay
        # a replay adds the graph's launches alone
        assert _cuda.launches["flash_attn_fwd"] == 2
        assert _cuda.launches["ln_modulate_residual"] == 10
    finally:
        _cuda.launches.update(saved)


def test_captured_graph_of_any_body(fake_graphs):
    """``CapturedGraph`` (the bench's chain): the first call returns the
    warm-up's result and captures, later calls replay into clones; the
    body's launches counted once a call."""
    calls = []

    def body():
        calls.append(1)
        _cuda.count_launch("ln_modulate")
        x = torch.full((2, 3), float(len(calls)))
        return CG.gaussian.SampleLoopOutput(x, x + 1.0)

    saved = dict(_cuda.launches)
    _cuda.reset_launch_counts()
    try:
        graphed = CG.CapturedGraph(body, torch.device("cpu"))
        first = graphed()
        assert graphed.graph is not None and len(fake_graphs) == 1
        assert graphed.launches == {"ln_modulate": 1}
        assert _cuda.launches["ln_modulate"] == 1
        again = graphed()
        assert len(fake_graphs) == 1 and len(calls) == 3
        assert _cuda.launches["ln_modulate"] == 2
        assert torch.equal(first.sample, torch.full((2, 3), 1.0))
        assert torch.equal(again.sample, torch.full((2, 3), 3.0))
        assert again.sample.data_ptr() != graphed.out.sample.data_ptr()
    finally:
        _cuda.launches.update(saved)


def test_ancestral_draws_what_the_eager_chain_draws(fake_graphs):
    """The graph's own generator takes the caller's state before each run
    and gives the advanced state back: at capture and at replay the chain
    draws what the eager chain draws from the same generator state, and
    leaves the generator where the eager chain leaves it."""
    dit, _ = tiny_dit(seed=58)
    tdf = create_diffusion("ddim3", **KW)
    g = torch.Generator().manual_seed(59)
    y, noise = torch.randn(1, 10, 32, generator=g), torch.randn(1, 64, 68,
                                                                generator=g)
    gen, ref_gen = torch.Generator().manual_seed(60), torch.Generator()
    outs = []
    for _ in range(3):       # capture, then two replays on one generator
        ref_gen.set_state(gen.get_state())
        with torch.inference_mode():
            got = CG.sample(dit, tdf, y, noise, 6.0, "ancestral", gen)
        ref = P._sample_tokens_eager(dit, tdf, y, 6.0, noise=noise,
                                     generator=ref_gen, sampler="ancestral")
        assert torch.equal(got.sample, ref.sample)
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        outs.append(got.sample)
    assert len(fake_graphs) == 1
    assert not torch.equal(outs[0], outs[1])   # the draws moved on


def test_capturable_refuses_a_sharded_dit():
    dit, _ = tiny_dit(seed=52)
    assert CG.capturable(dit)
    dit.blocks[1].attn.backend = "ring"
    assert not CG.capturable(dit)
    dit.blocks[1].attn.backend = "auto"
    dit.blocks[0].mlp.tp_group = object()
    assert not CG.capturable(dit)


def test_ancestral_refuses_a_cpu_generator_for_a_card_chain():
    """On a card the graph draws from a CUDA generator: a CPU one is an
    error, checked before anything reaches a card."""
    dit, _ = tiny_dit(seed=53)
    y = torch.zeros(1, 10, 32, device="meta")
    with pytest.raises(ValueError, match="generator is on cpu"):
        CG.sample(dit, create_diffusion("ddim3", **KW), y,
                  torch.zeros(1, 64, 68, device="meta"), 6.0, "ancestral",
                  torch.Generator())
