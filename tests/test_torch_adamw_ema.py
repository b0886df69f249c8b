"""The trainers' clip + AdamW + EMA update (``ops/adamw_ema.py``,
``csrc/adamw_ema.cu``). The file imports no JAX, so its card tests run
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adamw_ema.py

On the CPU: the kernel's work items cover every element of every tensor
once (ragged, empty and exact-multiple sizes), its parameter table holds
each tensor's pointers and size (an offset view too), the checks refuse
what the kernel cannot read, and ``fused_adamw_ema_update`` leaves the
gradients as they are. (``tests/test_torch_train.py::
test_fused_update_matches_jax`` holds the plain version to the JAX
package.)

On the card: four steps of ``fused_adamw_ema_update`` through the kernel
(step 2 alone clips, weight decay 0.01, lr 2e-3) on every tensor shape of
one flagship DiT block, sizes 1, 3 and 1025, and views that are not
16-byte aligned, each step followed by the plain version on a copy of the
state on the card, given the same clip scale and arguments: p, m, v and e
within 1e-6 of the tensor's max |plain|, each step's change p' - p within
1e-5 of the max |plain change|, the count, the norm within 1e-5 of a
float64 one, the gradients untouched, one launch a step and no
synchronisation. The two may round u apart by an ulp, and p' then by an
f32 ulp: at weights of N(0, 0.02) (a DiT's scale) and a change of lr x ~1
that reads ~3.7e-6 against the change's bar (an emulation of the kernel's
source on the CPU against the plain version there). The plain version
runs on the card, not on the CPU, because the CPU's square root is no
reference at 1e-6: PyTorch takes it from MKL's vector math (``vmsSqrt``,
asked for in its high-accuracy mode: within an ulp, not correctly
rounded), and at the first call of a process a worker thread's whole
chunk has come back as the enhanced-performance mode's AVX2 code computes
it (bit for bit; up to 3.2e-4 off), in about one process in seventy with
two threads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from topiaxl_torch.ops import _cuda
from topiaxl_torch.ops import adamw_ema as A
from topiaxl_torch.pipelines import train as T


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spans(items: np.ndarray, numels: np.ndarray):
    """(tensor, start, count) of each work item, decoded as the kernel
    decodes it."""
    for item in items.tolist():
        t, chunk = item >> 32, item & 0xFFFFFFFF
        start = chunk * A.CHUNK
        yield t, start, min(A.CHUNK, int(numels[t]) - start)


@pytest.mark.parametrize("numels", [
    [0], [1, 3, 1025], [A.CHUNK], [A.CHUNK + 1, 0, 2 * A.CHUNK - 1],
    [0, 5, 0, 3 * A.CHUNK, 7, A.CHUNK - 1, 1],
])
def test_work_items_cover_every_element_once(numels):
    numels = np.asarray(numels, dtype=np.int64)
    items = A.work_items(numels)
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    for t, start, count in _spans(items, numels):
        assert 0 < count <= A.CHUNK and start % 4 == 0
        seen[t][start:start + count] += 1
    assert all((s == 1).all() for s in seen)
    # large tensors spread over many items, every item but a tensor's last
    # a whole chunk
    assert len(items) == int(sum(-(-n // A.CHUNK) for n in numels))


def test_param_rows_hold_pointers_and_sizes():
    """An offset view (4 bytes past its buffer: not 16-byte aligned, so
    the kernel reads it with scalar loads) keeps its own pointer."""
    buf = [torch.zeros(1030) for _ in range(5)]
    p, g, m, v, e = ([b[1:1026], torch.zeros(3), torch.zeros(0),
                      torch.zeros(2, 7)] for b in buf)
    rows = A.param_rows(p, g, m, v, e)
    assert rows.shape == (4, 6) and rows.dtype == np.int64
    for i in range(4):
        assert rows[i].tolist() == [p[i].data_ptr(), g[i].data_ptr(),
                                    m[i].data_ptr(), v[i].data_ptr(),
                                    e[i].data_ptr(), p[i].numel()]
    assert rows[0, 0] % 16 == 4


@pytest.mark.parametrize("bad", ["f16", "strided", "size", "device"])
def test_the_checks_refuse_what_the_kernel_cannot_read(bad):
    good = [torch.zeros(8), torch.zeros(3, 4)]
    t = {"f16": torch.zeros(3, 4, dtype=torch.float16),
         "strided": torch.zeros(4, 3).t(),
         "size": torch.zeros(13),
         "device": torch.zeros(3, 4, device="meta")}[bad]
    numels = np.array([8, 12], dtype=np.int64)
    A.check_tensors(good, numels, torch.device("cpu"), "g")
    with pytest.raises(ValueError, match=r"g\[1\]"):
        A.check_tensors([good[0], t], numels, torch.device("cpu"), "g")


def test_a_device_without_kernel_raises():
    t = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        A.adamw_ema(t, t, t, t, t, torch.ones((), device="meta"), lr=1e-3,
                    c1=0.1, c2=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                    decay=0.9999)


@pytest.mark.parametrize("clip", [1.0, None])
def test_the_update_leaves_the_gradients_as_they_are(clip):
    """A clipping step (and one with no clip) scales out of place: the
    gradients the caller passed keep their values, while the parameters,
    moments and EMA move."""
    g0 = torch.Generator().manual_seed(3)
    shapes = [(16, 8), (8,), (1,)]
    params = {f"w{i}": torch.nn.Parameter(torch.randn(s, generator=g0))
              for i, s in enumerate(shapes)}
    grads = {k: 10 * torch.randn(p.shape, generator=g0)
             for k, p in params.items()}
    kept = {k: g.clone() for k, g in grads.items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    st = T.AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()})
    spec = T.make_optimizer(lr=1e-3, weight_decay=0.01, grad_clip=clip,
                            schedule="constant")
    n = T.fused_adamw_ema_update(grads, st, params, ema, spec)
    assert st.count == 1
    want = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in kept.values()]))
    torch.testing.assert_close(n, want)
    for k in params:
        assert torch.equal(grads[k], kept[k]), k
        assert not torch.equal(params[k].detach(), before[k]), k
        assert st.mu[k].abs().max() > 0 and st.nu[k].abs().max() > 0, k


# -- on the card --------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW + EMA kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _tensors():
    """name -> f32 [shape] of one flagship DiT block's parameters, sizes 1,
    3 and 1025, and 1025 elements at 4 and 8 bytes past a buffer's start
    (every one of p, g, m, v, e an offset view there)."""
    from topiaxl_torch.models.dit import DiTBlock

    block = DiTBlock(1152, 768, 16, param_dtype=torch.float32)
    shapes = {f"block.{k}": tuple(p.shape)
              for k, p in block.named_parameters()}
    shapes.update(one=(1,), three=(3,), ragged=(1025,))
    return shapes, {"offset4": 1, "offset8": 2}


def _state(shapes, offsets, device, seed):
    """(params, ema, AdamState, grads for 4 steps) on ``device``, the same
    numbers on every device: weights N(0, 0.02), gradients N(0, 1e-4)
    (a global norm of ~0.6), step 2's N(0, 10) (the clip takes it)."""
    g = torch.Generator().manual_seed(seed)
    full = dict(shapes, **{k: (1025,) for k in offsets})

    def place(name, t):
        if name not in offsets:
            return t.to(device)
        buf = torch.zeros(offsets[name] + 1025 + 3, device=device)
        view = buf[offsets[name]:offsets[name] + 1025]
        view.copy_(t)
        return view

    params = {k: torch.nn.Parameter(place(k, 0.02 * torch.randn(
        s, generator=g))) for k, s in full.items()}
    ema = {k: place(k, p.detach().cpu().clone()) for k, p in params.items()}
    st = T.AdamState(0, {k: place(k, torch.zeros(s)) for k, s in full.items()},
                     {k: place(k, torch.zeros(s)) for k, s in full.items()})
    steps = [{k: place(k, (10.0 if i == 1 else 1e-4) * torch.randn(
        s, generator=g)) for k, s in full.items()} for i in range(4)]
    return params, ema, st, steps


@pytest.mark.cuda
def test_kernel_matches_the_plain_version_for_four_steps(monkeypatch):
    dev = _card()
    shapes, offsets = _tensors()
    spec = T.make_optimizer(lr=2e-3, weight_decay=0.01, grad_clip=1.0,
                            schedule="constant")
    card, ref = (_state(shapes, offsets, dev, 0) for _ in range(2))
    assert all(card[0][k].data_ptr() % 16 == 4 * offsets[k] % 16
               for k in offsets)
    # the clip scale and step arguments as the trainer passed them
    calls = []

    def recorded(*args, **kw):
        calls.append((args[5], kw))
        return A.adamw_ema(*args, **kw)

    monkeypatch.setattr(T, "adamw_ema", recorded)
    names = list(ref[0])
    for i in range(4):
        grads = card[3][i]
        kept = {k: t.clone() for k, t in grads.items()}
        p_card = {k: p.detach().clone() for k, p in card[0].items()}
        p_ref = {k: p.detach().clone() for k, p in ref[0].items()}
        before = _cuda.launches["adamw_ema"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            norm = T.fused_adamw_ema_update(grads, card[2], card[0], card[1],
                                            spec)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        gscale, kw = calls[-1]
        A.adamw_ema_plain([ref[0][k].data for k in names],
                          [ref[3][i][k] for k in names],
                          [ref[2].mu[k] for k in names],
                          [ref[2].nu[k] for k in names],
                          [ref[1][k] for k in names], gscale, **kw)
        assert _cuda.launches["adamw_ema"] == before + 1
        assert card[2].count == i + 1
        exact = sum(float(g.double().square().sum())
                    for g in kept.values()) ** 0.5
        assert abs(float(norm) - exact) <= 1e-5 * exact, (float(norm), exact)
        assert (exact > 1.0) == (i == 1), "step 2 alone clips"
        for k in grads:
            assert torch.equal(grads[k], kept[k]), (k, i)
        for (ours, theirs), what in zip(
                [(card[0], ref[0]), (card[1], ref[1]), (card[2].mu, ref[2].mu),
                 (card[2].nu, ref[2].nu)], "pemv"):
            for k in theirs:
                a, b = ours[k].detach(), theirs[k].detach()
                bar = 1e-6 * float(b.abs().max())
                assert float((a - b).abs().max()) <= bar, (what, k, i)
        for k in p_ref:
            got = card[0][k].detach() - p_card[k]
            want = ref[0][k].detach() - p_ref[k]
            bar = 1e-5 * float(want.abs().max())
            assert float((got - want).abs().max()) <= bar, ("change", k, i)


@pytest.mark.cuda
def test_kernel_refuses_tensors_it_cannot_read():
    dev = _card()
    p = [torch.zeros(8, device=dev)]
    kw = dict(lr=1e-3, c1=0.1, c2=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
              decay=0.9999)
    scale = torch.ones((), device=dev)
    with pytest.raises(ValueError, match=r"g\[0\]"):
        A.adamw_ema(p, [torch.zeros(8, device=dev, dtype=torch.bfloat16)],
                    p, p, p, scale, **kw)
    with pytest.raises(ValueError, match=r"p\[0\]"):
        A.adamw_ema([torch.zeros(4, 2, device=dev).t()], p, p, p, p, scale,
                    **kw)
