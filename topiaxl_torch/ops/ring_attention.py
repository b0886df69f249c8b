"""Ring attention: attention over tokens sharded across the ranks of a
process group (counterpart of ``topiaxl/ops/ring_attention.py``).

Each rank holds [B, n, H, D] queries, keys and values, its slice of the
sequence. Its queries attend the K/V block in hand; the blocks then
rotate one rank along the ring (``batch_isend_irecv``: send to the next
rank, receive from the previous), and after P steps every query has seen
every key. Each step gives a partial softmax state (m, l, acc) [B, n, H,
1 / 1 / D] in f32, merged as the JAX package merges them
(``_block_attend``: running max, rescaled denominator and accumulator).

Where the state comes from follows the tensors' device, as in
``ops/flash_attention.py``:

* CPU tensors: JAX's ``_block_attend`` (f32 logits, probabilities in the
  input dtype, f32 accumulation), the plain version;
* CUDA tensors: the flash forward kernel with its lse (#1,
  ``csrc/flash_attn_fwd.cu``), whose (o, lse) is the state (m = lse,
  l = 1, acc = o); other devices raise.

Backward (``_RingAttention``): the K/V blocks go round the ring again,
each travelling with f32 dK / dV accumulators that end with their owner
after one more hop. Every block runs ``flash_attention_backward`` against
the merged output and lse, never a block's own (the kernels derive
delta = rowsum(dO * O) from the o they are given): on the card the
form ``bwd_form`` takes, the single-pass kernel (#4) at head dims up to
72 and 129-256 and for blocks of at most 2048 keys, the dq + dk/dv pair
(#5, #6) above that at 80-128. The blocks' dQ are summed in f32.

``LocalRing`` runs the same code with P ranks held in one process (the
rotation is a list rotation): the card's check of the ring against one
flash launch over the whole sequence.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import flash_attention as fa


class GroupRing:
    """One rank of a ring over ``group``: ``shift`` sends each of this
    rank's tensors to the next rank and returns those of the previous."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        r = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (r + 1) % self.size)
        self.prev = dist.get_global_rank(group, (r - 1) % self.size)

    def shift(self, parts: list) -> list:
        (tensors,) = parts
        tensors = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, self.next, self.group)
                for t in tensors]
               + [dist.P2POp(dist.irecv, t, self.prev, self.group)
                  for t in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(recv)]


class LocalRing:
    """``size`` ranks of a ring held in one process, one entry of each list
    per rank: ``shift`` hands rank r's tensors to rank r + 1."""

    def __init__(self, size: int):
        self.size = size

    def shift(self, parts: list) -> list:
        return parts[-1:] + parts[:-1]


def _block_attend(q, k, v, scale):
    """(m, l, acc) of q against one K/V block, f32, m and l [B, n, H, 1]
    (``topiaxl/ops/ring_attention.py:_block_attend``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m.transpose(1, 2), l.transpose(1, 2), acc


def _partial(q, k, v, scale):
    if q.device.type == "cpu":
        return _block_attend(q, k, v, scale)
    o, lse = fa._forward(q, k, v, scale, return_lse=True)
    m = lse.transpose(1, 2)[..., None]
    return m, torch.ones_like(m), o.float()


def _merge(state, new):
    if state is None:
        return new
    (m, l, acc), (mb, lb, ab) = state, new
    m_new = torch.maximum(m, mb)
    a1, a2 = torch.exp(m - m_new), torch.exp(mb - m_new)
    return m_new, l * a1 + lb * a2, acc * a1 + ab * a2


def ring_forward(ring, qs: list, ks: list, vs: list, scale: float):
    """(outputs in the input dtype, lse [B, H, n] f32) of each local rank's
    queries against the whole ring's keys."""
    states = [None] * len(qs)
    kv = list(zip(ks, vs))
    for step in range(ring.size):
        if step:
            kv = ring.shift(kv)
        states = [_merge(s, _partial(q, k, v, scale))
                  for s, q, (k, v) in zip(states, qs, kv)]
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, states):
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0].transpose(1, 2).contiguous())
    return outs, lses


def ring_backward(ring, qs, ks, vs, outs, lses, dos, scale: float):
    """(dq, dk, dv) per local rank, in the input dtype, from the merged
    outputs and lse of ``ring_forward``."""
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    carry = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
             for k, v in zip(ks, vs)]
    for step in range(ring.size):
        if step:
            carry = ring.shift(carry)
        for q, o, lse, do, dq, (k, v, dk, dv) in zip(qs, outs, lses, dos,
                                                     dqs, carry):
            g = fa.flash_attention_backward(q, k, v, o, lse, do, scale)
            dq += g[0].float()
            dk += g[1].float()
            dv += g[2].float()
    home = [(dk, dv) for _, _, dk, dv in carry]
    if ring.size > 1:   # each block's accumulators, one hop to their owner
        home = ring.shift(home)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(home, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(home, vs)])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, ring):
        (o,), (lse,) = ring_forward(ring, [q], [k], [v], scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.ring = scale, ring
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = ring_backward(
            ctx.ring, [q], [k], [v], [o], [lse],
            [do.to(q.dtype).contiguous()], ctx.scale)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, group=None) -> torch.Tensor:
    """[B, n, H, D] token-sharded attention over the ranks of ``group``
    (this rank's queries against every rank's keys), differentiable; the
    output dtype follows q. With ``group=None`` (or a group of one rank)
    it is dense attention over the local tokens."""
    ring = (GroupRing(group) if group is not None
            and dist.get_world_size(group) > 1 else LocalRing(1))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, scale, ring)
    return ring_forward(ring, [q], [k], [v], scale)[0][0]
