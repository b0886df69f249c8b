"""A mixture-of-experts feed-forward layer: Hunyuan3D-2.1's ``MoEBlock``
(github.com/Tencent-Hunyuan/Hunyuan3D-2.1,
``hy3dshape/models/denoisers/moe_layers.py``: ``MoEBlock``, ``MoEGate``,
``AddAuxiliaryLoss``), routed dropless on the device.

Per token x (the rows of [B, L, C]):

- the gate: ``scores = softmax(x W_g^T)`` over the E experts (``gate.weight``
  [E, C], no bias), in f32 on the activation upcast; the top ``top_k``
  scores and their experts, the weights the raw softmax scores (the
  release's ``norm_topk_prob`` false);
- the output ``sum over the top k of w_e E_e(x) + S(x)``: each of the E
  routed experts ``E_e`` and the shared expert ``S`` is Linear C -> F,
  exact (erf) GELU, Linear F -> C, with biases;
- in training, the auxiliary loss ``aux = alpha * sum_e P_e f_e`` (alpha
  0.01) over the call's tokens (P_e the mean score of
  expert e, f_e E times the share of the top-k slots that went to it, no
  gradient through f_e): the forward is unchanged and the backward adds
  the gradient of ``aux`` at weight 1 (``AddAuxiliaryLoss``), whatever
  the caller's loss scale.

Dispatch, all on the device with no read to the host: the T x k slots
are sorted by expert (a stable argsort); expert e's slots take rows
``[start_e, start_e + n_e)`` of a buffer of ``rows(T * k, E)`` rows, each
group starting at a multiple of ``ALIGN`` rows, the gaps zero (the last
group runs to the buffer's end); the two routed products run over the
buffer as grouped products (``grouped_linear``: ``torch._grouped_mm`` with
the groups' end offsets on the card, a loop over the groups on the CPU),
the bias of each row's expert added; each slot's row is gathered back
and the two weighted rows of a token summed in f32 with the shared
expert's output, rounded once to the compute dtype. Every slot is
computed: no capacity, no dropped token.

The routed experts' weights are held stacked, one tensor per product
(``fc1_weight`` [E, F, C], ``fc1_bias`` [E, F], ``fc2_weight`` [E, C, F],
``fc2_bias`` [E, C]); the release's per-expert names
(``experts.<e>.net.0.proj``, ``experts.<e>.net.2``, ``shared_experts.net.0.
proj``, ``shared_experts.net.2``) map to them in
``models/hunyuandit.py:from_h21``.

The program's counter ``expert_tokens``: slots by (layer, expert),
accumulated on the device at every forward of a layer whose ``counter``
is set (the model names its layers), read to the host only by
``read_expert_tokens``. Spans: the layer's forward is ``h21.moe``, its two
grouped products and the GELU between them ``h21.moe.experts``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.profiling import span
from .layers import META, Mlp, xavier_

# rows a routed group starts on in the dispatch buffer
ALIGN = 16
# rows of the ones operand that sums a group's rows for the bias gradient
_SUM_ROWS = 16
# the release's MoEGate.aux_loss_alpha
AUX_LOSS_ALPHA = 0.01

# the program counter: {layer name: [E] int64 slots on the device}
expert_tokens: dict = {}


def reset_expert_tokens() -> None:
    expert_tokens.clear()


def read_expert_tokens() -> dict:
    """{layer name: [slots an expert]} of every counted forward since the
    last reset (a read to the host)."""
    return {k: [int(n) for n in v.tolist()] for k, v in expert_tokens.items()}


def rows(slots: int, experts: int) -> int:
    """Rows of the dispatch buffer for ``slots`` token slots: enough for
    every group to start on a multiple of ``ALIGN``, and a multiple of it
    (the weight gradient's product reads the buffer transposed, whose row
    stride ``torch._grouped_mm`` wants a multiple of 16 bytes)."""
    return -(-(slots + experts * (ALIGN - 1)) // ALIGN) * ALIGN


def dispatch_plan(expert_of_slot: torch.Tensor, experts: int):
    """(dest [S], offs [E] int32, row_expert [R], counts [E] int64) of the
    slots' experts [S]: slot s goes to row ``dest[s]`` of the buffer; group
    e ends at row ``offs[e]`` (the last at R); ``row_expert`` names each
    row's group."""
    S = expert_of_slot.numel()
    R = rows(S, experts)
    dev = expert_of_slot.device
    counts = torch.zeros(experts, dtype=torch.int64, device=dev).scatter_add_(
        0, expert_of_slot, torch.ones_like(expert_of_slot))
    padded = (counts + ALIGN - 1) // ALIGN * ALIGN
    ends = padded.cumsum(0)
    first = ends - padded                       # each group's first row
    before = counts.cumsum(0) - counts          # slots of earlier experts
    order = torch.argsort(expert_of_slot, stable=True)
    e_sorted = expert_of_slot.index_select(0, order)
    rank = torch.arange(S, device=dev) - before.index_select(0, e_sorted)
    dest = torch.empty_like(order).scatter_(
        0, order, first.index_select(0, e_sorted) + rank)
    offs = ends.to(torch.int32)
    offs[-1:].fill_(R)                 # a fill: no copy from the host
    row_expert = torch.searchsorted(
        offs, torch.arange(R, device=dev, dtype=torch.int32), right=True)
    return dest, offs, row_expert, counts


def grouped_mm_plain(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor):
    """``torch._grouped_mm(a, b, offs=offs)``'s two forms as a loop over the
    groups (group g spans ``[offs[g - 1], offs[g])``): a [R, K] with b [G,
    K, N] -> [R, N], rows of group g times b[g]; a [M, R] with b [R, N] ->
    [G, M, N], the product over group g's span of R. Reads the offsets to
    the host."""
    ends = [int(e) for e in offs.tolist()]
    starts = [0] + ends[:-1]
    if b.dim() == 3:
        out = a.new_empty((a.shape[0], b.shape[-1]))
        for g, (s, e) in enumerate(zip(starts, ends)):
            out[s:e] = a[s:e] @ b[g]
        return out
    return torch.stack([a[:, s:e] @ b[s:e] for s, e in zip(starts, ends)])


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor):
    """The grouped product of ``grouped_mm_plain``: ``torch._grouped_mm``
    on CUDA tensors, the loop on the CPU."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a, b, offs=offs)
    return grouped_mm_plain(a, b, offs)


class _GroupedLinear(torch.autograd.Function):
    """y = x W_g^T + b_g for the rows of each group g; the three gradients
    as grouped products (the bias's: a ones operand over each group's
    rows)."""

    @staticmethod
    def forward(ctx, x, weight, bias, offs, row_expert):
        ctx.save_for_backward(x, weight, offs)
        y = grouped_mm(x, weight.transpose(1, 2), offs)
        return y + bias.index_select(0, row_expert)

    @staticmethod
    def backward(ctx, dy):
        x, weight, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_mm(dy, weight, offs)
        dyt = dy.t().contiguous()
        dw = grouped_mm(dyt, x, offs)
        ones = torch.ones((_SUM_ROWS, dy.shape[0]), dtype=dy.dtype,
                          device=dy.device)
        db = grouped_mm(ones, dy, offs)[:, 0]
        return dx, dw, db, None, None


def grouped_linear(x, weight, bias, offs, row_expert):
    """x [R, K] grouped by ``offs`` (``dispatch_plan``), weight [E, N, K]
    (each expert's ``nn.Linear`` weight), bias [E, N] -> [R, N], in x's
    dtype, differentiable in x, weight and bias."""
    return _GroupedLinear.apply(x, weight, bias, offs, row_expert)


class AddAuxiliaryLoss(torch.autograd.Function):
    """The release's ``AddAuxiliaryLoss``: returns x; its backward hands
    ``loss`` a gradient of 1."""

    @staticmethod
    def forward(ctx, x, loss):
        ctx.dtype, ctx.device = loss.dtype, loss.device
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return dx, torch.ones((), dtype=ctx.dtype, device=ctx.device)


class MoEGate(nn.Module):
    """The router's weight [E, C] (key ``weight``)."""

    def __init__(self, dim: int, experts: int, param_dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, dim, device=META,
                                               dtype=param_dtype or torch.float32))


class MoEFFN(nn.Module):
    """E routed experts (top ``top_k`` a token) and a shared expert, each
    C -> ``hidden`` -> C with exact GELU; see the module docstring."""

    def __init__(self, dim: int, hidden: int, num_experts: int = 8,
                 top_k: int = 2, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.num_experts, self.top_k, self.dtype = num_experts, top_k, dtype
        self.counter = None           # the name its slots count under
        pd = param_dtype or dtype

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=META, dtype=pd))

        self.gate = MoEGate(dim, num_experts, param_dtype)
        self.fc1_weight = param(num_experts, hidden, dim)
        self.fc1_bias = param(num_experts, hidden)
        self.fc2_weight = param(num_experts, dim, hidden)
        self.fc2_bias = param(num_experts, dim)
        self.shared = Mlp(dim, hidden, dim, dtype=dtype, approximate="none",
                          param_dtype=param_dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Each expert as a ``linear`` of the port: xavier-uniform weights,
        zero biases; the gate's too."""
        for w in (*self.fc1_weight, *self.fc2_weight, self.gate.weight):
            xavier_(w, gen)
        self.fc1_bias.zero_()
        self.fc2_bias.zero_()

    def route(self, x: torch.Tensor):
        """(experts [T, k] int64, weights [T, k] f32, scores [T, E] f32) of
        the tokens x [T, C]."""
        scores = torch.softmax(F.linear(x.float(), self.gate.weight.float()),
                               dim=-1)
        weights, experts = torch.topk(scores, self.top_k, dim=-1)
        return experts, weights, scores

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, C] in the compute dtype -> [B, L, C]."""
        with span("h21.moe"):
            return self._forward(x)

    def _forward(self, x):
        dt, E, k = self.dtype, self.num_experts, self.top_k
        shape = x.shape
        flat = x.reshape(-1, shape[-1]).to(dt)
        T = flat.shape[0]
        experts, weights, scores = self.route(flat)
        dest, offs, row_expert, counts = dispatch_plan(experts.reshape(-1), E)
        if self.counter is not None:
            with torch.no_grad():
                seen = expert_tokens.get(self.counter)
                expert_tokens[self.counter] = (counts.clone() if seen is None
                                               else seen.add_(counts))
        slots = flat.repeat_interleave(k, dim=0)
        buf = flat.new_zeros((rows(T * k, E), flat.shape[1])).index_copy(
            0, dest, slots)
        with span("h21.moe.experts"):
            h = F.gelu(grouped_linear(buf, self.fc1_weight.to(dt),
                                      self.fc1_bias.to(dt), offs, row_expert))
            out = grouped_linear(h, self.fc2_weight.to(dt),
                                 self.fc2_bias.to(dt), offs, row_expert)
        routed = (out.index_select(0, dest).view(T, k, -1).float()
                  * weights[..., None]).sum(1)
        y = (routed + self.shared(flat).float()).to(dt)
        if self.training and torch.is_grad_enabled():
            share = counts.float() * (E / (T * k))
            aux = (scores.mean(0) * share).sum() * AUX_LOSS_ALPHA
            y = AddAuxiliaryLoss.apply(y, aux)
        return y.view(shape)
