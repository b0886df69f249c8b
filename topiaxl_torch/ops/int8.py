"""W8A8 matmuls for serving (counterpart of ``topiaxl/ops/int8.py``).

Weights: static per-output-channel symmetric int8 (``quantize_weight``),
made once from a float checkpoint. Activations: dynamic per-token
symmetric int8, quantized in f32 at each call. The int8 x int8 -> int32
product is a plain product, as the JAX package leaves it to XLA outside
any Pallas kernel: ``torch._int_mm``, the int8 counterpart of
``torch.matmul``. The quant and the rescale are plain PyTorch.

Weights keep the port's ``nn.Linear`` layout, ``[out, in]``; the JAX
package's ``kernel_q`` is its transpose.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

# cuBLASLt's int8 product takes more than 16 rows
_MIN_ROWS = 32


def quantize_weight(w: torch.Tensor):
    """[out, in] float -> (int8 [out, in], f32 scale [out]): scale
    ``max|w| / 127`` per output channel, at least 1e-12; codes rounded
    half to even and clipped to [-127, 127]."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_activations(x: torch.Tensor):
    """[..., in] -> (int8 [rows, in], f32 scale [rows, 1]) per token."""
    x32 = x.float().reshape(-1, x.shape[-1])
    s = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s


def int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 [rows, in] @ int8 [out, in]^T -> int32 [rows, out]. Fewer
    than ``_MIN_ROWS`` rows are padded with zero rows (the CFG null
    branch's one token a block): a zero row changes no other row."""
    rows = xq.shape[0]
    if rows < _MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(_MIN_ROWS - rows, xq.shape[1])])
    return torch._int_mm(xq, w_q.t())[:rows]


def rescale(acc: torch.Tensor, s: torch.Tensor, w_scale: torch.Tensor,
            out_dtype) -> torch.Tensor:
    """``((acc.f32 * s) * w_scale).to(out_dtype)``, in the JAX package's
    order."""
    return ((acc.float() * s) * w_scale).to(out_dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """[..., in] @ int8 [out, in]^T with per-token activation quant."""
    xq, s = quantize_activations(x)
    out = rescale(int_mm(xq, w_q), s, w_scale, out_dtype)
    return out.reshape(*x.shape[:-1], w_q.shape[0])


class QuantDense(nn.Module):
    """W8A8 drop-in for ``layers.Dense`` in serving: an int8 weight
    ``weight_q`` [out, in], its f32 per-channel ``weight_scale`` [out] and
    an optional f32 ``bias``, added after the cast to ``dtype`` (all
    buffers: serving does not train them). Build it empty and load a
    state_dict made by ``quantize_state_dict_like``."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.in_features, self.out_features = in_f, out_f
        self.compute_dtype = dtype
        meta = torch.device("meta")
        self.register_buffer("weight_q", torch.empty(
            out_f, in_f, dtype=torch.int8, device=meta))
        self.register_buffer("weight_scale", torch.empty(out_f, device=meta))
        self.register_buffer("bias", torch.empty(out_f, device=meta)
                             if bias else None)

    @torch.no_grad()
    def set_float_weight_(self, w: torch.Tensor, b: torch.Tensor | None):
        q, s = quantize_weight(w)
        self.weight_q.copy_(q)
        self.weight_scale.copy_(s)
        if self.bias is not None:
            self.bias.copy_(b if b is not None else torch.zeros_like(s))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = int8_matmul(x, self.weight_q, self.weight_scale,
                          self.compute_dtype)
        if self.bias is not None:
            out = out + self.bias.to(self.compute_dtype)
        return out


def quantize_state_dict_like(float_sd: Mapping[str, torch.Tensor],
                             qmodule: nn.Module) -> dict:
    """A float state_dict mapped onto ``qmodule``'s keys: wherever
    ``qmodule`` has a ``QuantDense`` at ``p``, ``p.weight`` is quantized
    into ``p.weight_q`` / ``p.weight_scale`` (``p.bias`` kept, f32);
    every other entry passes through, cast to ``qmodule``'s dtype for it
    (``topiaxl/ops/int8.py:quantize_params_like``)."""
    quant = {name for name, m in qmodule.named_modules()
             if isinstance(m, QuantDense)}
    target = qmodule.state_dict()
    sd: dict = {}
    for key, t in target.items():
        prefix, dot, leaf = key.rpartition(".")
        if prefix in quant and leaf == "weight_q":
            q, s = quantize_weight(float_sd[f"{prefix}{dot}weight"])
            sd[key], sd[f"{prefix}{dot}weight_scale"] = q, s
        elif not (prefix in quant and leaf == "weight_scale"):
            sd[key] = float_sd[key].to(t.dtype)
    return sd
