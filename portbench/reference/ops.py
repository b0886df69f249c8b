"""Products and normalisations of the reference, in float32.

``PRECISION`` is "f32" for the reference itself and "fp8" for the control:
each operand of a product rounded to float8 e4m3 with one scale a tensor
(its largest magnitude onto e4m3's 448), then multiplied in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

PRECISION = "f32"
E4M3_MAX = 448.0


@contextlib.contextmanager
def precision(name: str):
    """Run the block with products in ``name`` ("f32" or "fp8")."""
    global PRECISION
    if name not in ("f32", "fp8"):
        raise ValueError(f"precision {name!r}: expected 'f32' or 'fp8'")
    old, PRECISION = PRECISION, name
    try:
        yield
    finally:
        PRECISION = old


def no_tf32() -> None:
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def operand(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    if PRECISION == "f32":
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    # the rounded value forward, the gradient straight through
    return t + (q - t.detach())


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two dims."""
    return torch.matmul(operand(a), operand(b))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """x @ w^T + b, w [out, in] as a checkpoint holds it."""
    out = mm(x, w.float().t())
    return out if b is None else out + b.float()


def attention(q, k, v, scale: float) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D], softmax in f32."""
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(mm(q, k.transpose(-1, -2)) * scale, dim=-1)
    return mm(p, v).transpose(1, 2)


def layer_norm(x, w=None, b=None, eps: float = 1e-6):
    x = x.float()
    xc = x - x.mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        out = out * w.float()
    return out if b is None else out + b.float()


def group_norm(x, groups: int, w, b, eps: float = 1e-5):
    """x [B, C, ...] normalised over each group of channels and the rest."""
    B, C = x.shape[:2]
    g = x.float().reshape(B, groups, -1)
    g = g - g.mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return g.reshape(x.shape) * w.float().reshape(shape) + b.float().reshape(shape)


def conv3d(x, w, b=None, padding: int = 0):
    return F.conv3d(operand(x), operand(w), None if b is None else b.float(),
                    padding=padding)


def conv_transpose3d(x, w, b=None, stride: int = 1, padding: int = 0):
    return F.conv_transpose3d(operand(x), operand(w),
                              None if b is None else b.float(),
                              stride=stride, padding=padding)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))
