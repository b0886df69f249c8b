"""Fused LayerNorm + adaLN modulate: the CUDA kernels' wrappers and their
plain twins.

The kernels (``csrc/ln_modulate.cu``) replace the TPU kernels
``topiaxl/ops/fused_ln.py:_ln_mod_kernel`` and ``:_ln_mod_res_kernel``.
They are bound by device-memory bytes: each reads the [B, N, D] stream
once and writes it once (see the source's header for the design).

Numerics contract, shared by kernels and plain versions: affine-free LN
over the last dim with f32 mean and (two-pass) variance, eps before the
rsqrt; ``y * (1 + scale) + shift`` in f32 with per-batch [B, D]
shift/scale; one cast per output. In the residual form, h is taken from
the unrounded f32 ``x + gate * delta``.

Gradients: under autograd with an input that needs one, both functions
run through ``torch.autograd.Function``s whose forward is the kernel (or
the plain version on the CPU), called through a registered op
(``topiaxl_torch::ln_modulate`` / ``::ln_modulate_residual``, which the
``dots_plus`` remat policy keeps), and whose backward is the analytic VJP of
``topiaxl/ops/fused_ln.py:_bwd`` / ``:_res_bwd`` in plain PyTorch (f32,
one cast per gradient). On the TPU that backward is plain XLA too.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_D = 4096   # 16 vectors of 8 per lane, held in registers


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def _modulate32(y, shift, scale):
    return y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]


def ln_modulate_plain(x, shift, scale, eps: float = 1e-6, out_dtype=None):
    return _modulate32(_ln(x, eps), shift, scale).to(out_dtype or x.dtype)


def ln_modulate_residual_plain(x, delta, gate, shift, scale, eps: float = 1e-6,
                               out_dtype=None):
    xn = x.float() + gate.float()[:, None, :] * delta.float()
    h = _modulate32(_ln(xn, eps), shift, scale)
    return xn.to(x.dtype), h.to(out_dtype or x.dtype)


def _row_stride(name, t, B, D):
    """Batch stride of a [B, D] per-batch vector, checked for the kernel."""
    if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, D):
        raise ValueError(f"{name}: expected bf16 [{B}, {D}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous, 16-byte aligned, "
                         f"batch stride a multiple of 8; got {t.stride()}")
    return t.stride(0)


def _check_stream(name, t, device):
    if t.dtype != torch.bfloat16 or t.dim() != 3:
        raise ValueError(f"{name}: expected bf16 [B, N, D], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.shape[-1] % 8 or t.shape[-1] > MAX_D:
        raise ValueError(f"{name}: D={t.shape[-1]} is not a multiple of 8 "
                         f"up to {MAX_D}")


def _check_out_dtype(x, out_dtype):
    if out_dtype not in (None, x.dtype):
        raise ValueError(f"kernel writes {x.dtype}, asked for {out_dtype}")


def _ln_modulate(x, shift, scale, eps, out_dtype):
    if x.device.type == "cpu":
        return ln_modulate_plain(x, shift, scale, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ln_modulate: no kernel for device {x.device}")
    _check_stream("x", x, x.device)
    _check_out_dtype(x, out_dtype)
    B, N, D = x.shape
    for t in (shift, scale):
        if t.device != x.device:
            raise ValueError(f"shift/scale on {t.device}, x on {x.device}")
    sh_sb = _row_stride("shift", shift, B, D)
    sc_sb = _row_stride("scale", scale, B, D)
    out = torch.empty_like(x)
    with _cuda.on_device(x):
        rc = _cuda.library().topiaxl_ln_modulate(
            x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B * N, N, D, sh_sb, sc_sb, float(eps), _cuda.stream_of(x))
    _cuda.check(rc, "ln_modulate")
    _cuda.count_launch("ln_modulate")
    return out


def _ln_modulate_residual(x, delta, gate, shift, scale, eps, out_dtype):
    if x.device.type == "cpu":
        return ln_modulate_residual_plain(x, delta, gate, shift, scale, eps,
                                          out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ln_modulate_residual: no kernel for device {x.device}")
    _check_stream("x", x, x.device)
    _check_stream("delta", delta, x.device)
    _check_out_dtype(x, out_dtype)
    if delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} != x {tuple(x.shape)}")
    B, N, D = x.shape
    for t in (gate, shift, scale):
        if t.device != x.device:
            raise ValueError(f"gate/shift/scale on {t.device}, x on {x.device}")
    g_sb = _row_stride("gate", gate, B, D)
    sh_sb = _row_stride("shift", shift, B, D)
    sc_sb = _row_stride("scale", scale, B, D)
    x_out = torch.empty_like(x)
    h = torch.empty_like(x)
    with _cuda.on_device(x):
        rc = _cuda.library().topiaxl_ln_modulate_residual(
            x.data_ptr(), delta.data_ptr(), gate.data_ptr(), shift.data_ptr(),
            scale.data_ptr(), x_out.data_ptr(), h.data_ptr(), B * N, N, D,
            g_sb, sh_sb, sc_sb, float(eps), _cuda.stream_of(x))
    _cuda.check(rc, "ln_modulate_residual")
    _cuda.count_launch("ln_modulate_residual")
    return x_out, h


def _ln_bwd(xn32, g_h, scale, eps):
    """(dxn, d_shift, d_scale) in f32 of h = modulate(LN(xn)) for the f32
    pre-LN stream ``xn32`` (``topiaxl/ops/fused_ln.py:89-102``)."""
    xc = xn32 - xn32.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * inv
    gh = g_h.float()
    d_shift = gh.sum(dim=1)
    d_scale = (gh * y).sum(dim=1)
    dy = gh * (1.0 + scale.float())[:, None, :]
    dxn = inv * (dy - dy.mean(dim=-1, keepdim=True)
                 - y * (dy * y).mean(dim=-1, keepdim=True))
    return dxn, d_shift, d_scale


# the differentiable forwards as registered ops, so that a
# selective-checkpoint policy can name them and keep their outputs (the
# counterparts of the JAX block's ``checkpoint_name(h, "ln_h")`` and
# ``"resid"``, ``topiaxl/models/dit.py``); CPU tensors take the plain
# versions, CUDA tensors launch the kernels or raise


@torch.library.custom_op("topiaxl_torch::ln_modulate", mutates_args=())
def ln_modulate_op(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float, out_dtype: torch.dtype | None) -> torch.Tensor:
    return _ln_modulate(x, shift, scale, eps, out_dtype)


@torch.library.custom_op("topiaxl_torch::ln_modulate_residual",
                         mutates_args=())
def ln_modulate_residual_op(
        x: torch.Tensor, delta: torch.Tensor, gate: torch.Tensor,
        shift: torch.Tensor, scale: torch.Tensor, eps: float,
        out_dtype: torch.dtype | None) -> tuple[torch.Tensor, torch.Tensor]:
    return _ln_modulate_residual(x, delta, gate, shift, scale, eps, out_dtype)


class _LnModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale, eps, out_dtype):
        ctx.save_for_backward(x, shift, scale)
        ctx.eps = eps
        return ln_modulate_op(x, shift, scale, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, shift, scale = ctx.saved_tensors
        dx, d_shift, d_scale = _ln_bwd(x.float(), g, scale, ctx.eps)
        return (dx.to(x.dtype), d_shift.to(shift.dtype),
                d_scale.to(scale.dtype), None, None)


class _LnModulateResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, gate, shift, scale, eps, out_dtype):
        ctx.save_for_backward(x, delta, gate, shift, scale)
        ctx.eps = eps
        return ln_modulate_residual_op(x, delta, gate, shift, scale, eps,
                                       out_dtype)

    @staticmethod
    def backward(ctx, g_xn, g_h):
        """``topiaxl/ops/fused_ln.py:165-183``."""
        x, delta, gate, shift, scale = ctx.saved_tensors
        gate32, delta32 = gate.float()[:, None, :], delta.float()
        xn = x.float() + gate32 * delta32
        dxn, d_shift, d_scale = _ln_bwd(xn, g_h, scale, ctx.eps)
        if g_xn is not None:
            dxn = dxn + g_xn.float()
        return (dxn.to(x.dtype), (dxn * gate32).to(delta.dtype),
                (dxn * delta32).sum(dim=1).to(gate.dtype),
                d_shift.to(shift.dtype), d_scale.to(scale.dtype), None, None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """x [B, N, D], shift/scale [B, D] -> [B, N, D] in ``out_dtype``
    (default x.dtype). CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16, D a multiple of 8 up to MAX_D) or raise.
    Differentiable in x, shift and scale."""
    if _needs_grad(x, shift, scale):
        return _LnModulate.apply(x, shift, scale, eps, out_dtype)
    return _ln_modulate(x, shift, scale, eps, out_dtype)


def ln_modulate_residual(x, delta, gate, shift, scale, eps: float = 1e-6,
                         out_dtype=None):
    """``x_new = x + gate[:, None] * delta``, ``h = modulate(LN(x_new))``;
    returns ``(x_new, h)``. Same device rule as ``ln_modulate``;
    differentiable in all five tensors."""
    if _needs_grad(x, delta, gate, shift, scale):
        return _LnModulateResidual.apply(x, delta, gate, shift, scale, eps,
                                         out_dtype)
    return _ln_modulate_residual(x, delta, gate, shift, scale, eps, out_dtype)
