"""Per-head RMS normalisation of attention queries and keys (TRELLIS's
``MultiHeadRMSNorm``): the CUDA kernels' wrappers and their plain twins.

``y = x / max(||x||, 1e-12) * gamma[h] * scale`` over the last dim of x
[B, N, H, D], gamma [H, D]; the model passes ``scale = sqrt(D)``. The
kernels (``csrc/qk_rmsnorm.cu``) replace no TPU kernel (the JAX package
has no QK norm): left to eager PyTorch the norm is some ten elementwise
launches a call, each a pass over the tensor. They are bound by
device-memory bytes; see the source's header for the design.

Numerics, shared by kernels and plain versions: the norm, the division
and the gains in f32, one rounding of each output to x's dtype (bf16 on
the card). The backward (``qk_rms_norm_bwd_plain``) gives dx and the f32
dgamma [H, D]: with n = max(||x||, 1e-12), xh = x / n and g = gamma *
scale * dy, dx = (g - xh <xh, g>) / n (the projection dropped where the
clamp holds), dgamma = scale * sum over rows of dy * xh. The kernel sums
dgamma in per-block partials that the wrapper adds in a fixed order.

The forward reads x in place (any strides with a contiguous last dim, as
the q and k heads of a fused qkv projection lie) and writes y contiguous
[B, N, H, D], ready for flash attention. Under autograd with an input
that needs a gradient, ``qk_rms_norm`` runs through a
``torch.autograd.Function`` whose backward is the backward kernel (its
plain twin on the CPU). Launches count as ``qk_rmsnorm`` and
``qk_rmsnorm_bwd`` in ``_cuda.launches``.
"""

from __future__ import annotations

import torch

from . import _cuda

EPS = 1e-12


def qk_rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """x [B, N, H, D], gamma [H, D] -> [B, N, H, D] in x's dtype."""
    x32 = x.float()
    n = x32.norm(dim=-1, keepdim=True).clamp_min(EPS)
    return (x32 / n * gamma.float() * scale).to(x.dtype)


def qk_rms_norm_bwd_plain(x, dy, gamma, scale: float):
    """(dx in x's dtype, dgamma [H, D] f32) of ``qk_rms_norm_plain``."""
    x32 = x.float()
    norm = x32.norm(dim=-1, keepdim=True)
    n = norm.clamp_min(EPS)
    xh = x32 / n
    dy32 = dy.float()
    g = dy32 * gamma.float() * scale
    dot = (xh * g).sum(-1, keepdim=True) * (norm > EPS)
    dx = (g - xh * dot) / n
    return dx.to(x.dtype), scale * (dy32 * xh).sum(dim=(0, 1))


def _check(x, gamma):
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"qk_rms_norm kernel: x must be bf16 [B, N, H, D], "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, N, H, D = x.shape
    L = D // 8
    if D % 8 or not 0 < L <= 32 or L & (L - 1):
        raise ValueError(f"qk_rms_norm kernel: D={D} must be 8 times a power "
                         f"of two up to 256")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"qk_rms_norm kernel: x needs a contiguous last dim, "
                         f"the other strides multiples of 8 and a 16-byte "
                         f"aligned base; got {x.stride()}")
    if (gamma.dtype != torch.float32 or tuple(gamma.shape) != (H, D)
            or not gamma.is_contiguous() or gamma.device != x.device):
        raise ValueError(f"qk_rms_norm kernel: gamma must be contiguous f32 "
                         f"[{H}, {D}] on {x.device}, got {gamma.dtype} "
                         f"{tuple(gamma.shape)} on {gamma.device}")


def _forward(x, gamma, scale):
    if x.device.type == "cpu":
        return qk_rms_norm_plain(x, gamma, scale)
    if x.device.type != "cuda":
        raise ValueError(f"qk_rms_norm: no kernel for device {x.device}")
    _check(x, gamma)
    B, N, H, D = x.shape
    y = torch.empty((B, N, H, D), dtype=x.dtype, device=x.device)
    with _cuda.on_device(x):
        rc = _cuda.library().topiaxl_qk_rmsnorm(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), B, N, H, D,
            *x.stride()[:3], float(scale), _cuda.stream_of(x))
    _cuda.check(rc, "qk_rmsnorm")
    _cuda.count_launch("qk_rmsnorm")
    return y


def _backward(x, dy, gamma, scale):
    if x.device.type == "cpu":
        return qk_rms_norm_bwd_plain(x, dy, gamma, scale)
    if x.device.type != "cuda":
        raise ValueError(f"qk_rms_norm: no kernel for device {x.device}")
    _check(x, gamma)
    B, N, H, D = x.shape
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"qk_rms_norm backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    dy = dy.contiguous()
    dx = torch.empty((B, N, H, D), dtype=x.dtype, device=x.device)
    with _cuda.on_device(x):
        lib = _cuda.library()
        blocks = lib.topiaxl_qk_rmsnorm_bwd_blocks(
            B, N, H, D, torch.cuda.get_device_properties(
                x.device).multi_processor_count)
        part = torch.empty((max(blocks, 1), H, D), dtype=torch.float32,
                           device=x.device)
        rc = lib.topiaxl_qk_rmsnorm_bwd(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            part.data_ptr(), blocks, B, N, H, D, *x.stride()[:3],
            float(scale), _cuda.stream_of(x))
    _cuda.check(rc, "qk_rmsnorm_bwd")
    _cuda.count_launch("qk_rmsnorm_bwd")
    return dx, part.sum(0)


class _QKRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, scale):
        ctx.save_for_backward(x, gamma)
        ctx.scale = scale
        return _forward(x, gamma, scale)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = _backward(x, dy.to(x.dtype), gamma, ctx.scale)
        return dx, dgamma.to(gamma.dtype), None


def qk_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                scale: float) -> torch.Tensor:
    """x [B, N, H, D] (any strides, last dim contiguous), gamma [H, D] ->
    y [B, N, H, D] contiguous in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 x, f32 gamma, D / 8 a
    power of two up to 32) or raise. Differentiable in x and gamma."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _QKRMSNorm.apply(x, gamma, scale)
    return _forward(x, gamma, scale)
