"""Per-head RMS normalisation of attention queries and keys: the CUDA
kernels' wrappers and their plain twins, in two forms chosen by ``form``.

``"l2"`` (TRELLIS's ``MultiHeadRMSNorm``): ``y = x / max(||x||, 1e-12) *
gamma[h] * scale`` over the last dim of x [B, N, H, D], gamma [H, D]; the
model passes ``scale = sqrt(D)``. ``"rms"`` (FLUX's ``RMSNorm`` in its
``QKNorm``, which Hunyuan3D-2's shape DiT runs): ``y = x * rsqrt(mean(x^2)
+ 1e-6) * gamma[h] * scale``, the epsilon inside the mean; the model
passes scale 1 and its one gain vector [D] expanded to [H, D] (autograd
sums its gradient over the heads). The kernels
(``csrc/qk_rmsnorm.cu``) replace no TPU kernel (the JAX package has no QK
norm): left to eager PyTorch the norm is some ten elementwise launches a
call, each a pass over the tensor. They are bound by device-memory bytes;
see the source's header for the design.

Numerics, shared by kernels and plain versions: the norm, the division
and the gains in f32, one rounding of each output to x's dtype (bf16 on
the card). The backward (``qk_rms_norm_bwd_plain``) gives dx and the f32
dgamma [H, D]. In the l2 form, with n = max(||x||, 1e-12), xh = x / n and
g = gamma * scale * dy: dx = (g - xh <xh, g>) / n (the projection dropped
where the clamp holds). In the rms form, with r = rsqrt(mean(x^2) +
1e-6), xh = x r: dx = r (g - xh <xh, g> / D). In both, dgamma = scale *
sum over rows of dy * xh. The kernel sums dgamma in per-block partials
that the wrapper adds in a fixed order.

The forward reads x in place (any strides with a contiguous last dim, as
the q and k heads of a fused qkv projection lie) and writes y contiguous
[B, N, H, D], ready for flash attention. Under autograd with an input
that needs a gradient, ``qk_rms_norm`` runs through a
``torch.autograd.Function`` whose backward is the backward kernel (its
plain twin on the CPU). Launches count in ``_cuda.launches`` as
``qk_rmsnorm`` and ``qk_rmsnorm_bwd`` (l2), ``qk_rmsnorm_rms`` and
``qk_rmsnorm_rms_bwd`` (rms).
"""

from __future__ import annotations

import torch

from . import _cuda

EPS = 1e-12        # the l2 form's clamp of ||x||
RMS_EPS = 1e-6     # the rms form's epsilon, inside the mean
# the forms' (forward, backward) library functions and launch counters' keys
_NAMES = {"l2": ("qk_rmsnorm", "qk_rmsnorm_bwd"),
          "rms": ("qk_rmsnorm_rms", "qk_rmsnorm_rms_bwd")}


def _form(form: str) -> str:
    if form not in _NAMES:
        raise ValueError(f"qk_rms_norm: form {form!r}, expected one of "
                         f"{tuple(_NAMES)}")
    return form


def qk_rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor, scale: float,
                      form: str = "l2") -> torch.Tensor:
    """x [B, N, H, D], gamma [H, D] -> [B, N, H, D] in x's dtype."""
    x32 = x.float()
    if _form(form) == "rms":
        r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + RMS_EPS)
        return (x32 * r * gamma.float() * scale).to(x.dtype)
    n = x32.norm(dim=-1, keepdim=True).clamp_min(EPS)
    return (x32 / n * gamma.float() * scale).to(x.dtype)


def qk_rms_norm_bwd_plain(x, dy, gamma, scale: float, form: str = "l2"):
    """(dx in x's dtype, dgamma [H, D] f32) of ``qk_rms_norm_plain``."""
    x32 = x.float()
    dy32 = dy.float()
    g = dy32 * gamma.float() * scale
    if _form(form) == "rms":
        r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + RMS_EPS)
        xh = x32 * r
        dot = (xh * g).mean(-1, keepdim=True)
        dx = r * (g - xh * dot)
    else:
        norm = x32.norm(dim=-1, keepdim=True)
        n = norm.clamp_min(EPS)
        xh = x32 / n
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


def _forward(x, gamma, scale, form="l2"):
    if x.device.type == "cpu":
        return qk_rms_norm_plain(x, gamma, scale, form)
    if x.device.type != "cuda":
        raise ValueError(f"qk_rms_norm: no kernel for device {x.device}")
    _check(x, gamma)
    B, N, H, D = x.shape
    name = _NAMES[_form(form)][0]
    y = torch.empty((B, N, H, D), dtype=x.dtype, device=x.device)
    with _cuda.on_device(x):
        rc = getattr(_cuda.library(), f"topiaxl_{name}")(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), B, N, H, D,
            *x.stride()[:3], float(scale), _cuda.stream_of(x))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return y


def _backward(x, dy, gamma, scale, form="l2"):
    if x.device.type == "cpu":
        return qk_rms_norm_bwd_plain(x, dy, gamma, scale, form)
    if x.device.type != "cuda":
        raise ValueError(f"qk_rms_norm: no kernel for device {x.device}")
    _check(x, gamma)
    B, N, H, D = x.shape
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"qk_rms_norm backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    name = _NAMES[_form(form)][1]
    dy = dy.contiguous()
    dx = torch.empty((B, N, H, D), dtype=x.dtype, device=x.device)
    with _cuda.on_device(x):
        lib = _cuda.library()
        blocks = lib.topiaxl_qk_rmsnorm_bwd_blocks(
            B, N, H, D, torch.cuda.get_device_properties(
                x.device).multi_processor_count)
        part = torch.empty((max(blocks, 1), H, D), dtype=torch.float32,
                           device=x.device)
        rc = getattr(lib, f"topiaxl_{name}")(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            part.data_ptr(), blocks, B, N, H, D, *x.stride()[:3],
            float(scale), _cuda.stream_of(x))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return dx, part.sum(0)


class _QKRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, scale, form):
        ctx.save_for_backward(x, gamma)
        ctx.scale, ctx.form = scale, form
        return _forward(x, gamma, scale, form)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = _backward(x, dy.to(x.dtype), gamma, ctx.scale, ctx.form)
        return dx, dgamma.to(gamma.dtype), None, None


def qk_rms_norm(x: torch.Tensor, gamma: torch.Tensor, scale: float,
                form: str = "l2") -> torch.Tensor:
    """x [B, N, H, D] (any strides, last dim contiguous), gamma [H, D] ->
    y [B, N, H, D] contiguous in x's dtype, in ``form`` "l2" or "rms"
    (module docstring). CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 x, f32 gamma, D / 8 a power of two up to 32)
    or raise. Differentiable in x and gamma."""
    _form(form)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _QKRMSNorm.apply(x, gamma, scale, form)
    return _forward(x, gamma, scale, form)
