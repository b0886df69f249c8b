"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain twins.

The kernels replace the TPU kernels of ``topiaxl/ops/flash_attention.py``:
``csrc/flash_attn_fwd.cu`` replaces ``_flash_kernel`` (with its lse
output), ``csrc/flash_attn_bwd_sm90.cu`` replaces
``_flash_bwd_fused_kernel`` (``flash_attn_bwd``) and, in a variant
without dQ, ``_flash_bwd_dkv_kernel`` (``flash_attn_bwd_dkv``), and
``csrc/flash_attn_bwd.cu`` replaces ``_flash_bwd_dq_kernel``
(``flash_attn_bwd_dq``). Attention is bound by tensor-core FLOPs at the
DiT's shapes; the kernels keep logits out of device memory. All run on
Hopper's wgmma with TMA loads (``csrc/sm90.cuh``; see the sources'
headers for the designs). The TMA loads need every stride a multiple of
16 bytes and 16-byte-aligned bases, which ``_check_stream`` enforces.

Forward numerics, shared by kernel and plain version: logits, softmax
max and denominator in f32; probabilities rounded to the input dtype
before the P.V product with f32 accumulation; output in the input
dtype; lse = logsumexp of the scaled logits, f32 [B, H, Sq]. The kernel
applies ``scale`` to the f32 logits, where the TPU wrapper folds it into
q in bf16 (``flash_attention.py:238``); the two differ by at most one
bf16 rounding of q.

Backward numerics (``flash_attention_bwd_plain``): p = exp(logits *
scale - lse) in f32; delta = rowsum(dO * o) in f32
(``flash_attention_bwd_delta``); P rounded to the input dtype for dv;
dS = p * (dP - delta) rounded to the input dtype for dq and dk; f32
accumulation; the scale applied to dq and dk. The two passes of the
pair have plain twins of their own (``flash_attention_bwd_dq_plain``,
``flash_attention_bwd_dkv_plain``) that take delta as the TPU kernels
do; the dq pass writes delta to an f32 [B, H, Sq] scratch and the dk/dv
pass, launched after it on the same stream, reads it in place of o. Two
planted faults let the kernel checks show that their bars see a wrong
gradient: the backward without delta (moves dq, dk) and the pair with
padded keys left unmasked (``flash_attention_bwd_unmasked``, moves dv
too).

Which backward runs is a shape rule, as in the JAX package
(``_select_fused_chunk``): the single-pass kernel when the whole KV is
one block of at most ``FUSED_BWD_MAX_KEYS`` keys (the DiT's self- and
cross-attention), the two-pass dq + dk/dv pair otherwise.

Head dims: each kernel has an instance for every D in ``HEAD_DIMS``. The
launchers take any D from 1 to 128: they zero-pad q, k, v (and o, dO)
in D up to the next instance (``kernel_head_dim``), launch, and slice o,
dq, dk and dv back to D, as the JAX wrapper pads D (``_fold``). The
padded columns add zero to every logit and every row sum, so o, lse and
the gradients are those of the unpadded call; the scale is always the
caller's, never recomputed from the padded D. A D above 128 raises.
"""

from __future__ import annotations

import torch

from . import _cuda

# the head dims each kernel is built for (csrc/flash_attn_*.cu)
HEAD_DIMS = (64, 72, 80, 96, 128)
# keys per K/V tile of every flash kernel (kBlockN: the forward, the dq
# pass, and the KV block of the single pass and the dk/dv pass), which
# the planted unmasked-padding faults pad Sk to
KEY_TILE = 128
FUSED_BWD_MAX_KEYS = 2048


def kernel_head_dim(d: int) -> int | None:
    """The instance a head dim ``d`` runs on: the smallest of ``HEAD_DIMS``
    at or above it (the launchers zero-pad up to it), None above 128."""
    return next((inst for inst in HEAD_DIMS if d <= inst), None)


def _instance(d: int) -> int:
    inst = kernel_head_dim(d)
    if inst is None:
        raise ValueError(f"flash_attention kernel: head_dim {d} is above "
                         f"{HEAD_DIMS[-1]}, the widest instance of {HEAD_DIMS}")
    return inst


def _pad_d(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` [..., D] zero-padded to [..., d] (contiguous)."""
    return torch.nn.functional.pad(t, (0, d - t.shape[-1]))


def bwd_form(sk: int) -> str:
    """``"fused"`` (one pass, dq reduced into f32) or ``"two_pass"`` (dq pass +
    dk/dv pass) for a key length ``sk``."""
    return "fused" if sk <= FUSED_BWD_MAX_KEYS else "two_pass"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, return_lse: bool = False):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D] (and the lse
    [B, H, Sq] f32 with ``return_lse``), materialising the f32 logits (the
    counterpart of ``topiaxl.ops.attention``'s einsum path, which computes
    the same function)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    out = out.to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_unmasked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, return_lse: bool = False):
    """A planted fault for the kernel checks: the plain version over K/V
    zero-padded to the kernel's tile with the padding left unmasked, which
    is what a kernel that dropped its ``col < Sk`` test would compute."""
    pad = -k.shape[1] % KEY_TILE
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return flash_attention_plain(q, k, v, scale, return_lse)


def flash_attention_bwd_delta(o, do):
    """delta = rowsum(dO * o) in f32, [B, H, Sq]: the term the backward
    subtracts from dP (the JAX two-pass wrapper's ``delta``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def _bwd_p_ds(q, k, v, lse, delta, do, scale):
    """(p, dS) [B, H, Sq, Sk] in f32, dS rounded to the input dtype;
    ``delta`` None leaves the term out."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if delta is not None:
        dp = dp - delta.float()[..., None]
    return p, (p * dp).to(q.dtype).float()


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float,
                              with_delta: bool = True):
    """(dq, dk, dv) of ``flash_attention`` from the saved o and lse,
    materialising P. ``with_delta=False`` is a planted fault for the
    kernel checks: dS without the ``- delta`` term, what a kernel that
    dropped its rowsum(dO * o) would compute."""
    dt = q.dtype
    delta = flash_attention_bwd_delta(o, do) if with_delta else None
    p, ds = _bwd_p_ds(q, k, v, lse, delta, do, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale: float):
    """dq of the two-pass backward's dq pass, from lse and delta [B, H,
    Sq] f32 (the counterpart of ``_flash_bwd_dq_kernel``)."""
    _, ds = _bwd_p_ds(q, k, v, lse, delta, do, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of the two-pass backward's dk/dv pass, from lse and delta
    [B, H, Sq] f32 (the counterpart of ``_flash_bwd_dkv_kernel``)."""
    dt = q.dtype
    p, ds = _bwd_p_ds(q, k, v, lse, delta, do, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(dt), dv.to(dt)


def flash_attention_bwd_unmasked(q, k, v, do, scale: float):
    """A planted fault for the backward checks that moves dv: (dq, dk, dv)
    of a forward and backward that leave the kernel's zero-padded keys
    unmasked. The padded keys take softmax mass from the real ones, so P
    shrinks and dv with it (by about the padded keys' share of the mass);
    with no padded keys it is the plain backward."""
    n = k.shape[1]
    pad = -n % KEY_TILE
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    o, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    return dq, dk[:, :n], dv[:, :n]


def _check_stream(name, t):
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name}: last dim must be contiguous and the "
                         f"other strides multiples of 8, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check(q, k, v):
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q [B,Sq,H,D], k/v [B,Sk,H,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim "
                         f"{HEAD_DIMS}, got {D}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_stream(name, t)


def _forward(q, k, v, scale, return_lse):
    """(o, lse or None): the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if q.device.type == "cpu":
        if return_lse:
            return flash_attention_plain(q, k, v, scale, return_lse=True)
        return flash_attention_plain(q, k, v, scale), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    D, inst = q.shape[-1], _instance(q.shape[-1])
    if inst != D:
        if not k.shape[-1] == v.shape[-1] == D:
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                             f"{tuple(v.shape)} disagree in head_dim")
        o, lse = _forward(*(_pad_d(t, inst) for t in (q, k, v)), scale,
                          return_lse)
        return o[..., :D].contiguous(), lse
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with _cuda.on_device(q):
        rc = _cuda.library().topiaxl_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, H, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(scale), _cuda.stream_of(q))
    _cuda.check(rc, "flash_attn_fwd")
    _cuda.count_launch("flash_attn_fwd")
    return o, lse


def _bwd_launch(name, q, k, v, o, lse, do, delta, dq, dk, dv, scale):
    B, Sq, H, D = q.shape
    with _cuda.on_device(q):
        rc = getattr(_cuda.library(), f"topiaxl_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), *(0 if t is None else t.data_ptr()
                                             for t in (delta, dq, dk, dv)),
            B, H, Sq, k.shape[1], D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
            float(scale), _cuda.stream_of(q))
    _cuda.check(rc, name)
    _cuda.count_launch(name)


def flash_attention_backward(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) from the forward's o and lse. CPU tensors take the
    plain version; CUDA tensors launch the kernels (``bwd_form`` picks
    which) or raise. Gradients come back contiguous [B, S, H, D]."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    D, inst = q.shape[-1], _instance(q.shape[-1])
    if inst != D:
        if not (k.shape[-1] == v.shape[-1] == D
                and o.shape == do.shape == q.shape):
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)}, o {tuple(o.shape)} and do "
                             f"{tuple(do.shape)} disagree")
        grads = flash_attention_backward(
            *(_pad_d(t, inst) for t in (q, k, v, o)), lse, _pad_d(do, inst),
            scale)
        return tuple(g[..., :D].contiguous() for g in grads)
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: expected {q.dtype} {tuple(q.shape)} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        _check_stream(name, t)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse: expected contiguous f32 [{B}, {H}, {Sq}] on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} "
                         f"{lse.stride()} on {lse.device}")
    dk = torch.empty((B, Sk, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if bwd_form(Sk) == "fused":
        dq_acc = torch.zeros((B, Sq, H, D), dtype=torch.float32,
                             device=q.device)
        _bwd_launch("flash_attn_bwd", q, k, v, o, lse, do, None, dq_acc, dk,
                    dv, scale)
        return dq_acc.to(q.dtype), dk, dv
    # the dq pass writes delta, the dk/dv pass (after it, on the same
    # stream) reads it
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attn_bwd_dq", q, k, v, o, lse, do, delta, dq, None,
                None, scale)
    _bwd_launch("flash_attn_bwd_dkv", q, k, v, o, lse, do, delta, None, dk,
                dv, scale)
    return dq, dk, dv


@torch.library.custom_op("topiaxl_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of the differentiable forward as a registered op, so that a
    selective-checkpoint policy can name it and keep its outputs (the
    counterpart of ``checkpoint_name(out, "flash_out")`` and ``"flash_lse"``
    in ``topiaxl/ops/flash_attention.py:_fwd``). CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise (``_forward``)."""
    return _forward(q, k, v, scale, return_lse=True)


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse), as ``topiaxl``'s ``_fwd`` does;
    backward runs ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do.to(q.dtype).contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D], differentiable.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16, any head_dim up to 128, zero-padded to an instance; any strides
    with a contiguous last dim) or raise. Under autograd with an input that
    needs a gradient the forward (the op ``flash_fwd``) also writes the lse
    and the backward runs the backward kernels; without one the kernel is
    launched directly, without the op's dispatch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, return_lse=False)[0]
