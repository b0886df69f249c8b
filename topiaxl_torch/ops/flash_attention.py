"""Flash-attention forward: the CUDA kernel's wrapper and its plain twin.

The kernel (``csrc/flash_attn_fwd.cu``) replaces the TPU kernel
``topiaxl/ops/flash_attention.py:_flash_kernel``. Attention is bound by
tensor-core FLOPs at the DiT's shapes; the kernel keeps logits out of
device memory and runs both products on ``mma.sync`` (see the source's
header for the design).

Numerics contract, shared by kernel and plain version: logits, softmax
max and denominator in f32; probabilities rounded to the input dtype
before the P.V product with f32 accumulation; output in the input
dtype. The kernel applies ``scale`` to the f32 logits, where the TPU
wrapper folds it into q in bf16 (``flash_attention.py:238``); the two
differ by at most one bf16 rounding of q.
"""

from __future__ import annotations

import torch

from . import _cuda

HEAD_DIMS = (64, 72)
KEY_TILE = 64   # keys per K/V tile in the kernel (kBlockN): Sk pads to this


def flash_attention_unmasked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """A planted fault for the kernel checks: the plain version over K/V
    zero-padded to the kernel's tile with the padding left unmasked, which
    is what a kernel that dropped its ``col < Sk`` test would compute."""
    pad = -k.shape[1] % KEY_TILE
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return flash_attention_plain(q, k, v, scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D], materialising
    the f32 logits (the counterpart of ``topiaxl.ops.attention``'s einsum
    path, which computes the same function)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


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
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: last dim must be contiguous and the "
                             f"other strides multiples of 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D].

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16, head_dim 64 or 72, any strides with a contiguous last dim) or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lib = _cuda.library()
    rc = lib.topiaxl_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], float(scale), _cuda.stream_of(q))
    _cuda.check(rc, "flash_attn_fwd")
    _cuda.count_launch("flash_attn_fwd")
    return o
