"""Multi-head attention over [B, S, H, D] tensors.

Counterpart of ``topiaxl/ops/attention.py``. The dispatch is a shape
rule, as in the JAX package: the flash kernel when the key sequence is
long enough for the logits to matter (``Sk >= 512``) and the head is
wide enough (``D >= 64``): the DiT's self- and cross-attention and
DINOv2's, at any head dim the kernels take (up to 128). Otherwise (the
VAE's 64-voxel volume attention) the einsum form, which never used a
kernel on the TPU either.

``backend="ring"`` runs ``ops/ring_attention.ring_attention`` over the
ranks of ``group``: the tokens are sharded over them (context
parallelism, ``parallel/context.py``); only self-attention takes it.

Scale note: the reference's cross-attention pre-multiplies q by
``head_dim**-0.5`` on top of the attention's own ``head_dim**-0.5``, so
callers pass ``scale=head_dim**-1`` there (``models/layers.py``).
"""

from __future__ import annotations

import torch

from .flash_attention import (flash_attention, flash_attention_plain,
                              kernel_head_dim)


def use_flash(sk: int, head_dim: int) -> bool:
    """The JAX package's rule (``Sk >= 512`` and ``D >= 64``), restricted to
    the head dims the kernel launchers take (up to 128, zero-padded to an
    instance: ``flash_attention.kernel_head_dim``); a wider head takes the
    einsum form, as a narrower one does."""
    return sk >= 512 and head_dim >= 64 and kernel_head_dim(head_dim) is not None


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None, backend: str = "auto",
                         group=None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D]; f32 softmax,
    output in the input dtype. ``backend`` "auto" (the shape rule) or
    "ring" (tokens sharded over ``group``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if backend == "ring":
        from .ring_attention import ring_attention

        return ring_attention(q, k, v, scale, group)
    if backend != "auto":
        raise ValueError(f"backend={backend!r}: expected 'auto' or 'ring'")
    if use_flash(k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
