"""Clip + AdamW + EMA over a trainer's f32 tensors in one pass: the CUDA
kernel's wrapper and its plain twin.

``adamw_ema(p, g, m, v, e, gscale, ...)`` takes lists of tensors keyed
alike (parameters, gradients, Adam's moments, the EMA) and updates p, m, v
and e in place with the JAX package's math
(``topiaxl/pipelines/train.py:fused_adamw_ema_update``'s ``leaf``):
``gf = g * gscale``, ``m' = b1 m + (1 - b1) gf``, ``v' = b2 v + (1 - b2)
gf^2``, ``u = (m' / c1) / (sqrt(v' / c2) + eps)`` (``+ wd p`` where ``wd``
is not 0), ``p' = p - lr u``, ``e' = decay e + (1 - decay) p'``. ``gscale``
is a device scalar (the clip's scale depends on the global norm, so the
host never reads it). ``g`` is left as it is.

CPU tensors take the plain version (``adamw_ema_plain``: twelve foreach
passes and three temporaries as large as the model). CUDA tensors launch
``csrc/adamw_ema.cu`` once over all of them, or raise where a tensor is
not f32, not contiguous, not on the first parameter's card or not the
size of its parameter. The kernel reads one table in device memory, built
each call (the gradients are new tensors each step): per tensor the p, g,
m, v, e pointers and its size (``param_rows``), then the work items of
``CHUNK`` elements (``work_items``). It goes over in one asynchronous copy
from pinned memory: nothing synchronises. Launches count in
``_cuda.launches["adamw_ema"]``, one a call.
"""

from __future__ import annotations

import itertools
import operator

import numpy as np
import torch

from . import _cuda

# elements a work item (one block of the kernel); csrc/adamw_ema.cu's kChunk
CHUNK = 32768


@torch.no_grad()
def adamw_ema_plain(p: list, g: list, m: list, v: list, e: list, gscale, *,
                    lr: float, c1: float, c2: float, b1: float, b2: float,
                    eps: float, wd: float, decay: float) -> None:
    gs = torch._foreach_mul(g, gscale)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gs, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, gs, gs, value=1.0 - b2)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    if wd:
        torch._foreach_add_(upd, p, alpha=wd)
    torch._foreach_add_(p, upd, alpha=-lr)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, p, alpha=1.0 - decay)


def work_items(numels) -> np.ndarray:
    """The kernel's work items over tensors of ``numels`` elements, int64
    ``tensor index << 32 | chunk index``: chunk c of a tensor covers its
    elements [c * CHUNK, min((c + 1) * CHUNK, numel)); an empty tensor has
    none."""
    numels = np.asarray(numels, dtype=np.int64)
    chunks = -(-numels // CHUNK)
    tensor = np.repeat(np.arange(len(numels), dtype=np.int64), chunks)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    return tensor << 32 | (np.arange(len(tensor), dtype=np.int64) - first)


def check_tensors(tensors, numels: np.ndarray, device: torch.device,
                  what: str) -> None:
    """Raise unless every tensor is contiguous f32 on ``device`` with the
    size its parameter has in ``numels``. One C-level pass a property over
    the list; the tensor at fault is looked for only once one is."""
    sizes = np.fromiter(map(torch.Tensor.numel, tensors), np.int64,
                        len(tensors))
    if (set(map(operator.attrgetter("dtype"), tensors)) <= {torch.float32}
            and all(map(torch.Tensor.is_contiguous, tensors))
            and set(map(operator.attrgetter("device"), tensors)) <= {device}
            and np.array_equal(sizes, numels)):
        return
    bad = [i for i, t in enumerate(tensors)
           if not (t.dtype is torch.float32 and t.is_contiguous()
                   and t.device == device and sizes[i] == numels[i])]
    t = tensors[bad[0]]
    raise ValueError(
        f"adamw_ema kernel: {what}[{bad[0]}] must be a contiguous f32 "
        f"tensor of {numels[bad[0]]} elements on {device}, got {t.dtype} "
        f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


def param_rows(p, g, m, v, e) -> np.ndarray:
    """The kernel's tensor table, int64 [n, 6]: each tensor's p, g, m, v
    and e pointers and its size."""
    n = len(p)
    rows = np.empty((n, 6), dtype=np.int64)
    rows[:, :5] = np.fromiter(
        map(torch.Tensor.data_ptr, itertools.chain(p, g, m, v, e)), np.int64,
        5 * n).reshape(5, n).T
    rows[:, 5] = np.fromiter(map(torch.Tensor.numel, p), np.int64, n)
    return rows


@torch.no_grad()
def adamw_ema(p: list, g: list, m: list, v: list, e: list, gscale, *,
              lr: float, c1: float, c2: float, b1: float, b2: float,
              eps: float, wd: float, decay: float) -> None:
    """Update p, m, v, e in place (module docstring); g untouched. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if not p:
        return
    device = p[0].device
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd, decay=decay)
    if device.type == "cpu":
        return adamw_ema_plain(p, g, m, v, e, gscale, **kw)
    if device.type != "cuda":
        raise ValueError(f"adamw_ema: no kernel for device {device}")
    if (gscale.dtype != torch.float32 or gscale.numel() != 1
            or gscale.device != device):
        raise ValueError(f"adamw_ema kernel: gscale must be one f32 on "
                         f"{device}, got {gscale.dtype} "
                         f"{tuple(gscale.shape)} on {gscale.device}")
    rows = param_rows(p, g, m, v, e)
    for what, ts in zip("pgmve", (p, g, m, v, e)):
        check_tensors(ts, rows[:, 5], device, what)
    items = work_items(rows[:, 5])
    table = torch.from_numpy(np.concatenate([rows.ravel(), items]))
    table = table.pin_memory().to(device, non_blocking=True)
    with _cuda.on_device(p[0]):
        rc = _cuda.library().topiaxl_adamw_ema(
            table.data_ptr(), table.data_ptr() + 8 * rows.size, len(items),
            gscale.data_ptr(), float(lr), float(c1), float(c2), float(b1),
            float(b2), float(eps), float(wd), float(decay),
            _cuda.stream_of(p[0]))
    _cuda.check(rc, "adamw_ema")
    _cuda.count_launch("adamw_ema")
