"""What the benchmark makes from ``--seed``: weights, images and batches.

Weights: every tensor of a model's state_dict drawn from two normal draws
over their total size, on the device, from a generator seeded with the
run's seed, then scaled by ``init_rule`` and cast to the dtype the program
holds it in. The program loads them with ``load_state_dict(strict=True)``
and the reference reads the same dict by name. Random weights are enough
for speed and for agreement with the reference, with two departures from
a plain normal draw, so that the check can tell the served precision from
the one below it:

- the layers a fresh DiT zeroes (adaLN, the final projection) are filled,
  and each block's three gates are centred on ``GATE_BIAS``, so that every
  sublayer adds at full weight, as in a trained model;
- a tensor of two or more dimensions (a matrix, a kernel, DINOv2's
  tokens) carries outliers, as trained transformers' weights
  do: where the second draw exceeds ``OUTLIER_Z`` (0.1% of the entries)
  the entry is ``OUTLIER_SCALE`` times the size of the others (the tensor
  rescaled to keep its variance). Without them int8's per-channel scales
  lose almost nothing, and the program's W8A8 path read within 1.5-2.2x of
  bf16's own gap to the reference at the chain's end (PERF.md).

Images: a copy of ``topiaxl_torch/pipelines/synthetic.py:
write_bench_image`` (a synthetic object photo on white, two disks and a
square) at 518², with the shapes' places, sizes and colours drawn from
the seed, already matted.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GATE_BIAS = 1.0
OUTLIER_Z = 3.1
OUTLIER_SCALE = 16.0
# the share of a normal draw above OUTLIER_Z
_OUTLIER_SHARE = 0.5 * math.erfc(OUTLIER_Z / math.sqrt(2.0))
# the seeds of the draws of one run, apart from each other
STREAMS = {"weights": 1, "images": 2, "noise": 3, "batches": 4, "sample": 5}


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for draw ``index`` of ``stream`` in the run of ``seed``."""
    return (int(seed) * 1_000_003 + STREAMS[stream] * 7_919 * 1_000_003
            + int(index)) % (2 ** 63)


def init_rule(name: str, shape: tuple) -> tuple[float, float]:
    """(mean, std) of a tensor by its checkpoint name and shape."""
    last = name.rsplit(".", 1)[-1]
    if last == "null_cond_embedding":
        return 0.0, 1.0
    if last == "gamma":                   # DINOv2's LayerScale
        return 0.1, 0.02
    if last in ("cls_token", "register_tokens", "mask_token", "pos_embed",
                "bias"):
        return 0.0, 0.02
    if len(shape) == 1:                   # norm gains
        return 1.0, 0.02
    return 0.0, math.prod(shape[1:]) ** -0.5


@torch.no_grad()
def seeded_weights(template: dict, seed: int, device) -> dict:
    """{name: tensor} shaped and typed as the floating tensors of
    ``template`` (a state_dict), drawn from ``seed`` on ``device``."""
    names = [k for k, v in template.items() if v.is_floating_point()]
    total = sum(template[k].numel() for k in names)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    marks = torch.randn(total, generator=gen, device=device) > OUTLIER_Z
    keep_var = math.sqrt(1 + (OUTLIER_SCALE ** 2 - 1) * _OUTLIER_SHARE)
    out, off = {}, 0
    for k in names:
        t = template[k]
        z = flat[off:off + t.numel()]
        if t.dim() >= 2:
            z = z * (1 + (OUTLIER_SCALE - 1) * marks[off:off + t.numel()]) \
                / keep_var
        mean, std = init_rule(k, tuple(t.shape))
        w = z.view(t.shape) * std + mean
        if k.startswith("blocks.") and k.endswith("adaLN_modulation.1.bias"):
            w.view(9, -1)[2::3] += GATE_BIAS
        out[k] = w.to(t.dtype)
        off += t.numel()
    return out


def object_image(seed: int, index: int, size: int = 518) -> np.ndarray:
    """[size, size, 3] uint8: a disk, a square and a smaller disk on white,
    placed and coloured from (seed, index)."""
    rng = np.random.default_rng(stream_seed(seed, "images", index))
    img = np.full((size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    s = size / 512.0
    cx, cy = (256 + rng.integers(-40, 41, 2)) * s
    r = (120 + rng.integers(0, 41)) * s
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = rng.integers(0, 256, 3)
    x0, y0 = (196 + rng.integers(-30, 31, 2)) * s
    w = (100 + rng.integers(0, 41)) * s
    img[(xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + w)] = \
        rng.integers(0, 256, 3)
    r2 = (40 + rng.integers(0, 41)) * s
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r2 * r2] = rng.integers(0, 256, 3)
    return img
