"""VGG19 feature slices and the masked perceptual loss (counterpart of
``topiaxl/models/vgg.py``).

``VGG19Features`` is torchvision's ``vgg19().features`` up to the conv at
index 34 (the same indices, so a torchvision ``state_dict`` loads as it
is, ``load_vgg19``), run in NCHW with ``F.conv2d`` / ``F.max_pool2d`` in
f32. It takes [B, H, W, 3] in [0, 1] (the caller normalises, as the
reference does) and returns the five maps that end at torchvision
indices 2, 7, 16, 25 and 34, as the JAX module does (NCHW here, NHWC
there: ``vgg_loss_masked`` takes per-slice means, which do not depend on
the layout). The JAX module computes these outside any kernel too.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import META, default_init_, materialize_

_SLICE_ENDS = (2, 7, 16, 25, 34)
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512]


def _conv_indices() -> list[int]:
    """torchvision indices of the 16 convs (a conv and its ReLU take two,
    a pool one)."""
    out, i = [], 0
    for item in _CFG:
        if item == "M":
            i += 1
        else:
            out.append(i)
            i += 2
    return out


class VGG19Features(nn.ModuleDict):
    """The convs of ``vgg19().features`` under their torchvision indices."""

    def __init__(self, device=None, generator: torch.Generator | None = None):
        convs, cin = {}, 3
        widths = [c for c in _CFG if c != "M"]
        for idx, cout in zip(_conv_indices(), widths):
            convs[str(idx)] = nn.Conv2d(cin, cout, 3, padding=1, device=META)
            cin = cout
        super().__init__(convs)
        materialize_(self, device, generator, default_init_)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [B, H, W, 3] -> five feature maps [B, C, h, w] (f32)."""
        x = x.float().permute(0, 3, 1, 2)
        outs, i = [], 0
        for item in _CFG:
            if i == _SLICE_ENDS[-1]:
                break   # the last conv feeds no slice
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                i += 1
            else:
                conv = self[str(i)]
                x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
                i += 2
            if i in _SLICE_ENDS:
                outs.append(x)
        return outs


def load_vgg19(sd: Mapping, device=None) -> VGG19Features:
    """``VGG19Features`` holding a torchvision ``vgg19().features``
    state_dict (or a path to one saved with ``torch.save``), strictly for
    the 16 convs (the counterpart of ``convert_vgg19``)."""
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    model = VGG19Features(device=device)
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.split(".")[0] in model})
    return model.eval()


def vgg_from_jax(tree: Mapping) -> dict:
    """A ``VGG19Features`` tree (``convert_vgg19``'s layout: ``conv<i>``
    kernels [3, 3, in, out]) as the port's state_dict."""
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for idx in _conv_indices():
        q = p[f"conv{idx}"]
        sd[f"{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(q["kernel"], np.float32).transpose(3, 2, 0, 1)))
        sd[f"{idx}.bias"] = torch.from_numpy(np.array(q["bias"], np.float32))
    return sd


def vgg_loss_masked(features_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor,
                    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
                    ) -> torch.Tensor:
    """Weighted mean |f(x * mask) - f(y * mask)| over the feature slices
    (reference dva/vgg.py:52-90). x, y [B, H, W, 3]; mask [B, H, W, 1]."""
    fx = features_fn(x * mask)
    fy = features_fn(y * mask)
    total = torch.zeros((), device=x.device)
    for w, a, b in zip(weights, fx, fy):
        total = total + w * (a - b).abs().mean()
    return total
