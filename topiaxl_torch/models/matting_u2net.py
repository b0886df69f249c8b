"""U^2-Net salient-object matting (counterpart of
``topiaxl/models/matting_u2net.py``; Qin et al. 2020), NCHW.

The network rembg runs: nested U-structure of RSU blocks. Module and
parameter names are the official ones (``stage1.rebnconvin.conv_s1``,
``bn_s1``, ``side1..6``, ``outconv``), so an official ``.pth`` loads with
``strict=True``. BatchNorm stays its own module (the JAX package folds it
into each conv when converting): the two agree in eval mode, the mode
this module is served in. Two published configurations: ``u2net`` (full,
~44M parameters) and ``u2netp`` (~1.1M). Input: ImageNet-normalised
[B, 3, H, W]; output: the fused d0 saliency map [B, 1, H, W] in [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (rsu_height, in_ch, mid_ch, out_ch) per encoder / decoder stage; height
# 0 is the dilated RSU-4F
_FULL = {
    "enc": [(7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256),
            (4, 256, 128, 512), (0, 512, 256, 512), (0, 512, 256, 512)],
    "dec": [(0, 1024, 256, 512), (4, 1024, 128, 256), (5, 512, 64, 128),
            (6, 256, 32, 64), (7, 128, 16, 64)],
    "side_ch": [64, 64, 128, 256, 512, 512],
}
_SMALL = {
    "enc": [(7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64),
            (4, 64, 16, 64), (0, 64, 16, 64), (0, 64, 16, 64)],
    "dec": [(0, 128, 16, 64), (4, 128, 16, 64), (5, 128, 16, 64),
            (6, 128, 16, 64), (7, 128, 16, 64)],
    "side_ch": [64, 64, 64, 64, 64, 64],
}
CONFIGS = {"u2net": _FULL, "u2netp": _SMALL}


class REBNCONV(nn.Module):
    """conv3x3 (dilated) -> BatchNorm -> relu."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _pool(x):
    return F.max_pool2d(x, 2, stride=2, ceil_mode=True)


def _up_to(x, like):
    """Bilinear with half-pixel centres to ``like``'s size."""
    if x.shape[2:] == like.shape[2:]:
        return x
    return F.interpolate(x, size=like.shape[2:], mode="bilinear",
                         align_corners=False)


class RSU(nn.Module):
    """Residual U-block of height L (RSU-7 .. RSU-4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        L = self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, L):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{L}", REBNCONV(mid_ch, mid_ch, dirate=2))
        for i in range(L - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid_ch, mid_ch))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x):
        L = self.height
        hxin = self.rebnconvin(x)
        hs = [self.rebnconv1(hxin)]
        for i in range(2, L):
            hs.append(getattr(self, f"rebnconv{i}")(_pool(hs[-1])))
        d = getattr(self, f"rebnconv{L}")(hs[-1])
        for i in range(L - 1, 0, -1):
            d = getattr(self, f"rebnconv{i}d")(
                torch.cat([_up_to(d, hs[i - 1]), hs[i - 1]], 1))
        return d + hxin


class RSU4F(nn.Module):
    """Dilation-only RSU (no pooling): dilations 1, 2, 4, 8, then 4, 2, 1."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        return self.rebnconv1d(torch.cat([d2, h1], 1)) + hxin


def _stage(height: int, in_ch: int, mid: int, out: int) -> nn.Module:
    return RSU4F(in_ch, mid, out) if height == 0 else RSU(height, in_ch, mid,
                                                          out)


class U2Net(nn.Module):
    """U^2-Net (``arch`` 'u2net' or 'u2netp') -> sigmoid(d0)."""

    def __init__(self, arch: str = "u2net"):
        super().__init__()
        if arch not in CONFIGS:
            raise ValueError(f"arch={arch!r}: expected one of {sorted(CONFIGS)}")
        self.arch = arch
        cfg = CONFIGS[arch]
        for i, spec in enumerate(cfg["enc"]):
            setattr(self, f"stage{i + 1}", _stage(*spec))
        for i, spec in enumerate(cfg["dec"]):
            setattr(self, f"stage{5 - i}d", _stage(*spec))
        for i, ch in enumerate(cfg["side_ch"]):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        n_enc = len(CONFIGS[self.arch]["enc"])
        encs = [self.stage1(x)]
        for i in range(2, n_enc + 1):
            encs.append(getattr(self, f"stage{i}")(_pool(encs[-1])))
        d = encs[-1]
        decs = []
        for i in range(5, 0, -1):
            skip = encs[i - 1]
            d = getattr(self, f"stage{i}d")(torch.cat([_up_to(d, skip), skip], 1))
            decs.append(d)
        hx1d = decs[-1]
        sides = [self.side1(hx1d)]
        for i, h in zip(range(2, 7), decs[-2::-1] + [encs[-1]]):
            sides.append(_up_to(getattr(self, f"side{i}")(h), hx1d))
        return torch.sigmoid(self.outconv(torch.cat(sides, 1)))
