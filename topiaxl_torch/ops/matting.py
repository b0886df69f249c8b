"""Foreground matting for input photos (counterpart of
``topiaxl/ops/matting.py``).

* ``U2NetMatting`` / ``load_u2net``: the learned matting rembg runs, the
  U^2-Net of ``models/matting_u2net.py`` on an official torch ``.pth``,
  with rembg's pre- and post-processing (320^2 ImageNet-normalised input,
  min-max rescaled saliency as alpha).
* ``remove_background``: GrabCut initialised with the image border as
  definite background (a copy of the JAX package's, numpy + cv2);
  degenerate mattes (near-empty or near-full) return None so callers can
  fall back further.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_U2NET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_U2NET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class U2NetMatting:
    """A U^2-Net (eval mode, on its device), callable rgb [H, W, 3] uint8
    -> alpha [H, W] uint8."""

    def __init__(self, model: torch.nn.Module, input_size: int = 320):
        self.model = model.eval()
        self.input_size = input_size

    @torch.inference_mode()
    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        import cv2

        h, w = rgb.shape[:2]
        s = self.input_size
        # rembg preprocessing: scale by the image's max, ImageNet-normalise
        im = cv2.resize(rgb, (s, s), interpolation=cv2.INTER_LINEAR)
        im = im.astype(np.float32) / max(float(im.max()), 1e-6)
        im = (im - _U2NET_MEAN) / _U2NET_STD
        x = torch.from_numpy(np.ascontiguousarray(im.transpose(2, 0, 1)))
        dev = next(self.model.parameters()).device
        pred = self.model(x[None].to(dev))[0, 0].float().cpu().numpy()
        # rembg postprocessing: min-max rescale to [0, 1]
        lo, hi = float(pred.min()), float(pred.max())
        pred = (pred - lo) / max(hi - lo, 1e-8)
        alpha = cv2.resize(pred, (w, h), interpolation=cv2.INTER_LINEAR)
        return (alpha * 255).astype(np.uint8)


def load_u2net(path: str, arch: str | None = None,
               device="cuda") -> U2NetMatting | None:
    """The matting of a torch U^2-Net state_dict file (the official
    ``u2net.pth`` / ``u2netp.pth`` layout), on ``device``; None when
    ``path`` is empty or names nothing. The architecture comes from the
    width of ``stage2.rebnconv1`` (16 in u2netp) unless ``arch`` names it.
    A directory (a converted orbax tree) raises: the port reads no orbax."""
    from ..models.matting_u2net import U2Net

    if not path or not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise ValueError(
            f"u2net checkpoint {path!r} is a directory (an orbax tree?): the "
            f"port reads U^2-Net weights from a torch .pth file only")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if arch is None:
        mid = sd["stage2.rebnconv1.conv_s1.weight"].shape[0]
        arch = "u2netp" if mid == 16 else "u2net"
    model = U2Net(arch)
    model.load_state_dict(sd, strict=True)
    return U2NetMatting(model.to(device))


def remove_background(
    rgb: np.ndarray,
    iterations: int = 5,
    border_frac: float = 0.04,
    feather: int = 2,
) -> np.ndarray | None:
    """Estimate a foreground alpha for an RGB uint8 image [H, W, 3].

    Returns alpha [H, W] uint8, or None when segmentation degenerates
    (no clear foreground object).
    """
    import cv2

    h, w = rgb.shape[:2]
    if min(h, w) < 16:
        return None
    mask = np.full((h, w), cv2.GC_PR_FGD, np.uint8)
    b = max(2, int(round(min(h, w) * border_frac)))
    mask[:b] = cv2.GC_BGD
    mask[-b:] = cv2.GC_BGD
    mask[:, :b] = cv2.GC_BGD
    mask[:, -b:] = cv2.GC_BGD

    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    try:
        cv2.grabCut(bgr, mask, None, bgd, fgd, iterations,
                    cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return None

    fg = ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.uint8)
    frac = float(fg.mean())
    if frac < 0.005 or frac > 0.95:
        return None

    # keep the largest connected component (stray blobs are background
    # texture GrabCut got wrong)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(fg, 8)
    if n > 2:
        biggest = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        fg = (labels == biggest).astype(np.uint8)

    alpha = (fg * 255).astype(np.uint8)
    if feather > 0:
        k = 2 * feather + 1
        alpha = cv2.GaussianBlur(alpha, (k, k), 0)
        # keep the core fully opaque; only the boundary softens
        alpha = np.where(cv2.erode(fg, np.ones((k, k), np.uint8)) > 0,
                         255, alpha).astype(np.uint8)
    return alpha
