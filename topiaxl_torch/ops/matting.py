"""Foreground matting for input photos: GrabCut (numpy + cv2).

A JAX-free copy of ``topiaxl/ops/matting.py:remove_background`` (that
module cannot be imported without JAX, through ``topiaxl/ops/__init__``).
GrabCut is initialised with the image border as definite background;
degenerate mattes (near-empty or near-full) return None so callers can
fall back further. The learned U^2-Net matting is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
