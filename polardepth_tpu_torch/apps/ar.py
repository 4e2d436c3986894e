"""Depth-aware AR occlusion demo (reference L7: ar_visualization/main.py).

A copy of polardepth_tpu/apps/ar.py:1-112 (numpy, cv2, and PIL for the GIF).

From an rgb frame, an object mask, GT depth and predicted depth, composites
a logo into the scene at a chosen depth: the logo is scaled inversely with
depth, and scene pixels whose *predicted* depth is closer than the logo's
depth occlude it (the whole point of the demo — depth quality is visible as
correct occlusion boundaries).  A sweep of positions renders to an animated
GIF.

The reference's per-pixel Python loops (main.py:30-61, 156-185) are replaced
by vectorized numpy: the naked-depth infill is a right-to-left
last-valid-value propagation via a reversed cummax over column indices, and
the occlusion composite is one where().
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def create_naked_depth(depth_gt: np.ndarray, obj_mask: np.ndarray) -> np.ndarray:
    """Fill object pixels with the depth of their nearest background
    neighbour to the right (main.py:30-61).

    obj_mask: (H, W) nonzero on objects.  Vectorized: for each pixel, find
    the nearest background column index >= j and gather its depth; pixels
    with no background to the right keep their own value.
    """
    depth = np.asarray(depth_gt, np.float64).copy()
    if depth.ndim == 3:
        depth = depth[..., 0]
    m = np.asarray(obj_mask).astype(bool)
    if m.ndim == 3:
        m = m[..., 0]
    h, w = depth.shape
    cols = np.arange(w)[None, :].repeat(h, 0)
    bg_col = np.where(~m, cols, w + 1)
    # nearest background at or right of each pixel: reversed cummin
    nearest = np.minimum.accumulate(bg_col[:, ::-1], axis=1)[:, ::-1]
    has_bg = nearest <= w
    gather = np.clip(nearest, 0, w - 1)
    filled = np.take_along_axis(depth, gather, axis=1)
    return np.where(m & has_bg, filled, depth)


def logo_ar_mask(shape_hw, logo_rgba: np.ndarray, y: int, x: int,
                 depth_at_anchor: float, max_depth: float,
                 logo_pixel_height: int = 60,
                 scale_factor: float = 1.0):
    """Scale the logo inversely with its anchor depth and paint its footprint
    (main.py:92-124).  Returns (mask (H, W) bool, rgb (H, W, 3))."""
    import cv2
    h, w = shape_hw
    scale_px = logo_pixel_height * (max_depth / max(depth_at_anchor, 1e-6)) \
        ** scale_factor
    s = scale_px / logo_rgba.shape[0]
    logo = cv2.resize(logo_rgba, (0, 0), fx=s, fy=s)
    lh, lw = logo.shape[:2]
    lh = min(lh, h - y)
    lw = min(lw, w - x)
    mask = np.zeros(shape_hw, bool)
    rgb = np.zeros((*shape_hw, 3), logo.dtype)
    if lh <= 0 or lw <= 0:
        return mask, rgb
    alpha = (logo[:lh, :lw, 3] > 0) if logo.shape[-1] == 4 else \
        (logo[:lh, :lw, :3].sum(-1) > 0)
    mask[y:y + lh, x:x + lw] = alpha
    rgb[y:y + lh, x:x + lw] = logo[:lh, :lw, :3]
    return mask, rgb


def composite_ar_frame(rgb: np.ndarray, depth_pred: np.ndarray,
                       naked_depth: np.ndarray, logo_rgba: np.ndarray,
                       y: int, x: int, logo_pixel_height: int = 60) -> np.ndarray:
    """Place the logo at (y, x) at the naked-scene depth; scene pixels with
    predicted depth closer than the logo occlude it (main.py:156-185)."""
    depth_pred = np.asarray(depth_pred)
    if depth_pred.ndim == 3:
        depth_pred = depth_pred[..., 0]
    h, w = depth_pred.shape
    d_anchor = float(naked_depth[y, x])
    mask, logo_rgb = logo_ar_mask((h, w), logo_rgba, y, x, d_anchor,
                                  float(np.max(naked_depth)),
                                  logo_pixel_height)
    visible = mask & (depth_pred > d_anchor)
    out = np.asarray(rgb).copy()
    out[visible] = logo_rgb[visible]
    return out


def render_ar_gif(path: str, rgb: np.ndarray, depth_pred: np.ndarray,
                  depth_gt: np.ndarray, obj_mask: np.ndarray,
                  logo_rgba: np.ndarray,
                  positions: Sequence[tuple[int, int]],
                  duration_ms: int = 120,
                  logo_pixel_height: int = 60) -> str:
    """Sweep the logo across `positions` and write an animated GIF
    (main.py:189-221)."""
    from PIL import Image
    naked = create_naked_depth(depth_gt, obj_mask)
    frames = []
    for (y, x) in positions:
        frame = composite_ar_frame(rgb, depth_pred, naked, logo_rgba, y, x,
                                   logo_pixel_height=logo_pixel_height)
        frames.append(Image.fromarray(frame.astype(np.uint8)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return path
