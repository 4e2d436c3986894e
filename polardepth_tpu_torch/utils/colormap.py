"""Colour-mapped depth and disparity for logging
(polardepth_tpu/utils/colormap.py; reference trainer.py:1694-1722 and
utils.py:normalize_image): the plasma colour map over per-image min/max
normalised values.

numpy only.  matplotlib is not among the port's dependencies (torch, numpy,
scipy), so the map is always the JAX package's anchor table
(polardepth_tpu/utils/colormap.py:25-36), nine plasma colours interpolated
to 256 entries.
"""

from __future__ import annotations

import numpy as np

_PLASMA_ANCHORS = np.array([
    [0.050, 0.030, 0.528], [0.294, 0.012, 0.631],
    [0.491, 0.012, 0.658], [0.658, 0.134, 0.588],
    [0.798, 0.280, 0.470], [0.902, 0.425, 0.360],
    [0.973, 0.586, 0.252], [0.993, 0.771, 0.155],
    [0.940, 0.975, 0.131]])


def _plasma_table() -> np.ndarray:
    x = np.linspace(0, 1, len(_PLASMA_ANCHORS))
    xi = np.linspace(0, 1, 256)
    return np.stack([np.interp(xi, x, _PLASMA_ANCHORS[:, c])
                     for c in range(3)], axis=-1)


PLASMA = _plasma_table()


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Per-image min/max normalisation (reference utils.normalize_image)."""
    ma, mi = float(np.max(x)), float(np.min(x))
    return (x - mi) / (ma - mi + 1e-5)


def colormap_plasma(x: np.ndarray, normalize: bool = True) -> np.ndarray:
    """(H, W) or (H, W, 1) scalar map -> (H, W, 3) float RGB."""
    x = np.asarray(x, np.float64)
    if x.ndim == 3:
        x = x[..., 0]
    if normalize:
        x = normalize_image(x)
    idx = np.clip((x * 255).astype(np.int64), 0, 255)
    return PLASMA[idx]
