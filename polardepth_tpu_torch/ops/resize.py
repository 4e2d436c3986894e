"""Image resizing with the JAX package's semantics (polardepth_tpu/ops/resize.py).

Public functions take and return channels-last (B, H, W, C) tensors.

  * ``resize_bilinear`` and ``upsample2x``: torch bilinear interpolation, which
    the JAX package reproduces with weight matrices; here it is torch's own.
  * ``resize_nearest``: torch's legacy "nearest", src = floor(dst * in / out),
    by index selection, so integer masks keep their dtype.
  * ``resize_antialias``: ``jax.image.resize(..., "linear", antialias=True)``,
    a triangle filter widened by the downscale factor.  Its weight matrices
    are built in float64 numpy as jax/_src/image/scale.py:compute_weight_mat
    builds them; ``F.interpolate(antialias=True)`` is a different filter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def upsample2x_nchw(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, align_corners=False, on (B, C, H, W) (reference
    layers.upsample, manydepth/layers.py:446-449)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, align_corners=False, on (B, H, W, C)."""
    return _nhwc(upsample2x_nchw(_nchw(x)))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """(B, H, W, C) bilinear resize with torch semantics."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                               align_corners=align_corners))


@functools.lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    dst = np.arange(out_size, dtype=np.float64)
    idx = np.floor(dst * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) nearest resize (torch legacy 'nearest'); keeps dtype."""
    for axis, out in ((1, out_hw[0]), (2, out_hw[1])):
        if x.shape[axis] != out:
            idx = torch.from_numpy(_nearest_indices(x.shape[axis], out))
            x = x.index_select(axis, idx.to(x.device))
    return x


@functools.lru_cache(maxsize=256)
def antialias_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of jax.image.resize(method="linear",
    antialias=True) along one axis, translation 0."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))                     # (in, out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def resize_antialias(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) anti-aliased linear resize, as jax.image.resize with
    antialias=True (polardepth_tpu/ops/resize.py:114-126)."""
    for axis, out in ((1, out_hw[0]), (2, out_hw[1])):
        if x.shape[axis] == out:
            continue
        w = torch.from_numpy(antialias_weights(x.shape[axis], out)).to(
            device=x.device, dtype=x.dtype)
        x = torch.einsum("oh,bhwc->bowc" if axis == 1 else "ow,bhwc->bhoc",
                         w, x)
    return x
