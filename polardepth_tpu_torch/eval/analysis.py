"""2-D visual analysis of predictions (polardepth_tpu/eval/analysis.py;
reference analysis_2d/visual_analysis.ipynb): signed, absolute and squared
error maps, per-material RMS, and colour-mapped renderings of the error,
the disparity and the normals of a depth, as (H, W, 3) arrays ready for the
metric writer or a PNG."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from polardepth_tpu_torch.eval.evaluation import MATERIAL_THRESHOLDS
from polardepth_tpu_torch.ops.normals import depth_to_normals
from polardepth_tpu_torch.utils.colormap import colormap_plasma, normalize_image


def error_maps(depth_pred: np.ndarray, depth_gt: np.ndarray,
               min_depth: float = 0.1, max_depth: float = 2.0) -> dict:
    """Signed, absolute and squared error maps, zero outside the valid
    mask (min_depth < gt < max_depth)."""
    pred = np.asarray(depth_pred).squeeze()
    gt = np.asarray(depth_gt).squeeze()
    valid = (gt > min_depth) & (gt < max_depth)
    signed = np.where(valid, pred - gt, 0.0)
    return {"signed": signed, "abs": np.abs(signed), "sq": signed ** 2,
            "valid": valid}


def per_material_rms(depth_pred: np.ndarray, depth_gt: np.ndarray,
                     instance_mask: np.ndarray, min_depth: float = 0.1,
                     max_depth: float = 2.0) -> Dict[str, float]:
    """RMS error per material slice; NaN for an empty slice."""
    maps = error_maps(depth_pred, depth_gt, min_depth, max_depth)
    inst = np.asarray(instance_mask).squeeze()
    out = {}
    for name, thr in MATERIAL_THRESHOLDS.items():
        m = maps["valid"] if thr is None else \
            maps["valid"] & (inst >= thr[0]) & (inst <= thr[1])
        out[name] = float(np.sqrt(maps["sq"][m].mean())) if m.any() else \
            float("nan")
    return out


def render_error_heatmap(depth_pred, depth_gt, min_depth=0.1,
                         max_depth=2.0) -> np.ndarray:
    """(H, W, 3) plasma heat map of |error|."""
    return colormap_plasma(
        error_maps(depth_pred, depth_gt, min_depth, max_depth)["abs"])


def render_normals(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(H, W, 3) normals of a depth map under intrinsics K, mapped from
    [-1, 1] to [0, 1] rgb (ops/normals.py:depth_to_normals)."""
    d = torch.from_numpy(np.asarray(depth, np.float32).squeeze()[
        None, ..., None].copy())
    K3 = torch.from_numpy(np.asarray(K, np.float32)[None, :3, :3].copy())
    n = depth_to_normals(d, K3)[0].numpy()
    return (n + 1.0) * 0.5


def render_disparity(disp: np.ndarray) -> np.ndarray:
    """Colour-mapped disparity: plasma over per-image normalised values
    (the reference's TensorBoard convention, trainer.py:1694-1722)."""
    return colormap_plasma(normalize_image(np.asarray(disp).squeeze()),
                           normalize=False)
