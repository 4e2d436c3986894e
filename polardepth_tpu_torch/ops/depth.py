"""Disparity -> depth (polardepth_tpu/ops/depth.py; reference
manydepth/layers.py:62-71)."""

from __future__ import annotations

import torch


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth).

    scaled_disp = 1/max_depth + (1/min_depth - 1/max_depth) * disp
    depth = 1 / scaled_disp
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp
