"""Batch preprocessing on the device (polardepth_tpu/train/losses.py:37-85).

The loss functions come with the training path.
"""

from __future__ import annotations

import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.ops.resize import (
    resize_antialias, resize_bilinear, resize_nearest)


def preprocess_batch(batch: dict, cfg: Config,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Raw batch tensors (uint8 or uint16 valued, possibly at native
    resolution) -> model-ready tensors at (cfg.height, cfg.width):
    color in [0, 1], pol kept on the 0..255 scale, depth resized bilinearly,
    mask by nearest neighbour."""
    hw = (cfg.height, cfg.width)
    out = dict(batch)
    color = batch["color"].to(dtype) / 255.0
    if tuple(color.shape[1:3]) != hw:
        color = resize_antialias(color, hw)
    out["color"] = color
    if "pol" in batch:  # absent in the RGB-only graph
        pol = batch["pol"].to(dtype)
        if tuple(pol.shape[1:3]) != hw:
            pol = resize_antialias(pol, hw)
        out["pol"] = pol
    for k in ("depth", "depth_gt"):
        if k in batch:
            d = batch[k].to(dtype)
            if tuple(d.shape[1:3]) != hw:
                d = resize_bilinear(d, hw)
            out[k] = d
    if "mask" in batch:
        out["mask"] = resize_nearest(batch["mask"], hw)
    return out


def twelve_channel_input(pol: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) captures on 0..255 -> the 12-channel encoder input: each
    capture replicated to 3 channels, in the reference's order pol00/pol10/
    pol01/pol11 = 0/90/45/135 degrees (our channel order is 0/45/90/135)."""
    caps = [pol[..., i:i + 1] / 255.0 for i in (0, 2, 1, 3)]
    return torch.cat([c.expand(*c.shape[:-1], 3) for c in caps], dim=-1)
