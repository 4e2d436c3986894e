"""Batch preprocessing on the device and the supervised loss assembly
(polardepth_tpu/train/losses.py:37-85, 98-234).

Per scale s: the disparity upsampled to full resolution -> depth; masked L1
against the supervision depth, normals_loss_weight x the masked normals
cosine term, and disparity_smoothness / 2^s x the edge-aware smoothness of
the mean-normalised disparity; the total is the mean over scales.  The
JAX package's packed (channels-leading) form is a TPU layout of the same
sums and is not ported.
"""

from __future__ import annotations

import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.ops.camera import scale_intrinsics
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.losses import (
    masked_l1_depth_loss, smooth_loss, supervised_normals_loss)
from polardepth_tpu_torch.ops.normals import depth_to_normals
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


def color_pyramid(color: torch.Tensor, scales) -> dict:
    """{s: color at 1/2^s}, anti-aliased linear resizes of the clean frame
    (the smoothness loss's edge images)."""
    _, h, w, _ = color.shape
    return {s: color if s == 0 else
            resize_antialias(color, (h // 2 ** s, w // 2 ** s))
            for s in scales}


def supervised_scale_terms(cfg: Config, depth, depth_sup, K, scale: int,
                           n_gt=None):
    """(masked L1, normals term) at one scale, the mask being the
    supervision depth within [min_depth, max_depth].  With v1_multiscale the
    supervision is resized to the prediction and K scaled."""
    if cfg.v1_multiscale and scale:
        depth_sup = resize_bilinear(depth_sup, tuple(depth.shape[1:3]))
        K = scale_intrinsics(K, 2.0 ** -scale)
        n_gt = None
    valid = ((depth_sup >= cfg.min_depth)
             & (depth_sup <= cfg.max_depth)).to(depth_sup.dtype)
    l_dep = masked_l1_depth_loss(depth_sup, depth, valid)
    l_nrm = supervised_normals_loss(depth_sup, depth, K, valid, n_gt=n_gt)
    return l_dep, l_nrm


def smoothness_term(disp: torch.Tensor, color_s: torch.Tensor):
    """Edge-aware smoothness of disp (B, h, w, 1) normalised by its
    per-image mean."""
    mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
    return smooth_loss(disp / (mean_disp + 1e-7), color_s)


def supervised_losses(cfg: Config, outputs: dict, batch: dict):
    """(total, logs) of the published supervised step.  outputs holds the
    ("disp", s) maps (B, H/2^s, W/2^s, 1); batch is preprocessed (color,
    depth at the working resolution, K)."""
    h, w = cfg.height, cfg.width
    depth_sup = batch["depth"]
    pyr = color_pyramid(batch["color"], cfg.scales)
    n_gt = None
    if not cfg.v1_multiscale and cfg.normals_loss_weight:
        # the same full-resolution normals of the supervision at every scale
        n_gt = depth_to_normals(depth_sup, batch["K"][:, :3, :3])
    logs = {}
    total = 0.0
    for s in cfg.scales:
        disp = outputs[("disp", s)]
        if cfg.v1_multiscale or not s:
            disp_full = disp
        else:
            disp_full = resize_bilinear(disp, (h, w))
        _, depth = disp_to_depth(disp_full, cfg.min_depth, cfg.max_depth)
        l_depth, l_normals = supervised_scale_terms(
            cfg, depth, depth_sup, batch["K"], s, n_gt=n_gt)
        l_smooth = smoothness_term(disp, pyr[s])
        loss_s = (l_depth + cfg.normals_loss_weight * l_normals
                  + cfg.disparity_smoothness * l_smooth / (2 ** s))
        total = total + loss_s
        logs[f"supervised_depth_loss/{s}"] = l_depth
        logs[f"normals_loss/{s}"] = l_normals
        logs[f"smooth_loss/{s}"] = l_smooth
        logs[f"loss/{s}"] = loss_s
    total = total / cfg.num_scales
    logs["loss"] = total
    return total, logs
