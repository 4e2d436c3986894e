"""Pinhole camera geometry (polardepth_tpu/ops/camera.py:19-55; reference
manydepth/layers.py:383-443, BackprojectDepth and Project3D).

Depth maps are (B, H, W, 1), intrinsics (B, 4, 4), point clouds (B, 4, H*W)
homogeneous, grids (B, H, W, 2) normalised to [-1, 1].
"""

from __future__ import annotations

import torch


def _pixel_grid(h: int, w: int, dtype, device) -> torch.Tensor:
    """(3, H*W) homogeneous pixel coordinates, x fastest."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor):
    """depth (B, H, W, 1) + inv_K (B, 4, 4) -> cam points (B, 4, H*W)."""
    b, h, w, _ = depth.shape
    pix = _pixel_grid(h, w, depth.dtype, depth.device)
    cam = torch.einsum("bij,jn->bin", inv_K[:, :3, :3], pix)
    cam = depth.reshape(b, 1, h * w) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
               height: int, width: int, eps: float = 1e-7) -> torch.Tensor:
    """Cam points (B, 4, H*W) + K, T (B, 4, 4) -> the normalised grid
    (B, H, W, 2) for grid_sample."""
    b = points.shape[0]
    P = (K @ T)[:, :3, :]
    cam = torch.einsum("bij,bjn->bin", P, points)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(b, 2, height, width).permute(0, 2, 3, 1)
    scale = torch.tensor([width - 1, height - 1], dtype=points.dtype,
                         device=points.device)
    return (pix / scale - 0.5) * 2.0


def scale_intrinsics(K: torch.Tensor, factor: float) -> torch.Tensor:
    """Intrinsics (B, 4, 4) at a pyramid level: rows 0 (fx, cx) and 1
    (fy, cy) times factor."""
    scale = torch.tensor([factor, factor, 1.0, 1.0], dtype=K.dtype,
                         device=K.device)
    return K * scale[None, :, None]
