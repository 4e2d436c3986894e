"""Surface normals from depth with kornia 0.5.11's ``depth_to_normals``
semantics (polardepth_tpu/ops/normals.py:32-87): unproject each pixel,
normalised Sobel gradients with replicate padding, the cross product, and a
normalisation whose norm is clamped inside the square root."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def spatial_gradient_sobel(x: torch.Tensor):
    """Per-channel normalised Sobel gradients (the kernels divided by 8),
    replicate padding.  x (B, H, W, C) -> (gx, gy), each (B, H, W, C)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="replicate").permute(0, 2, 3, 1)

    def shifted(dy: int, dx: int):
        return xp[:, dy:dy + h, dx:dx + w]

    tl, tc, tr = shifted(0, 0), shifted(0, 1), shifted(0, 2)
    ml, mr = shifted(1, 0), shifted(1, 2)
    bl, bc, br = shifted(2, 0), shifted(2, 1), shifted(2, 2)
    gx = ((tr - tl) + 2.0 * (mr - ml) + (br - bl)) * 0.125
    gy = ((bl - tl) + 2.0 * (bc - tc) + (br - tr)) * 0.125
    return gx, gy


def depth_to_3d(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W, 1) + K (B, 3, 3) -> camera points (B, H, W, 3)."""
    _, h, w, _ = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[
        None, None, :, None]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[
        None, :, None, None]
    fx = K[:, 0, 0][:, None, None, None]
    fy = K[:, 1, 1][:, None, None, None]
    cx = K[:, 0, 2][:, None, None, None]
    cy = K[:, 1, 2][:, None, None, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.cat([x, y, depth], dim=-1)


def depth_to_normals(depth: torch.Tensor, K: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """depth (B, H, W, 1) + K (B, 3, 3) -> unit normals (B, H, W, 3)."""
    gx, gy = spatial_gradient_sobel(depth_to_3d(depth, K))
    n = torch.linalg.cross(gx, gy, dim=-1)
    sq = torch.sum(n * n, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.maximum(sq, torch.full_like(sq, eps * eps)))
    return n / norm
