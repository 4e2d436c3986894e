"""Losses: supervised depth, normals cosine, edge-aware smoothness, SSIM and
photometric reprojection (polardepth_tpu/ops/losses.py:20-115; reference
trainer.py:1069-1081, 1241-1252, 1298-1309 and layers.py:452-499).

Tensors are channels last; the arithmetic is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polardepth_tpu_torch.ops.clip import clip
from polardepth_tpu_torch.ops.normals import depth_to_normals


def _max_eps(x: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.maximum(x, torch.full_like(x, floor))


def masked_l1_depth_loss(depth_gt, depth_pred, mask) -> torch.Tensor:
    """sum(|gt - pred| * mask) / sum(mask)."""
    mask = mask.to(depth_pred.dtype)
    return torch.sum(torch.abs(depth_gt - depth_pred) * mask) / torch.sum(mask)


def supervised_normals_loss(depth_gt, depth_pred, K, mask, eps: float = 1e-8,
                            n_gt=None) -> torch.Tensor:
    """Masked mean of 2 - cos(normals(gt), normals(pred)), with torch's
    cosine_similarity clamp taken inside the square root; n_gt may be given
    precomputed."""
    if n_gt is None:
        n_gt = depth_to_normals(depth_gt, K[:, :3, :3])
    n_pred = depth_to_normals(depth_pred, K[:, :3, :3])
    dot = torch.sum(n_gt * n_pred, dim=-1, keepdim=True)
    na = torch.sqrt(_max_eps(torch.sum(n_gt * n_gt, dim=-1, keepdim=True),
                             eps * eps))
    nb = torch.sqrt(_max_eps(torch.sum(n_pred * n_pred, dim=-1,
                                       keepdim=True), eps * eps))
    cos = dot / (na * nb)
    mask = mask.to(depth_pred.dtype)
    return torch.sum((2.0 - cos) * mask) / torch.sum(mask)


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of disp (B, H, W, 1) against img
    (B, H, W, 3) at the same scale."""
    disp = disp.float()
    img = img.float()
    grad_disp_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    grad_img_x = torch.mean(torch.abs(img[:, :, :-1] - img[:, :, 1:]),
                            dim=-1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), dim=-1,
                            keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return torch.mean(grad_disp_x) + torch.mean(grad_disp_y)


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean on the reflection-padded input (the reference's
    ReflectionPad2d(1) + AvgPool2d(3, 1)), summed in the JAX package's
    order; x (B, H, W, C)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="reflect").permute(0, 2, 3, 1)
    out = (xp[:, :-2, :-2] + xp[:, :-2, 1:-1] + xp[:, :-2, 2:]
           + xp[:, 1:-1, :-2] + xp[:, 1:-1, 1:-1] + xp[:, 1:-1, 2:]
           + xp[:, 2:, :-2] + xp[:, 2:, 1:-1] + xp[:, 2:, 2:])
    return out / 9.0


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel (1 - SSIM) / 2 clamped to [0, 1], float32."""
    x = x.float()
    y = y.float()
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return clip((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor,
                      use_ssim: bool = True) -> torch.Tensor:
    """Per-pixel photometric loss 0.85 SSIM + 0.15 L1, channel-averaged to
    (B, H, W, 1)."""
    l1 = torch.mean(torch.abs(target.float() - pred.float()), dim=-1,
                    keepdim=True)
    if not use_ssim:
        return l1
    s = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return 0.85 * s + 0.15 * l1
