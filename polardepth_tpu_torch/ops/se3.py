"""SE(3) utilities: axis-angle <-> 4x4 transforms (polardepth_tpu/ops/se3.py:
13-89; reference manydepth/layers.py:74-149)."""

from __future__ import annotations

import math

import torch

from polardepth_tpu_torch.ops.clip import clip


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """(B, 1, 3) axis-angle -> (B, 4, 4) rotation (Rodrigues), with the
    reference's angle + 1e-7 regularisation."""
    vec = vec.reshape(vec.shape[0], 3)
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    return torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zero,
        xyC + zs, y * yC + ca, yzC - xs, zero,
        zxC - ys, yzC + xs, z * zC + ca, zero,
        zero, zero, zero, one,
    ], dim=-1).reshape(-1, 4, 4)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 3) or (B, 1, 3) translation -> (B, 4, 4) homogeneous transform."""
    t = t.reshape(t.shape[0], 3)
    top = torch.cat([torch.eye(3, dtype=t.dtype, device=t.device).expand(
        t.shape[0], 3, 3), t[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=t.dtype,
                          device=t.device).expand(t.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def rotmat_to_rotvec(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(B, 3, 3) rotations -> (B, 3) axis-angle (log map): the sinc form for
    small angles, the diagonal formula within 1e-3 of pi."""
    trace = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    cos_a = clip((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_a)
    skew = torch.stack([R[:, 2, 1] - R[:, 1, 2],
                        R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], dim=-1)
    sin_a = torch.sin(angle)
    factor = torch.where(sin_a > eps, angle / (2.0 * sin_a + eps),
                         torch.full_like(angle, 0.5))
    generic = skew * factor[:, None]
    diag = torch.stack([R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], dim=-1)
    axis_abs = torch.sqrt(clip((diag + 1.0) * 0.5, 0.0, 1.0))
    signs = torch.where(skew >= 0, 1.0, -1.0)
    near_pi = axis_abs * signs * angle[:, None]
    return torch.where((math.pi - angle[:, None]) > 1e-3, generic, near_pi)


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """Network (axisangle, translation) -> 4x4 cam-to-cam transform;
    invert=True gives R^T and -t composed as R @ T, as the reference."""
    R = rot_from_axisangle(axisangle)
    t = translation.reshape(translation.shape[0], 3)
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return R @ T if invert else T @ R
