"""Point-cloud export from predicted depth (reference L7:
pointcloud/eval_pointcloud.py).

A copy of polardepth_tpu/eval/pointcloud.py:1-98 (numpy and cv2 only; the
depth comes from the port's ``Trainer.predict``).

The reference runs inference, saves rgb/mask/pred/gt PNGs (pred rescaled to
uint16), then builds an Open3D RGBD point cloud with hardcoded intrinsics
(fx=706.76, fy=707.51, cx=545.63, cy=389.93) and flips Y/Z for display
(eval_pointcloud.py:153-291).  Open3D is not available here; the cloud is
built with the framework's own backprojection and written as a standard PLY
that any viewer (including Open3D elsewhere) opens.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# The reference's hardcoded HAMMER camera (eval_pointcloud.py)
HAMMER_POINTCLOUD_INTRINSICS = dict(fx=706.76, fy=707.51,
                                    cx=545.63, cy=389.93)


def depth_to_pointcloud(depth: np.ndarray, rgb: np.ndarray,
                        fx: float, fy: float, cx: float, cy: float,
                        mask: np.ndarray | None = None,
                        flip_yz: bool = True):
    """(H, W[,1]) depth + (H, W, 3) rgb -> (N, 3) points, (N, 3) colors.

    flip_yz mirrors the reference's display transform (Y, Z negated)."""
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = depth
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    cols = np.asarray(rgb).reshape(-1, 3)
    valid = (z > 0).reshape(-1)
    if mask is not None:
        valid &= np.asarray(mask).reshape(-1) > 0
    pts, cols = pts[valid], cols[valid]
    if flip_yz:
        pts[:, 1] *= -1
        pts[:, 2] *= -1
    return pts.astype(np.float32), cols.astype(np.uint8)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> str:
    """Binary little-endian PLY with xyz + rgb."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = points.shape[0]
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header", ""])
    rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = points
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return path


def read_ply(path: str):
    """Read back a PLY written by write_ply."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int([ln for ln in header.decode().splitlines()
                 if ln.startswith("element vertex")][0].split()[-1])
        rec = np.frombuffer(f.read(), dtype=[("xyz", np.float32, 3),
                                             ("rgb", np.uint8, 3)], count=n)
    return rec["xyz"].copy(), rec["rgb"].copy()


def export_prediction_pngs(out_dir: str, name: str, rgb: np.ndarray,
                           mask: np.ndarray, depth_pred: np.ndarray,
                           depth_gt: np.ndarray, max_depth: float = 2.0):
    """Save the four PNGs the reference's downstream tools consume
    (eval_pointcloud.py saves pred as uint16 after (d + 0.3)/max * scale)."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(out_dir, f"{name}_rgb.png"),
                np.asarray(rgb)[..., ::-1])
    cv2.imwrite(os.path.join(out_dir, f"{name}_mask.png"),
                np.asarray(mask).astype(np.uint8))
    for tag, d in (("pred", depth_pred), ("gt", depth_gt)):
        d16 = np.clip(np.asarray(d).squeeze() * 1000.0, 0,
                      65535).astype(np.uint16)
        cv2.imwrite(os.path.join(out_dir, f"{name}_depth_{tag}.png"), d16)
    return out_dir
