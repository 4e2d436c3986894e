"""Polarization quad-mosaic utilities (offline preprocessing tools).

Reference: polarisation/pol_split_and_save.py:10-48 (split a 2x2-mosaic
sensor frame into the four per-angle images) and
polarisation/xolp_mean_and_std_dev.py:9-34 (the DoLP/AoLP standardization
statistics whose published values are baked into the XOLP encoder,
pre_encoders.py:79).

Mosaic layout (polarization sensors like the Sony IMX250MZR): each 2x2
super-pixel holds the four polarizer orientations;
  (0,0)-> pol00 = 0 deg, (0,1)-> pol01 = 45 deg,
  (1,0)-> pol10 = 90 deg, (1,1)-> pol11 = 135 deg
matching the dataset's folder convention (indoor_dataset.py:434-439).

A copy of polardepth_tpu/data/mosaic.py:1-66; the statistics take the port's
Stokes fit (ops/xolp.py:iun_and_xolp) in float64.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from polardepth_tpu_torch.ops.xolp import iun_and_xolp


def split_pol_mosaic(img: np.ndarray) -> dict[str, np.ndarray]:
    """(2H, 2W[, C]) mosaic -> {'pol00','pol01','pol10','pol11'} each (H, W[, C])."""
    return {
        "pol00": img[0::2, 0::2],
        "pol01": img[0::2, 1::2],
        "pol10": img[1::2, 0::2],
        "pol11": img[1::2, 1::2],
    }


def split_and_save_scene(src_dir: str, out_root: str,
                         pattern: str = "*.png") -> int:
    """Split every mosaic frame in src_dir into pol00..pol11 folders under
    out_root (the offline step that produced the HAMMER pol folders)."""
    import cv2
    frames = sorted(glob.glob(os.path.join(src_dir, pattern)))
    for sub in ("pol00", "pol01", "pol10", "pol11"):
        os.makedirs(os.path.join(out_root, sub), exist_ok=True)
    for path in frames:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        name = os.path.basename(path)
        for sub, quad in split_pol_mosaic(img).items():
            cv2.imwrite(os.path.join(out_root, sub, name), quad)
    return len(frames)


def xolp_statistics(pol_stacks) -> dict[str, float]:
    """Mean/std of the pooled DoLP+AoLP values over a sample of frames —
    the procedure that produced the hardcoded XOLP standardization constants
    (polarisation/xolp_mean_and_std_dev.py; values at
    models/pre_encoders.py:XOLP_MEAN/XOLP_STD).

    pol_stacks: iterable of (H, W, 4) arrays at [0, 45, 90, 135] deg.
    """
    values = []
    for stack in pol_stacks:
        _, rho, phi = iun_and_xolp(torch.from_numpy(
            np.asarray(stack, np.float64)))
        values.append(rho.numpy().ravel())
        values.append(phi.numpy().ravel())
    flat = np.concatenate(values)
    return {"mean": float(flat.mean()), "std": float(flat.std())}
