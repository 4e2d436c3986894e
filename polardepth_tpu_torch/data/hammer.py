"""HAMMER dataset: index scanning and sample loading
(polardepth_tpu/data/hammer.py; reference indoor_dataset.py:118-190).

For every frame of every scene, the frame is valid iff for each requested
frame id (0, +-1 in the self-supervised configuration, 0 alone in the
supervised one) the rgb image, the _pose txt, the _gt png and the
depth-modality png at frame_index + id * offset all exist.

The loader returns raw uint8/uint16 arrays at native resolution and the
intrinsics; resizing and the float conversion run on the device
(train/losses.py:preprocess_batch).

The decode backend is chosen, never fallen back to: "cv2" is the only one
the port has (the JAX package's "native" libpng decoder is not ported), and
any other name raises.  cv2 is imported inside the loader only.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

BACKENDS = ("cv2",)


def _read_png(path: str, flags: int = -1) -> np.ndarray:
    import cv2
    img = cv2.imread(path, flags)
    if img is None:
        raise FileNotFoundError(path)
    return img


class HammerIndex:
    """Scans <data_path>/<scene>/<modality>/ and builds the valid frame
    list."""

    SUBDIR_RGB = "rgb"
    SUBDIR_POL = ("pol00", "pol01", "pol10", "pol11")  # 0/45/90/135 deg

    def __init__(self, data_path: str, scenes: Sequence[str],
                 frame_ids: Sequence[int] = (0,), offset: int = 10,
                 modality: str = "polarization", depth_modality: str = "_gt"):
        self.data_path = data_path
        self.modality = modality
        self.depth_modality = depth_modality
        self.offset = offset
        self.frame_ids = tuple(frame_ids)
        self.entries: list[tuple[str, int]] = []  # (scene_dir, frame_index)
        for scene in scenes:
            base = os.path.join(data_path, scene, modality)
            rgb_files = sorted(glob.glob(os.path.join(base, self.SUBDIR_RGB,
                                                      "*.png")))
            for f in rgb_files:
                idx = int(os.path.splitext(os.path.basename(f))[0])
                if self._valid(base, idx):
                    self.entries.append((base, idx))

    def _valid(self, base: str, idx: int) -> bool:
        for fid in self.frame_ids:
            name = f"{idx + fid * self.offset:06d}"
            checks = [
                os.path.join(base, self.SUBDIR_RGB, name + ".png"),
                os.path.join(base, "_pose", name + ".txt"),
                os.path.join(base, "_gt", name + ".png"),
                os.path.join(base, self.depth_modality, name + ".png"),
            ]
            if not all(os.path.isfile(p) for p in checks):
                return False
        return True

    def __len__(self) -> int:
        return len(self.entries)


class HammerLoader:
    """Loads raw samples by index; the host work is the PNG decode."""

    def __init__(self, index: HammerIndex, backend: str = "cv2"):
        if backend not in BACKENDS:
            raise ValueError(
                f"decode backend {backend!r} is not in the port; it has "
                f"{', '.join(BACKENDS)}")
        self.index = index
        self.backend = backend
        self._intrinsics_cache: dict[str, np.ndarray] = {}

    def _normalized_intrinsics(self, base: str) -> np.ndarray:
        if base not in self._intrinsics_cache:
            with open(os.path.join(base, "intrinsics.txt")) as f:
                k = np.array(f.read().split(), dtype=np.float64).reshape(3, 3)
            self._intrinsics_cache[base] = k
        return self._intrinsics_cache[base]

    def intrinsics_for(self, base: str, width: int, height: int) -> np.ndarray:
        """Scale-0 4x4 K at a working resolution; the stored file is
        normalised by the native resolution (indoor_dataset.py:262-275)."""
        kn = self._normalized_intrinsics(base).copy()
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = kn
        K[0, :] *= width
        K[1, :] *= height
        return K

    def load(self, i: int, frame_id: int = 0) -> dict:
        import cv2
        base, idx = self.index.entries[i]
        j = idx + frame_id * self.index.offset
        name = f"{j:06d}.png"
        rgb = _read_png(os.path.join(base, HammerIndex.SUBDIR_RGB, name),
                        cv2.IMREAD_COLOR)[..., ::-1]  # BGR -> RGB
        pol = np.stack([
            _read_png(os.path.join(base, d, name), cv2.IMREAD_GRAYSCALE)
            for d in HammerIndex.SUBDIR_POL], axis=-1)
        mask = _read_png(os.path.join(base, "_instance", name),
                         cv2.IMREAD_GRAYSCALE).astype(np.int32)
        depth_gt = _read_png(os.path.join(base, "_gt", name))
        depth_sup = _read_png(
            os.path.join(base, self.index.depth_modality, name))
        return {
            "color": np.ascontiguousarray(rgb),
            "pol": pol,
            "mask": mask[..., None],
            "depth_gt": (depth_gt.astype(np.float32) / 1000.0)[..., None],
            "depth": (depth_sup.astype(np.float32) / 1000.0)[..., None],
            "pose": self._pose(base, j),
            "scene": base,
            "frame": j,
        }

    def _pose(self, base: str, j: int) -> np.ndarray:
        with open(os.path.join(base, "_pose", f"{j:06d}.txt")) as f:
            return np.array(f.read().split(), dtype=np.float32).reshape(4, 4)

    def relative_pose(self, base: str, frame: int, center: int) -> np.ndarray:
        """inv(inv(T_center) @ T_side)  (hammer_dataset.py:104-132)."""
        T_c = self._pose(base, center).astype(np.float64)
        T_s = self._pose(base, frame).astype(np.float64)
        return np.linalg.inv(np.linalg.inv(T_c) @ T_s).astype(np.float32)


def read_split(splits_dir: str, split: str, part: str) -> list[str]:
    """The scene list splits/<split>/<part>_files.txt."""
    with open(os.path.join(splits_dir, split, f"{part}_files.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]
