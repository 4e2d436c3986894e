"""The pose decoder (polardepth_tpu/models/pose.py:16-33; reference
manydepth/networks/pose_decoder.py)."""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from polardepth_tpu_torch.models.layers import TorchConv


class PoseDecoder(nn.Module):
    """The deepest map of one encoder's feature list (the JAX package's
    PoseDecoder(1, num_frames), the only form it uses) -> 0.01-scaled
    (axisangle, translation), each (B, num_frames, 1, 3).

    Children carry the flax auto-names TorchConv_0 .. TorchConv_3.
    """

    def __init__(self, num_ch_enc: int = 512,
                 num_frames_to_predict_for: int = 2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.TorchConv_0 = TorchConv(num_ch_enc, 256, 1)
        self.TorchConv_1 = TorchConv(256, 256, 3, padding=1)
        self.TorchConv_2 = TorchConv(256, 256, 3, padding=1)
        self.TorchConv_3 = TorchConv(256, 6 * num_frames_to_predict_for, 1)

    def forward(self, features):
        out = F.relu(self.TorchConv_0(features[-1]))
        out = F.relu(self.TorchConv_1(out))
        out = F.relu(self.TorchConv_2(out))
        out = self.TorchConv_3(out).mean(dim=(2, 3))   # spatial mean
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
