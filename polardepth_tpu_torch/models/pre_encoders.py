"""XOLP and normals shallow encoders and the JointEncoder fusion trunk
(polardepth_tpu/models/pre_encoders.py; reference
manydepth/networks/pre_encoders.py:49-164).

Modules return (B, C, H, W) tensors.  The modality encoders take the XOLP
map and the Fresnel priors channels-last, as the fused preprocess
(ops/polar_preprocess.py) gives them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from polardepth_tpu_torch.models.layers import ConvBNReLUDrop, ResidualBlock

# XOLP standardisation constants over 46 HAMMER sample maps (reference
# polarisation/xolp_mean_and_std_dev.py, used at pre_encoders.py:79).
XOLP_MEAN = 0.08693199701957657
XOLP_STD = 0.44430732785457433


def normalize_input(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Fixed per-modality standardisation (reference pre_encoders.py:75-83)."""
    if mode == "XOLP":
        return (x - XOLP_MEAN) / XOLP_STD
    if mode == "normals":
        return x
    if mode == "RGB":
        return (x - 0.45) / 0.225
    raise ValueError(f"unknown normalization mode: {mode}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ShallowEncoder(nn.Module):
    """Conv7/2 -> Res -> Conv5+maxpool -> Res -> Conv5+maxpool -> Res:
    (B, in_ch, H, W) -> (B, 64, H/8, W/8), after the ``mode``
    standardisation."""

    def __init__(self, in_ch: int, mode: str = "XOLP",
                 dropout_rate: float = 0.1):
        super().__init__()
        self.mode = mode
        d = dropout_rate
        self.ConvBNReLUDrop_0 = ConvBNReLUDrop(in_ch, 64, 7, "stride2", 3, d)
        self.ResidualBlock_0 = ResidualBlock(64, d)
        self.ConvBNReLUDrop_1 = ConvBNReLUDrop(64, 64, 5, "maxpool", 2, d)
        self.ResidualBlock_1 = ResidualBlock(64, d)
        self.ConvBNReLUDrop_2 = ConvBNReLUDrop(64, 64, 5, "maxpool", 2, d)
        self.ResidualBlock_2 = ResidualBlock(64, d)

    def forward(self, x):
        x = normalize_input(x, self.mode)
        x = self.ResidualBlock_0(self.ConvBNReLUDrop_0(x))
        x = self.ResidualBlock_1(self.ConvBNReLUDrop_1(x))
        return self.ResidualBlock_2(self.ConvBNReLUDrop_2(x))


class ShallowNormalsEncoder(nn.Module):
    """9-channel Fresnel priors (B, H, W, 9) -> ShallowEncoder."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.ShallowEncoder_0 = ShallowEncoder(9, "normals", dropout_rate)

    def forward(self, priors):
        return self.ShallowEncoder_0(_nchw(priors))


class FusedModalityEncoders(nn.Module):
    """The XOLP and normals encoders as one stack at 128 channels.

    The two stems differ in their input channels and stay apart; from the
    first ResidualBlock on, every conv has groups=2, whose group g is the
    separate encoder g (``fuse_modality_params`` converts exactly).  Output:
    (B, 128, H/8, W/8) = [xolp_feats | normals_feats].
    """

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        d = dropout_rate
        self.stem_xolp = ConvBNReLUDrop(2, 64, 7, "stride2", 3, d)
        self.stem_normals = ConvBNReLUDrop(9, 64, 7, "stride2", 3, d)
        self.ResidualBlock_0 = ResidualBlock(128, d, groups=2)
        self.ConvBNReLUDrop_0 = ConvBNReLUDrop(128, 128, 5, "maxpool", 2, d,
                                               groups=2)
        self.ResidualBlock_1 = ResidualBlock(128, d, groups=2)
        self.ConvBNReLUDrop_1 = ConvBNReLUDrop(128, 128, 5, "maxpool", 2, d,
                                               groups=2)
        self.ResidualBlock_2 = ResidualBlock(128, d, groups=2)

    def forward(self, xolp, priors):
        """xolp (B, H, W, 2), priors (B, H, W, 9)."""
        a = self.stem_xolp(normalize_input(_nchw(xolp), "XOLP"))
        b = self.stem_normals(normalize_input(_nchw(priors), "normals"))
        x = torch.cat([a, b], dim=1)
        x = self.ResidualBlock_0(x)
        x = self.ResidualBlock_1(self.ConvBNReLUDrop_0(x))
        return self.ResidualBlock_2(self.ConvBNReLUDrop_1(x))


# separate ShallowEncoder child -> FusedModalityEncoders child
_FUSED_NAMES = {"ResidualBlock_0": "ResidualBlock_0",
                "ConvBNReLUDrop_1": "ConvBNReLUDrop_0",
                "ResidualBlock_1": "ResidualBlock_1",
                "ConvBNReLUDrop_2": "ConvBNReLUDrop_1",
                "ResidualBlock_2": "ResidualBlock_2"}


def fuse_modality_params(xolp_tree: dict, normals_tree: dict) -> dict:
    """Two separate ShallowEncoder subtrees (flax layout, numpy leaves; the
    'params' or the 'batch_stats' subtree) -> the FusedModalityEncoders
    subtree.  Every trunk leaf is the two leaves concatenated on the last
    (cout or channel) axis.  A numpy copy of
    polardepth_tpu/models/pre_encoders.py:141-176."""

    def cat(pa, pb):
        if isinstance(pa, dict):
            return {k: cat(pa[k], pb[k]) for k in pa}
        return np.concatenate([np.asarray(pa), np.asarray(pb)], axis=-1)

    out = {"stem_xolp": xolp_tree["ConvBNReLUDrop_0"],
           "stem_normals": normals_tree["ConvBNReLUDrop_0"]}
    for sep_name, fused_name in _FUSED_NAMES.items():
        if sep_name not in xolp_tree or sep_name not in normals_tree:
            raise KeyError(f"missing {sep_name} in separate encoder tree")
        out[fused_name] = cat(xolp_tree[sep_name], normals_tree[sep_name])
    return out


def split_modality_params(fused_tree: dict) -> tuple:
    """The exact inverse of ``fuse_modality_params``: (xolp, normals)
    ShallowEncoder subtrees (polardepth_tpu/models/pre_encoders.py:179-205)."""

    def halves(t):
        if isinstance(t, dict):
            pairs = {k: halves(v) for k, v in t.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        a = np.asarray(t)
        h = a.shape[-1] // 2
        return a[..., :h], a[..., h:]

    xolp = {"ConvBNReLUDrop_0": fused_tree["stem_xolp"]}
    normals = {"ConvBNReLUDrop_0": fused_tree["stem_normals"]}
    for sep_name, fused_name in _FUSED_NAMES.items():
        xolp[sep_name], normals[sep_name] = halves(fused_tree[fused_name])
    return xolp, normals


class JointEncoder(nn.Module):
    """Fusion trunk: rgb (B,128,H/8,W/8) [+ xolp 64] [+ normals 64] ->
    [(B,256,H/16,W/16), (B,512,H/32,W/32)] (reference
    pre_encoders.py:116-164)."""

    def __init__(self, in_ch: int, dropout_rate: float = 0.0):
        super().__init__()
        d = dropout_rate
        self.ConvBNReLUDrop_0 = ConvBNReLUDrop(in_ch, 256, 1, "none", 0, d)
        self.ConvBNReLUDrop_1 = ConvBNReLUDrop(256, 128, 1, "none", 0, d)
        self.ResidualBlock_0 = ResidualBlock(128, d)
        self.ResidualBlock_1 = ResidualBlock(128, d)
        self.ConvBNReLUDrop_2 = ConvBNReLUDrop(128, 256, 5, "maxpool", 2, d)
        self.ResidualBlock_2 = ResidualBlock(256, d)
        self.ResidualBlock_3 = ResidualBlock(256, d)
        self.ConvBNReLUDrop_3 = ConvBNReLUDrop(256, 512, 5, "maxpool", 2, d)
        self.ResidualBlock_4 = ResidualBlock(512, d)
        self.ResidualBlock_5 = ResidualBlock(512, d)

    def forward(self, *feats):
        """feats: the rgb features, then any modality features present."""
        x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
        x = self.ConvBNReLUDrop_1(self.ConvBNReLUDrop_0(x))
        x = self.ResidualBlock_1(self.ResidualBlock_0(x))
        x = self.ResidualBlock_3(self.ResidualBlock_2(self.ConvBNReLUDrop_2(x)))
        out16 = x
        x = self.ResidualBlock_5(self.ResidualBlock_4(self.ConvBNReLUDrop_3(x)))
        return [out16, x]
