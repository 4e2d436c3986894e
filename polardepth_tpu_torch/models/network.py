"""PolarDepthNet, the supervised multi-encoder depth network
(polardepth_tpu/models/network.py:34-131).

ShallowResNet18Stem (RGB) + optional XOLP encoder + optional normals encoder
(or both as one FusedModalityEncoders stack) -> JointEncoder -> DepthDecoder.
With ``use_attention`` (the arch1++_attention variant) the RGB stem's last
features attend to the modality encoders' through CrossModalAttention
before the JointEncoder; the decoder's skips keep the stem's own features.
Children carry the reference's component names (rgb_encoder, xolp_encoder,
normals_encoder, fused_encoders, cross_modal_attention, joint_encoder,
mono_depth).

With ``augment_normals`` the polarization preprocess goes through
ops/polar_preprocess.fused_polar_preprocess, whose CUDA kernel runs for a
tensor on the card; with only ``augment_xolp`` the Stokes fit is
ops/xolp.xolp_from_pol.  Nothing here computes the priors any other way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from polardepth_tpu_torch.models.attention import CrossModalAttention
from polardepth_tpu_torch.models.depth_decoder import DepthDecoder
from polardepth_tpu_torch.models.pre_encoders import (
    FusedModalityEncoders, JointEncoder, ShallowEncoder, ShallowNormalsEncoder)
from polardepth_tpu_torch.models.resnet import ShallowResNet18Stem
from polardepth_tpu_torch.ops.polar_preprocess import fused_polar_preprocess
from polardepth_tpu_torch.ops.xolp import xolp_from_pol


class PolarDepthNet(nn.Module):
    def __init__(self, augment_xolp: bool = True, augment_normals: bool = True,
                 dropout_rate: float = 0.1,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 refraction_index: float = 1.5, fused_encoders: bool = False,
                 in_ch: int = 3, use_attention: bool = False,
                 attention_pe_in_stream: bool = False,
                 attention_gate: bool = True):
        super().__init__()
        if fused_encoders and not (augment_xolp and augment_normals):
            raise ValueError(
                "fused_encoders requires augment_xolp AND augment_normals")
        self.augment_xolp = augment_xolp
        self.augment_normals = augment_normals
        self.refraction_index = refraction_index
        self.fused = fused_encoders
        d = dropout_rate
        self.rgb_encoder = ShallowResNet18Stem(in_ch)
        if fused_encoders:
            self.fused_encoders = FusedModalityEncoders(d)
        else:
            if augment_xolp:
                self.xolp_encoder = ShallowEncoder(2, "XOLP", d)
            if augment_normals:
                self.normals_encoder = ShallowNormalsEncoder(d)
        modal_ch = 64 * (int(augment_xolp) + int(augment_normals))
        # as in the JAX package, the attention exists only beside a
        # modality encoder
        self.use_attention = use_attention and modal_ch > 0
        if self.use_attention:
            self.cross_modal_attention = CrossModalAttention(
                d_model=128, pol_channels=modal_ch,
                pe_in_stream=attention_pe_in_stream, gate=attention_gate)
        self.joint_encoder = JointEncoder(128 + modal_ch, d)
        self.mono_depth = DepthDecoder(tuple(scales))

    def forward(self, color: torch.Tensor, pol: Optional[torch.Tensor] = None,
                xolp: Optional[torch.Tensor] = None,
                priors: Optional[torch.Tensor] = None):
        """color: (B, H, W, in_ch) in [0, 1]; pol: (B, H, W, 4) float32 grays
        at [0, 45, 90, 135] degrees on the 0..255 scale.  Instead of pol, a
        caller may give the preprocess's outputs: xolp (B, H, W, 2) and, with
        augment_normals, priors (B, H, W, 9).

        Returns {("disp", s): (B, H/2^s, W/2^s, 1)} for s in scales.
        """
        if (self.augment_xolp or self.augment_normals) and xolp is None:
            if pol is None:
                raise ValueError(
                    "augment_xolp/augment_normals need pol or xolp")
            pol = pol.float().contiguous()
            if self.augment_normals:
                xolp, priors = fused_polar_preprocess(pol,
                                                      self.refraction_index)
            else:
                xolp = xolp_from_pol(pol)
        if self.augment_normals and priors is None:
            raise ValueError("augment_normals needs pol, or xolp and priors")

        rgb_feats = self.rgb_encoder(color.permute(0, 3, 1, 2))
        modality = []
        if self.fused:
            modality.append(self.fused_encoders(xolp, priors))
        else:
            if self.augment_xolp:
                modality.append(self.xolp_encoder(xolp.permute(0, 3, 1, 2)))
            if self.augment_normals:
                modality.append(self.normals_encoder(priors))
        rgb_fused = rgb_feats[-1]
        if self.use_attention:
            # the modality features are [xolp | normals], the fused stack's
            # output as it stands
            pol_feats = torch.cat(modality, dim=1).permute(0, 2, 3, 1)
            rgb_fused = self.cross_modal_attention(
                rgb_fused.permute(0, 2, 3, 1), pol_feats).permute(0, 3, 1, 2)
        joint = self.joint_encoder(rgb_fused, *modality)
        outputs = self.mono_depth(rgb_feats + joint)
        return {k: v.permute(0, 2, 3, 1) for k, v in outputs.items()}
