"""Monodepth2 depth decoder (polardepth_tpu/models/depth_decoder.py; reference
manydepth/networks/depth_decoder.py).

Five up-stages of widths [16, 32, 64, 128, 256]: ConvBlock -> bilinear x2
upsample -> skip concat -> ConvBlock, and a 3x3 reflection-padded disparity
head + sigmoid at every requested scale.  The JAX package's phase-packed plan
(ops/phase.py) is a TPU layout of the same function; this is the unpacked one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from polardepth_tpu_torch.models.layers import ConvBlockELU, ReflectConv
from polardepth_tpu_torch.ops.resize import upsample2x_nchw

NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)


class DepthDecoder(nn.Module):
    """5 maps (B, C, H/2^k, W/2^k), k = 1..5 -> {("disp", s): (B, 1, H/2^s,
    W/2^s)} for s in scales.

    Children carry the flax auto-names: stage i's blocks are
    ConvBlockELU_{2(4-i)} and ConvBlockELU_{2(4-i)+1}, and the heads are
    ReflectConv_0, _1, ... in the order the stages create them (i = 4 .. 0).
    """

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.heads = {}      # scale -> head name
        for i in range(4, -1, -1):
            cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
            k = 2 * (4 - i)
            self.add_module(f"ConvBlockELU_{k}",
                            ConvBlockELU(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
            self.add_module(f"ConvBlockELU_{k + 1}",
                            ConvBlockELU(cin, NUM_CH_DEC[i]))
            if i in scales:
                self.heads[i] = f"ReflectConv_{len(self.heads)}"
                self.add_module(self.heads[i],
                                ReflectConv(NUM_CH_DEC[i], 1))

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for i in range(4, -1, -1):
            k = 2 * (4 - i)
            x = upsample2x_nchw(getattr(self, f"ConvBlockELU_{k}")(x))
            if i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = getattr(self, f"ConvBlockELU_{k + 1}")(x)
            if i in self.heads:
                outputs[("disp", i)] = torch.sigmoid(
                    getattr(self, self.heads[i])(x))
        return outputs
