"""ResNet-18 encoders: the RGB encoder, torchvision's resnet18 cut after
layer2 (polardepth_tpu/models/resnet.py:74-94; reference
resnet_encoder.py:809-822), and the full five-level encoder of the pose net
(polardepth_tpu/models/resnet.py:96-118).
"""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from polardepth_tpu_torch.models.layers import batch_norm


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int):
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(cin, cout, 3, stride, 1)
        self.BatchNorm_0 = batch_norm(cout)
        self.Conv_1 = _conv(cout, cout, 3, 1, 1)
        self.BatchNorm_1 = batch_norm(cout)
        self.downsample = stride != 1 or cin != cout
        if self.downsample:
            self.Conv_2 = _conv(cin, cout, 1, stride, 0)
            self.BatchNorm_2 = batch_norm(cout)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.downsample else x
        return F.relu(out + identity)


class ShallowResNet18Stem(nn.Module):
    """(B, in_ch, H, W) in [0, 1] -> [f0 64@H/2, f1 64@H/4, f2 128@H/8].

    The input is standardised with (x - 0.45) / 0.225 here, as in the
    reference.  in_ch is 3, or 12 in the 12-channel mode.
    """

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.Conv_0 = _conv(in_ch, 64, 7, 2, 3)
        self.BatchNorm_0 = batch_norm(64)
        self.BasicBlock_0 = BasicBlock(64, 64)
        self.BasicBlock_1 = BasicBlock(64, 64)
        self.BasicBlock_2 = BasicBlock(64, 128, 2)
        self.BasicBlock_3 = BasicBlock(128, 128)

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f0 = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        f1 = F.max_pool2d(f0, 3, 2, 1)
        f1 = self.BasicBlock_1(self.BasicBlock_0(f1))
        f2 = self.BasicBlock_3(self.BasicBlock_2(f1))
        return [f0, f1, f2]


class ResNet18Encoder(nn.Module):
    """The full resnet18 (reference ResnetEncoder): (B, 3n, H, W) in [0, 1]
    -> [64@H/2, 64@H/4, 128@H/8, 256@H/16, 512@H/32].

    num_input_images > 1 takes frames stacked on the channel axis through a
    widened conv1 (reference resnet_multiimage_input,
    resnet_encoder.py:26-69).  The input is standardised with
    (x - 0.45) / 0.225 here.
    """

    def __init__(self, num_input_images: int = 1):
        super().__init__()
        self.Conv_0 = _conv(3 * num_input_images, 64, 7, 2, 3)
        self.BatchNorm_0 = batch_norm(64)
        widths = (64, 64, 128, 128, 256, 256, 512, 512)
        cin = 64
        for i, cout in enumerate(widths):
            stride = 2 if i % 2 == 0 and i > 0 else 1
            setattr(self, f"BasicBlock_{i}", BasicBlock(cin, cout, stride))
            cin = cout

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f0 = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        feats = [f0]
        x = F.max_pool2d(f0, 3, 2, 1)
        for i in range(0, 8, 2):
            x = getattr(self, f"BasicBlock_{i + 1}")(
                getattr(self, f"BasicBlock_{i}")(x))
            feats.append(x)
        return feats
